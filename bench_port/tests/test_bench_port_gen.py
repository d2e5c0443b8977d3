"""The benchmark's frozen copies against the originals they were taken
from, at small cuts on the CPU."""
import types

import numpy as np
import pytest

from bench_port.gen import merge_graph, roofline, sim, trace, worlds


def _laser(beam_deg):
    return sim.Laser(min_range=0.05, max_range=12.0, range_threshold=10.0,
                     angular_resolution=float(np.deg2rad(beam_deg)))


def _same_bag(bag, data):
    assert len(bag) == len(data)
    assert np.array_equal(bag.ranges, np.stack([s.ranges for s, _ in data]),
                          equal_nan=True)
    assert np.array_equal(bag.odom, np.stack([s.odom_pose for s, _ in data]))
    assert np.array_equal(bag.truth, np.stack([tp for _, tp in data]))


def test_apartment_bag_equals_workloads_torch():
    import workloads_torch as wl

    _, _, data = wl.apartment_workload(laps=1, beam_deg=1.0)
    spec = {"kind": "rooms", "width": 16.0, "height": 10.0}
    bag = sim.simulate(worlds.world(spec), _laser(1.0),
                       worlds.route({"kind": "apartment_lap", "laps": 1},
                                    spec), 0.3, 0.01, (0.015, 0.006), seed=7)
    _same_bag(bag, data)


def test_warehouse_bag_equals_workloads_torch():
    import workloads_torch as wl

    _, data = wl.warehouse_workload(laps=1, beam_deg=1.0)
    spec = {"kind": "warehouse", "aisles": 4, "length": 30.0, "pitch": 4.0}
    bag = sim.simulate(worlds.world(spec), _laser(1.0),
                       worlds.route({"kind": "serpentine"}, spec), 0.3, 0.01,
                       (0.012, 0.005), seed=11)
    _same_bag(bag, data)


def test_data_kinds_equal_the_built_ones():
    """A world and a route given whole as data in a mix (the kinds
    `segments` and `waypoints`) make the same bag as the kinds that build
    them."""
    spec = {"kind": "warehouse", "aisles": 2, "length": 10.0, "pitch": 4.0}
    w = worlds.world(spec)
    wps = worlds.route({"kind": "serpentine"}, spec)
    data_w = worlds.world({"kind": "segments",
                           "segments": w.segments.tolist()})
    data_r = worlds.route({"kind": "waypoints", "points": wps.tolist()}, {})
    a = sim.simulate(w, _laser(1.0), wps, 0.3, 0.01, (0.012, 0.005), 5)
    b = sim.simulate(data_w, _laser(1.0), data_r, 0.3, 0.01,
                     (0.012, 0.005), 5)
    _same_bag(a, [(types.SimpleNamespace(ranges=r, odom_pose=o), t)
                  for r, o, t in zip(b.ranges, b.odom, b.truth)])


def test_torch_cast_equals_numpy_cast():
    spec = {"kind": "warehouse", "aisles": 2, "length": 10.0, "pitch": 4.0}
    args = (worlds.world(spec), _laser(1.0),
            worlds.route({"kind": "serpentine"}, spec), 0.3, 0.01,
            (0.012, 0.005), 5)
    a = sim.simulate(*args)
    b = sim.simulate(*args, device="cpu")
    assert np.array_equal(np.isnan(a.ranges), np.isnan(b.ranges))
    ok = ~np.isnan(a.ranges)
    assert np.abs(a.ranges[ok] - b.ranges[ok]).max() < 1e-9
    assert np.array_equal(a.odom, b.odom)


def test_joint_graph_equals_workloads_torch():
    import workloads_torch as wl

    sessions, nodes = 8, 2500
    rng = np.random.default_rng(7)
    subs = merge_graph.corrected_poses(sessions, nodes, rng)
    merger = types.SimpleNamespace(submaps=[
        [types.SimpleNamespace(corrected_pose=p) for p in s] for s in subs])
    ref = wl.joint_graph(merger, rng)
    got = merge_graph.joint_graph(sessions, nodes, seed=7)
    for k in ("n", "n_pad", "n_chain", "n_cross"):
        assert got[k] == ref[k], k
    for k in ("src", "dst", "emask", "free", "poses", "sqrt_info"):
        assert np.array_equal(got[k], ref[k]), k
    assert np.abs(got["rel"] - ref["rel"]).max() < 1e-12
    assert ref["n_cross"] == 14


def test_merge_constants_equal_workloads_torch():
    import workloads_torch as wl

    assert merge_graph.PER_AISLE == wl.MERGE_PER_AISLE
    assert merge_graph.NODE_NOISE == wl.MERGE_NODE_NOISE
    assert merge_graph.CHAIN_NOISE == wl.MERGE_CHAIN_NOISE
    assert merge_graph.CROSS_NOISE == wl.MERGE_CROSS_NOISE
    assert merge_graph.CROSS_EVERY == wl.MERGE_CROSS_EVERY
    assert merge_graph.COV_ODOM == wl.MERGE_COV_ODOM
    assert merge_graph.COV_CROSS == wl.MERGE_COV_CROSS
    assert merge_graph.origins(8, 62500) == wl.merge_origins(8, 62500)
    for i in (0, 199, 200, 62499):
        assert np.array_equal(merge_graph.true_poses(i + 1, 4.0)[i],
                              wl.merge_pose(i, 4.0))


def test_roofline_bound_equals_chip_smoke():
    import chip_smoke

    assert roofline.MEM_BYTES_PER_S == chip_smoke.MEM_BYTES_PER_S
    assert roofline.SCALAR_OPS_PER_S == chip_smoke.SCALAR_OPS_PER_S
    for nbytes, ops in ((1e6, 1e3), (1e3, 1e9), (4.2e5, 1.5e7)):
        assert roofline.bound(nbytes, ops) == chip_smoke.bound(nbytes, ops)


def test_match_geometry_equals_the_matchers():
    import json
    import os

    from slam_toolbox_tpu_torch.kernels.match import Matcher

    cfg = json.load(open(os.path.join(
        os.path.dirname(__file__), "..", "configs", "apartment.json")))
    m, rt = cfg["mapper"], cfg["laser"]["range_threshold"]
    geoms = roofline.mapper_geometries(m, rt)
    assert sorted(geoms) == [561, 2051]
    for dim, res in ((m["correlation_search_space_dimension"],
                      m["correlation_search_space_resolution"]),
                     (m["loop_search_space_dimension"],
                      m["loop_search_space_resolution"])):
        mt = Matcher(dim, res, 0.1, rt, m["coarse_search_angle_offset"],
                     m["coarse_angle_resolution"],
                     m["fine_search_angle_offset"], 0.5, 1.0, 0.5, 0.9,
                     device="cpu")
        g = geoms[mt.G]
        assert (g["n"], g["na"], g["naf"]) == (
            len(mt._xy_coarse), mt._na_coarse, mt._na_fine)


def test_score_windows_counts_are_chip_smokes_with_every_beam():
    """K1's count is check_step_kernels' with every gather in the grid
    and no raster cell counted: at the main path's geometry (G 2051,
    21 headings, 26 x 26 offsets) and 1,081 beams."""
    g = roofline.match_geometry(0.5, 0.01, 10.0, 0.3490658503988659,
                                0.03490658503988659, 0.003490658503988659)
    na, n, B = g["na"], g["n"], 1081
    assert (g["G"], na, n, g["naf"]) == (2051, 21, 26, 11)
    cells, gathers = 0, na * B * n * n
    smoke_bytes = cells + 20 + 8 * n + 8 * n + B * 9 + na * n * n * 4 + na * 4
    smoke_ops = gathers + 12 * na * B
    assert roofline.score_windows_head(g, B) == (smoke_bytes, smoke_ops)
    fine_cells = 0
    assert roofline.score_tail(g, B) == (
        4 * na * n * n + fine_cells + B * 9 + 20 + 52 + 4 * 6,
        10 * na * n * n)


def test_joint_solve_least_time():
    # 1,024 blocks of 1,536 x 1,536: 1.237e12 flops a step, the factors'
    # lower triangles 4.83 GB a CG iteration
    t = roofline.joint_solve_least_s(524288, 500006, 512, 3, 97)
    chol = 1024 * 1536 ** 3 / 3 / 67e12
    tri = 1024 * 1536 * 1537 / 2 * 4 / 3.35e12
    assert 3 * chol + 97 * tri < t < 3 * chol + 97 * tri + 0.01
    assert 0.19 < t < 0.21


def test_union_and_idle_by_span():
    iv = [("a", 0.0, 1.0), ("b", 0.5, 2.0), ("c", 3.0, 4.0)]
    assert trace.union_s(iv) == pytest.approx(3.0)
    assert trace.gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    spans = [("drain call", 1.5, 2.5), ("scan call", 4.5, 4.8)]
    got = dict(trace.idle_by_span(iv, spans, 0.0, 5.0))
    assert got["drain call"] == pytest.approx(0.5)
    assert got["scan call"] == pytest.approx(0.3)
    assert got["between spans"] == pytest.approx(1.2)
    assert trace.named_seconds(iv, ("a", "c")) == pytest.approx(2.0)
