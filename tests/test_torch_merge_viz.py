"""Multi-session merge (api/merge.py) and the visualization helpers
(api/viz.py) of the port against the JAX package on the CPU: auto_align's
correction and response, the merged map bit for bit on both occupancy
routes, the graph markers and the rendered map."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from slam_toolbox_tpu.api import SlamSession as JaxSession
from slam_toolbox_tpu.api import viz as jviz
from slam_toolbox_tpu.api.merge import MapMerger as JaxMerger
from slam_toolbox_tpu.core.scan import LocalizedScan as JaxScan
from slam_toolbox_tpu_torch.api import SlamSession, viz
from slam_toolbox_tpu_torch.api.merge import MapMerger
from slam_toolbox_tpu_torch.api.slam import PausedApplication
from slam_toolbox_tpu_torch.core.scan import LocalizedScan
from slam_toolbox_tpu_torch.interop import config_from_dict, laser_from_dict
from slam_toolbox_tpu_torch.kernels import occupancy as occ
from test_torch_slam import LAP, _workload

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def halves():
    """Two overlapping halves of a simulated run at their true poses, as
    JAX scans and as the port's."""
    cfg, laser, data = _workload(0.05, 1.0, LAP[:5], 0.6)
    tlaser = laser_from_dict(dataclasses.asdict(laser))

    def scans(cls, las, part):
        out = []
        for i, (s, tp) in enumerate(part):
            x = cls(las, s.ranges, s.odom_pose, time=i * 0.1)
            x.set_corrected_pose(tp)
            x.state_id = x.unique_id = i
            out.append(x)
        return out

    k = len(data) // 2
    parts = (data[:k + 6], data[k:])
    return dict(cfg=cfg, laser=laser,
                jax=[scans(JaxScan, laser, p) for p in parts],
                port=[scans(LocalizedScan, tlaser, p) for p in parts])


def _mergers(halves, correction):
    jm, tm = JaxMerger(), MapMerger(device="cpu")
    for m, key in ((jm, "jax"), (tm, "port")):
        for scans in halves[key]:
            m.add_scans(scans)
        m.set_correction(1, correction)
    return jm, tm


@pytest.mark.parametrize("correction,guess", [
    ((0.3, -0.2, np.deg2rad(3.0)), None),
    ((-0.5, 0.4, np.deg2rad(-6.0)), None),
    ((0.0, 0.0, 0.0), "shifted"),
])
def test_auto_align_matches_jax(halves, correction, guess):
    jm, tm = _mergers(halves, correction)
    kw = {}
    if guess == "shifted":
        kw["initial_guess"] = halves["port"][1][0].corrected_pose + [
            0.25, 0.1, 0.02]
    ref = jm.auto_align(0, 1, **kw)
    got = tm.auto_align(0, 1, **kw)
    assert ref is not None and got is not None
    assert abs(got - ref) < 1e-5
    np.testing.assert_allclose(tm.corrections[1][:2], jm.corrections[1][:2],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tm.corrections[1][2], jm.corrections[1][2],
                               atol=1e-5, rtol=0)
    # the halves sit at their true poses, so the right correction is 0
    assert np.hypot(*tm.corrections[1][:2]) < 0.1
    assert abs(tm.corrections[1][2]) < np.deg2rad(1.0)


def test_auto_align_below_min_response_keeps_correction(halves):
    jm, tm = _mergers(halves, (0.3, -0.2, 0.05))
    assert jm.auto_align(0, 1, min_response=1.01) is None
    assert tm.auto_align(0, 1, min_response=1.01) is None
    np.testing.assert_array_equal(tm.corrections[1], [0.3, -0.2, 0.05])


@pytest.mark.parametrize("native", [True, False], ids=["native", "tensor"])
def test_merge_matches_jax(halves, monkeypatch, native):
    monkeypatch.setattr(occ, "create_from_scans", functools.partial(
        occ.create_from_scans, native=native))
    jm, tm = _mergers(halves, (4.0, -1.5, np.deg2rad(20.0)))
    ref, got = jm.merge(resolution=0.1), tm.merge(resolution=0.1)
    np.testing.assert_array_equal(got.cells, np.asarray(ref.cells))
    np.testing.assert_array_equal(got.pass_cnt, np.asarray(ref.pass_cnt))
    np.testing.assert_array_equal(got.hit_cnt, np.asarray(ref.hit_cnt))
    np.testing.assert_array_equal(got.offset, ref.offset)
    ms = tm.merged_scans()
    assert len(ms) == sum(len(s) for s in halves["port"])
    np.testing.assert_allclose(
        np.stack([s.corrected_pose for s in ms]),
        np.stack([s.corrected_pose for s in jm.merged_scans()]), atol=0)


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """A JAX session's snapshot loaded into a session of each package."""
    cfg, laser, data = _workload(0.05, 1.0, LAP[:6], 0.6)
    src = JaxSession(cfg, laser)
    for i, (scan, _) in enumerate(data):
        src.process_scan(scan.ranges, scan.odom_pose, time=i * 0.1)
    path = str(tmp_path_factory.mktemp("viz") / "src.npz")
    src.serialize(path)
    jsess = JaxSession(cfg, laser)
    tsess = SlamSession(config_from_dict(dataclasses.asdict(cfg)),
                        laser_from_dict(dataclasses.asdict(laser)),
                        device="cpu")
    jsess.deserialize(path)
    tsess.deserialize(path)
    return jsess, tsess, path


def test_markers_match_jax(sessions):
    jsess, tsess, _ = sessions
    ref = jviz.graph_to_markers(jsess, interactive=True)
    got = viz.graph_to_markers(tsess, interactive=True)
    assert len(got) == len(ref) > 5
    for a, b in zip(got, ref):
        assert set(a) == set(b) == {"id", "x", "y", "scale", "interactive",
                                    "localization"}
        assert (a["id"], a["scale"], a["interactive"], a["localization"]) \
            == (b["id"], b["scale"], b["interactive"], b["localization"])
        assert abs(a["x"] - b["x"]) < 1e-6 and abs(a["y"] - b["y"]) < 1e-6
    tsess.paused_state.set(PausedApplication.VISUALIZING_GRAPH, True)
    try:
        assert viz.graph_to_markers(tsess) == []
    finally:
        tsess.paused_state.set(PausedApplication.VISUALIZING_GRAPH, False)
    assert tsess.localization_buffer_uids() == set()


@pytest.mark.parametrize("with_trajectory", [True, False])
def test_render_map_matches_jax(sessions, tmp_path, with_trajectory):
    jsess, tsess, _ = sessions
    ref = jviz.render_map(jsess, with_trajectory=with_trajectory)
    out = str(tmp_path / "map.ppm")
    got = viz.render_map(tsess, path=out, with_trajectory=with_trajectory)
    assert got.dtype == np.uint8 and got.ndim == 3 and got.shape[2] == 3
    np.testing.assert_array_equal(got, ref)
    with open(out, "rb") as f:
        assert f.readline().strip() == b"P6"
        w, h = (int(v) for v in f.readline().split())
        f.readline()
        assert len(f.read()) == h * w * 3 and (h, w) == got.shape[:2]
    # the overlay drew nodes (red)
    assert np.any(np.all(got == np.array([220, 60, 60], np.uint8), axis=-1))


def test_merge_of_snapshots_matches_jax(sessions):
    """add_submap from the same snapshot twice, the second shifted."""
    _, _, path = sessions
    jm, tm = JaxMerger(), MapMerger(device="cpu")
    for m in (jm, tm):
        m.add_submap(path)
        m.add_submap(path)
        m.set_correction(1, (20.0, 0.0, 0.0))
    ref, got = jm.merge(), tm.merge()
    np.testing.assert_array_equal(got.cells, np.asarray(ref.cells))
    np.testing.assert_array_equal(got.pass_cnt, np.asarray(ref.pass_cnt))


def test_merger_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        MapMerger()
