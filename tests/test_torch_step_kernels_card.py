"""The scan step's kernels (slam_toolbox_tpu_torch/kernels/step_cuda.py:
ring_points, the window sums' head form score_windows_head, score_tail,
stream_update) against their plain versions on a card, marked `cuda` and
skipped without one: at the bench geometry (G 2051, the drain step's
flags) and the loop geometry (G 561, the fused verify's coarse chain
match), on chip_smoke.py's phase-2 inputs and edge cases. Integer and
elementwise outputs are bit-equal; score_tail's coarse best and tie
count bit-equal, its means within step_cuda.MEAN_ATOL and covariances
within COV_RTOL of their scale (its sums run in another order than
PyTorch's), its fine and angular parts bit-equal at its own means. The
head form equals the plain head then the plain sums bit for bit at the
bench, loop and CLI geometries (G 2051, 561, 2403, 633). Then a drain
step captured as a CUDA graph launches the six kernels once each.
score_tail's streamed and wide modes equal its resident mode bit for bit
at both geometries and hold to the plain version on a 21 x 201 x 201
lattice, at 600 coarse headings on a 3 x 3 lattice, at 65 and 200 fine
headings and at 27,009 and 60,000 beams; stream_update holds to its
plain version on its eviction edge cases up to 20,000 slots; the window
sums (both forms) past their narrow instantiation (70,000 headings, a
2 x 70,000 lattice, a G 46,400 raster), ring_points at 49,153 and
300,000 beams and the smear at hk 900 (and at hk past G) hold to their
plain versions. The file imports no JAX, so the card's machine runs it
with `python -m pytest --noconftest tests/test_torch_step_kernels_card.py`."""
import numpy as np
import pytest
import torch

import chip_smoke as cs
from slam_toolbox_tpu_torch.core.scan import LocalizedScan
from slam_toolbox_tpu_torch.kernels import match_cuda as mc
from slam_toolbox_tpu_torch.mapper import Mapper
from slam_toolbox_tpu_torch.mapper import streaming as ts


@pytest.fixture(scope="module")
def bench():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda")
    cfg, laser, data = cs.bench_workload(n_laps=2)
    mapper = Mapper(cfg, device=dev)
    mapper.initialize(laser.range_threshold)

    def scan_at(i):
        s = LocalizedScan(laser, data[i][0].ranges, data[i][0].odom_pose)
        s.set_corrected_pose(data[i][1])
        return s

    chain, q = cs.loop_chain(data, cfg.loop_search_maximum_distance)
    ring = cfg.scan_buffer_size + 2
    return dict(dev=dev, cfg=cfg, laser=laser, data=data, scan_at=scan_at,
                cases={
                    "seq": (mapper.sequential_matcher, list(range(ring)),
                            ring + 1, (True, True, True)),
                    "loop": (mapper.loop_matcher, chain, q,
                             (False, False, False))})


@pytest.mark.cuda
@pytest.mark.parametrize("tag,G", [("seq", 2051), ("loop", 561)])
def test_step_kernels_match_plain_on_card(bench, tag, G):
    matcher, base, qi, path = bench["cases"][tag]
    assert matcher.G == G
    scan_at, dev = bench["scan_at"], bench["dev"]
    inp = cs.kernel_inputs(matcher, [scan_at(i) for i in base], scan_at(qi),
                           dev)
    grid = matcher._raster(inp["pts"], inp["valid"], inp["off"])
    si = cs.step_inputs(matcher, [scan_at(i) for i in base], scan_at(qi),
                        dev)
    out = cs.check_step_kernels(matcher, si, grid, tag, path, timing=False)
    assert all(out[k]["err"] == 0 for k in
               ("ring_points", "score_windows_head", "stream_update"))
    assert out["score_tail"]["mean_err"] <= 1e-5
    assert all(out[k]["cases_checked"] > 0 for k in cs.STEP_KERNELS)


@pytest.mark.cuda
def test_replayed_step_launches_the_six_kernels(bench):
    """A drain step captured on a pipeline's state: its tally is one launch
    each of ring_points, scatter_occupancy, smear_quantize, score_windows
    (its head form), score_tail and stream_update; a profiler trace of
    its replays shows fewer than 20 device kernels per step; 16 replays
    equal 16 eager steps bit for bit."""
    cfg, laser, data, dev = (bench["cfg"], bench["laser"], bench["data"],
                             bench["dev"])
    mapper = Mapper(cfg, device=dev)
    mapper.initialize(laser.range_threshold)
    pipe = ts.StreamingPipeline(mapper, laser, drain_every=16)
    scans = [bench["scan_at"](i) for i in range(12)]
    sm = mapper.sensor_manager
    for s in scans[:10]:
        sm.add_scan(s)
        sm.add_running_scan(s)
        sm.set_last_scan(s)
    pipe.refresh_state()
    batch = [bench["scan_at"](i) for i in range(12, 28)]
    packs = torch.from_numpy(np.stack([ts.scan_pack(s) for s in batch]))
    odoms = torch.from_numpy(np.stack([s.odom_pose for s in batch]).astype(
        np.float32))
    packs, odoms = packs.to(dev), odoms.to(dev)
    state = pipe.state
    eager = cs.clone_state(state)
    graph = pipe._step_graph(state, 16)
    assert {k for k, _ in graph.tally} == set(cs.STEP_PATH)
    assert len(cs.STEP_PATH) == 6 and "score_head" not in cs.STEP_PATH
    assert all(n == 1 for n in graph.tally.values())
    ts._load_batch(state, packs, odoms)
    per_step, by_name = cs.device_kernels_per_replay(graph.graph, 16)
    assert per_step < 20, by_name
    restored = cs.clone_state(eager)
    for k, v in restored.items():
        if isinstance(v, torch.Tensor):
            state[k].copy_(v)
    mc.reset_launch_counts()
    pipe._run_batch(state, packs, odoms)
    pipe._run_eager(eager, packs, odoms)
    for k, v in state.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, eager[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("penalize,refine", [(False, False), (True, True)])
def test_score_tail_cluster_at_loop_geometry(bench, penalize, refine):
    """K7 at the loop geometry (G 561, 21 x 81 x 81 sums, 1,081 beams) as
    one cluster of score_tail_launch's shape, on the fused verify's flags
    and on align's (penalized and refined): the coarse tie count and best
    bit-equal to the plain version, the means within MEAN_ATOL and the
    covariances within COV_RTOL of their scale, the fine and angular
    parts bit-equal at the kernel's own means; 100 launches give
    bit-identical outputs and aux."""
    from slam_toolbox_tpu_torch.kernels import step_cuda as sc

    matcher, base, qi, _ = bench["cases"]["loop"]
    scan_at, dev = bench["scan_at"], bench["dev"]
    inp = cs.kernel_inputs(matcher, [scan_at(i) for i in base], scan_at(qi),
                           dev)
    grid = matcher._raster(inp["pts"], inp["valid"], inp["off"])
    si = cs.step_inputs(matcher, [scan_at(i) for i in base], scan_at(qi),
                        dev)
    args = cs.score_tail_args(matcher, grid, si["center_off"], si["local"],
                              si["finite"], penalize, refine)
    na, ny, nx = args[0].shape
    naf = args[-2]
    ctas, _, _, mode = sc.score_tail_launch(na, ny, nx,
                                            si["local"].shape[0], naf)
    assert (na, ny, nx) == (21, 81, 81) and ctas > 1
    assert mode == sc.TAIL_RESIDENT
    ak = torch.zeros(sc.aux_len(naf), device=dev)
    ap = torch.zeros_like(ak)
    pk = sc.score_tail(*args, aux=ak)
    pp = sc.score_tail_plain(*args, aux=ap)
    torch.cuda.synchronize()
    assert torch.equal(ak[:2], ap[:2])
    assert float((ak[2:5] - ap[2:5]).abs().max()) <= sc.MEAN_ATOL
    assert float((pk[1:4] - pp[1:4]).abs().max()) <= sc.MEAN_ATOL
    scale = float(pp[[4, 8, 12]].abs().max().clamp_min(1e-6))
    assert float((pk[4:] - pp[4:]).abs().max()) / scale <= sc.COV_RTOL
    if refine:
        kw = matcher._score_args
        pens = (kw["dist_var_penalty"], kw["ang_var_penalty"],
                kw["min_dist_pen"], kw["min_ang_pen"])
        fp = sc.fine_parts_plain(
            grid, matcher.G, si["center_off"], si["local"], si["finite"],
            ak[2:5], ak[7:10], kw["x_off_f"], kw["y_off_f"], kw["scale"],
            kw["fine_angle_offset"], kw["fine_angle_res"], penalize, pens,
            naf)
        ref = ak.clone()
        sc.fill_aux_fine(ref, fp, ak[7:10])
        assert torch.equal(ak, ref)
    for _ in range(100):
        again = torch.zeros_like(ak)
        assert torch.equal(sc.score_tail(*args, aux=again), pk)
        assert torch.equal(again, ak)


@pytest.mark.cuda
@pytest.mark.parametrize("tag", ["seq", "loop"])
@pytest.mark.parametrize("penalize,refine", [(False, False), (False, True),
                                             (True, False), (True, True)])
def test_score_tail_streamed_equals_resident(bench, tag, penalize, refine):
    """K7's streamed mode, forced through the launch geometry, against the
    resident mode score_tail_launch picks at 21 x 26 x 26 and 21 x 81 x
    81: output and aux bit-equal; the card holds at least one cluster of
    either shape."""
    from slam_toolbox_tpu_torch.kernels import step_cuda as sc

    matcher, base, qi, _ = bench["cases"][tag]
    scan_at, dev = bench["scan_at"], bench["dev"]
    inp = cs.kernel_inputs(matcher, [scan_at(i) for i in base], scan_at(qi),
                           dev)
    grid = matcher._raster(inp["pts"], inp["valid"], inp["off"])
    si = cs.step_inputs(matcher, [scan_at(i) for i in base], scan_at(qi),
                        dev)
    args = cs.score_tail_args(matcher, grid, si["center_off"], si["local"],
                              si["finite"], penalize, refine)
    na, ny, nx = args[0].shape
    B, naf = si["local"].shape[0], args[-2]
    resident = sc.score_tail_launch(na, ny, nx, B, naf)
    assert resident[3] == sc.TAIL_RESIDENT and ny == nx == (
        26 if tag == "seq" else 81)
    streamed = resident[:2] + (8 * B, sc.TAIL_STREAMED)
    got = []
    for geom in (resident, streamed):
        assert sc.tail_clusters(geom, dev) >= 1
        aux = torch.zeros(sc.aux_len(naf), device=dev)
        got.append((sc._launch_score_tail(args, aux, geom), aux))
    torch.cuda.synchronize()
    assert torch.equal(got[0][0], got[1][0])
    assert torch.equal(got[0][1], got[1][1])


@pytest.mark.cuda
def test_score_tail_streamed_on_a_201_lattice(bench):
    """bench.py's loop matcher with a 20 m loop search (21 x 201 x 201
    sums, past the resident mode) at 1,081 and 271 beams: the streamed
    K7 held to its plain version (chip_smoke.check_tail_wide: exact parts
    bit-equal, means within MEAN_ATOL, covariances within COV_RTOL)."""
    chain, q = cs.loop_chain(bench["data"],
                             bench["cfg"].loop_search_maximum_distance)
    out = cs.check_tail_wide(bench["cfg"], bench["laser"], bench["data"],
                             bench["dev"], chain, q)
    assert sorted(out) == ["1081", "271"]
    assert all(r["cases_checked"] == 2 for r in out.values())


@pytest.mark.cuda
def test_score_tail_streamed_at_600_headings(bench):
    """bench.py's loop matcher searching +-2.995 rad at 0.01 rad (600
    coarse headings, past kMaxHeadings) on a 3 x 3 lattice, so 7 of the
    cluster's 16 CTAs hold no cell, at 1,081 and 271 beams: the streamed
    K7 held to its plain version as on the 201 x 201 lattice."""
    chain, q = cs.loop_chain(bench["data"],
                             bench["cfg"].loop_search_maximum_distance)
    out = cs.check_tail_wide(bench["cfg"], bench["laser"], bench["data"],
                             bench["dev"], chain, q, "headings")
    assert sorted(out) == ["1081", "271"]
    assert all(r["cases_checked"] == 2 and r["shape"].startswith("na=600 ")
               for r in out.values())


@pytest.mark.cuda
def test_stream_update_edge_cases(bench):
    """K8 against its plain version at K = 12, 25, 100, 4,096, 4,097 and
    20,000 slots (past the former 4,096) with the eviction's leading run
    ending inside the first warp, at the warp boundaries 32 and 64, at K
    and at 0, by count and by distance: every state tensor bit-equal
    (chip_smoke.check_update_edges)."""
    dev = bench["dev"]
    scan = bench["scan_at"](3)
    pack = torch.from_numpy(ts.scan_pack(scan)).to(dev)
    packed = torch.zeros(13, device=dev)
    packed[0], packed[3] = 0.7, 0.1
    packed[4] = packed[8] = packed[12] = 1e-3
    assert cs.UPDATE_SLOTS[-2:] == (4097, 20000)
    assert cs.check_update_edges(dev, pack, packed) == 46


def _inputs(bench, tag):
    """(matcher, step inputs, raster) of chip_smoke's phase 2 at the bench
    ("seq", "loop") or the CLI's ("cli seq", "cli loop") geometry."""
    import os

    dev = bench["dev"]
    if tag.startswith("cli"):
        fixture = os.path.join(os.path.dirname(os.path.abspath(cs.__file__)),
                               "tests", "data", "loop_rooms.clf.gz")
        matcher, base, query = cs.cli_cases(fixture, dev)[
            0 if tag == "cli seq" else 1]
    else:
        matcher, idx, qi, _ = bench["cases"][tag]
        base = [bench["scan_at"](i) for i in idx]
        query = bench["scan_at"](qi)
    inp = cs.kernel_inputs(matcher, base, query, dev)
    grid = matcher._raster(inp["pts"], inp["valid"], inp["off"])
    return matcher, cs.step_inputs(matcher, base, query, dev), grid


@pytest.mark.cuda
@pytest.mark.parametrize("tag,G", [("seq", 2051), ("loop", 561),
                                   ("cli seq", 2403), ("cli loop", 633)])
def test_head_form_equals_plain_chain(bench, tag, G):
    """K1's head form (score_windows_head: the match's headings, tables and
    origin formed in the window kernel) against the plain head then the
    plain sums, at the bench, loop and CLI geometries: the sums and the
    headings bit-equal on the path's local points, their strided pack
    view, a heading at pi, a lattice off the grid and no finite beam
    (chip_smoke.check_step_kernels), and on the path's inputs a launch
    is counted under score_windows and G."""
    from slam_toolbox_tpu_torch.kernels import step_cuda as sc

    matcher, si, grid = _inputs(bench, tag)
    assert matcher.G == G
    seq = tag.endswith("seq")
    out = cs.check_step_kernels(matcher, si, grid, tag, (seq, seq, seq),
                                timing=False)
    assert out["score_windows_head"]["cases_checked"] == 10
    mc.reset_launch_counts()
    args = cs.head_args(matcher, grid, si["center_off"], si["local"],
                        si["finite"])
    raw, ang = sc.score_windows_head(*args)
    raw_p, ang_p = sc.score_windows_head_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(raw, raw_p) and torch.equal(ang, ang_p)
    assert int(raw.max()) > 0
    assert mc.GRID_LAUNCHES[("score_windows", G)] == 1


@pytest.mark.cuda
def test_window_sums_past_the_narrow_limits(bench):
    """K1 in both forms past its narrow instantiation: 70,000 headings
    (past gridDim.y), a 2 x 70,000 lattice (past 16-bit spans) and a
    G 46,400 raster (offsets past int32, 2.15 GB), each bit-equal to its
    plain version (chip_smoke.check_window_limits)."""
    matcher, si, grid = _inputs(bench, "seq")
    out = cs.check_window_limits(grid, matcher.G,
                                 float(matcher._score_args["scale"]), si,
                                 bench["dev"], timing=False)
    assert sorted(out) == ["headings", "lattice", "raster"]
    assert all(r["cases_checked"] == 2 for r in out.values())


@pytest.mark.cuda
def test_score_tail_past_its_streamed_mode(bench):
    """K7's wide mode at 65 and 200 fine headings (past kMaxFine) and at
    27,009 and 60,000 beams (past a CTA's room at 8 bytes a beam) at the
    bench geometry, penalized and refined, held to its plain version
    (chip_smoke.check_tail_limits: exact parts bit-equal, means within
    MEAN_ATOL, covariances within COV_RTOL, a second launch
    bit-identical)."""
    matcher, si, grid = _inputs(bench, "seq")
    out = cs.check_tail_limits(matcher, grid, si, bench["dev"],
                               timing=False)
    assert sorted(out) == ["beams 27009", "beams 60000",
                           "fine headings 200", "fine headings 65"]
    assert all(r["mode"] == "wide" for r in out.values())


@pytest.mark.cuda
def test_ring_points_past_48_kb_of_flags(bench):
    """K5 at 49,153 beams (its flags past 48 KB: the opt-in shared
    memory) and at 300,000 (past a block's shared memory: the scratch
    flags), chain and step mode bit-equal to its plain version
    (chip_smoke.check_ring_limits)."""
    from slam_toolbox_tpu_torch.kernels import step_cuda as sc

    _, si, _ = _inputs(bench, "seq")
    out = cs.check_ring_limits(bench["dev"], si["center_off"][:2],
                               si["offset_pose"], si["half"], 2051,
                               timing=False)
    assert out["49153"]["flags"] == "shared (opt-in)"
    assert out["300000"]["flags"] == "scratch"
    assert sc.ring_scratch_bytes(3, 49153) == 0
    assert sc.ring_scratch_bytes(3, 300000) == 3 * 300000


@pytest.mark.cuda
@pytest.mark.parametrize("G,hk", [(2051, 900), (257, 300)])
def test_smear_past_its_shared_memory(bench, G, hk):
    """K2 and K3 on the adversarial occupancy patterns (chip_smoke.
    check_patterns) at hk 900, where a block's row values pass its shared
    memory (the scratch instantiation), and at hk 300 on a 257 grid (taps
    past the grid, clamped to G - 1): bit-equal to the plain versions."""
    from slam_toolbox_tpu_torch.kernels import rasterize as rz

    w = torch.from_numpy(rz.smear_weights(hk / 2.0, hk)).to(bench["dev"])
    assert (mc.smear_scratch_bytes(G, hk) > 0) == (hk == 900)
    assert cs.check_patterns(G, hk, w, bench["dev"])[0] == 7
