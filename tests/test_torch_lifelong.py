"""mapper/lifelong.py of the port against the JAX package's.

The overlap metrics and the objective score on seeded scans (the same
NumPy in f64 in both: equal to 1e-12), then the decay end to end: two
laps of the rooms world through each package's streaming session with
the decay after each drained scan (config 3's wiring: the port's
SlamSession(lifelong=...), LifelongMapper.stream_hook set by hand on the
JAX session's pipeline; at test_torch_slam.py's reduced geometry: 0.05 m
grid, 361 beams), with delete-only and with marginalized removal. Every call of
evaluate_node_depreciation is logged as (scan, removed unique ids) in
both packages and compared decision for decision; the survivors' poses
must be within PARITY.md's 4 cm. The JAX session runs the fused loop
verify (SLAM_FUSED_LOOP=1), as the port's streaming session does."""
import dataclasses

import numpy as np
import pytest
import torch

from slam_toolbox_tpu.api import SlamSession as JaxSession
from slam_toolbox_tpu.core.scan import LaserConfig as JaxLaser
from slam_toolbox_tpu.core.scan import LocalizedScan as JaxScan
from slam_toolbox_tpu.io.dataset import LidarSimulator, SegmentWorld
from slam_toolbox_tpu.mapper import lifelong as jl
from slam_toolbox_tpu_torch.api import SlamSession as TorchSession
from slam_toolbox_tpu_torch.core.scan import LocalizedScan as TorchScan
from slam_toolbox_tpu_torch.interop import config_from_dict, laser_from_dict
from slam_toolbox_tpu_torch.mapper import lifelong as tl
from test_torch_slam import LAP, _workload

PKGS = {"jax": jl, "torch": tl}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scan_pairs(seed=1, n=12):
    """Seeded scan pairs in both packages: simulated scans in a box room
    at random poses, and constant-range discs at random offsets (whose
    boxes differ, so reading overlap is not trivially 0 or 1)."""
    laser = JaxLaser(min_range=0.05, max_range=12.0, range_threshold=10.0,
                     angular_resolution=np.deg2rad(1.0))
    tlaser = laser_from_dict(dataclasses.asdict(laser))
    sim = LidarSimulator(SegmentWorld.box(4.0), laser, range_noise=0.01,
                         seed=seed)
    rng = np.random.default_rng(seed)
    pairs = []
    for k in range(n):
        p1 = np.array([*rng.uniform(-1.5, 1.5, 2), rng.uniform(-3, 3)])
        p2 = p1 + rng.normal(0, [0.6, 0.6, 0.3])
        if k % 2:
            r1 = np.full(laser.n_beams, rng.uniform(1.0, 3.0))
            r2 = np.full(laser.n_beams, rng.uniform(1.0, 3.0))
            p2 = p1 + np.array([rng.uniform(0.0, 4.0), 0.0, 0.0])
        else:
            r1, r2 = sim.scan_at(p1), sim.scan_at(p2)
        pairs.append((
            (JaxScan(laser, r1, p1), JaxScan(laser, r2, p2)),
            (TorchScan(tlaser, r1, p1), TorchScan(tlaser, r2, p2)),
        ))
    return pairs


def test_overlap_metrics_match_jax():
    """intersect_bounds, intersect_area, iou, area_overlap_ratio and
    reading_overlap_ratio in both argument orders, on 12 seeded pairs."""
    names = ("intersect_area", "iou", "area_overlap_ratio",
             "reading_overlap_ratio")
    seen = {n: [] for n in names}
    for (ja, jb), (ta, tb) in _scan_pairs():
        for (j1, j2), (t1, t2) in (((ja, jb), (ta, tb)),
                                   ((jb, ja), (tb, ta))):
            np.testing.assert_allclose(tl.intersect_bounds(t1, t2),
                                       jl.intersect_bounds(j1, j2),
                                       rtol=0, atol=1e-12)
            for n in names:
                got = getattr(tl, n)(t1, t2)
                ref = getattr(jl, n)(j1, j2)
                assert abs(got - ref) <= 1e-12, (n, got, ref)
                seen[n].append(got)
    # the pairs cover overlapping and disjoint cases
    for n in names:
        assert max(seen[n]) > 0.0 and min(seen[n]) < max(seen[n]), n
    assert min(seen["iou"]) == 0.0


def test_objective_score_matches_jax():
    """objective_score over seeded inputs spanning the IOU-match rule,
    the constraint boost and the cap at 1."""
    rng = np.random.default_rng(7)
    tcfg, jcfg = tl.LifelongConfig(), jl.LifelongConfig()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    scores = []
    for _ in range(200):
        args = (rng.uniform(0, 1), rng.uniform(0, 1), rng.uniform(0, 1),
                int(rng.integers(0, 8)), rng.uniform(-1, 2),
                int(rng.integers(0, 30)))
        got = tl.objective_score(tcfg, *args)
        assert got == jl.objective_score(jcfg, *args)
        scores.append(got)
    assert -1.0 in scores and 1.0 in scores


def _decay_run(pkg, cfg, laser, data, ll_cfg, monkeypatch):
    """One lifelong streaming session of package `pkg`; returns the decisions (scan unique id,
    removed unique ids), the survivors' poses and the stage counts."""
    mod = PKGS[pkg]
    if pkg == "jax":
        # the fused loop verify, as the port's streaming session runs it
        monkeypatch.setenv("SLAM_FUSED_LOOP", "1")
        sess = JaxSession(cfg, laser, streaming=True, drain_every=16)
        ll = mod.LifelongMapper(
            sess.mapper, mod.LifelongConfig(**dataclasses.asdict(ll_cfg)))
        sess._ensure_pipe().post_finish = ll.stream_hook
    else:
        sess = TorchSession(
            config_from_dict(dataclasses.asdict(cfg)),
            laser_from_dict(dataclasses.asdict(laser)), device="cpu",
            streaming=True, drain_every=16,
            lifelong=mod.LifelongConfig(**dataclasses.asdict(ll_cfg)))
        ll = sess.lifelong
    sess.stats.enabled = True
    log = []
    evaluate = ll.evaluate_node_depreciation

    def logged(scan):
        removed = evaluate(scan)
        log.append((scan.unique_id, list(removed)))
        return removed

    ll.evaluate_node_depreciation = logged
    for i, (scan, _) in enumerate(data):
        sess.process_scan(scan.ranges, scan.odom_pose, time=i * 0.1)
    sess.flush()
    surv = {s.unique_id: np.array(s.corrected_pose)
            for s in sess.mapper.all_processed_scans()}
    return dict(log=log, surv=surv, nodes=sess.mapper.solver.n_nodes,
                scores=dict(sess.mapper.vertex_scores),
                counts=dict(sess.stats.counts))


@pytest.fixture(scope="module", params=[False, True],
                ids=["deleted", "marginalized"])
def decay_runs(request):
    """Both packages over two laps (about 150 scans), the steady-state
    trigger at 12 candidates (tests/test_lifelong_plateau.py's small-world
    setting), removals deleted or marginalized."""
    cfg, laser, data = _workload(0.05, 1.0, LAP * 2 + [LAP[0]], 0.5)
    cfg = dataclasses.replace(cfg, loop_match_minimum_chain_size=6,
                              marginalize_on_removal=request.param)
    ll_cfg = jl.LifelongConfig(steady_state_min_candidates=12)
    with pytest.MonkeyPatch.context() as mp:
        runs = {pkg: _decay_run(pkg, cfg, laser, data, ll_cfg, mp)
                for pkg in PKGS}
    return request.param, runs


def test_decay_decisions_match_jax(decay_runs):
    """Each drained scan's decay removes the same nodes, in the same
    order, in both packages; the graph ends with the same nodes, the
    survivors within 4 cm of the JAX ones, and the same vertex scores to
    1e-6 (a score is the overlap of boxes whose poses differ by the
    packages' micrometre-scale f32 pose differences)."""
    marginalize, runs = decay_runs
    got, ref = runs["torch"], runs["jax"]
    assert got["log"] == ref["log"]
    removed = [u for _, r in got["log"] for u in r]
    assert len(removed) >= 20
    assert got["nodes"] == ref["nodes"] == len(got["surv"])
    assert sorted(got["surv"]) == sorted(ref["surv"])
    assert {0, 1} <= set(got["surv"])   # the protected first two nodes
    gap = max(np.hypot(*(got["surv"][u][:2] - ref["surv"][u][:2]))
              for u in got["surv"])
    assert gap < 0.04, gap
    assert sorted(got["scores"]) == sorted(ref["scores"])
    for u, v in ref["scores"].items():
        assert abs(got["scores"][u] - v) < 1e-6, u


def test_marginal_factor_counts_match_jax(decay_runs):
    """With marginalize_on_removal the removals add composed factors (and
    skip the pairs already linked) as often as in the JAX package; with
    delete-only removal none is added."""
    marginalize, runs = decay_runs
    keys = ("marginal_factor_added", "marginal_factor_dup_skipped")
    got = {k: runs["torch"]["counts"].get(k, 0) for k in keys}
    ref = {k: runs["jax"]["counts"].get(k, 0) for k in keys}
    assert got == ref
    if marginalize:
        assert got["marginal_factor_added"] >= 20
    else:
        assert got["marginal_factor_added"] == 0


def test_stream_hook_reports_running_buffer_edits():
    """stream_hook returns True only when a removal touched the running
    buffer or the last scan (the pipeline resyncs its ring then), here on
    a hand-built map where one decay removes a running scan and another
    removes an old one."""
    from slam_toolbox_tpu_torch.mapper import Mapper

    cfg, laser, data = _workload(0.05, 1.0, LAP[:2], 0.6)
    cfg = config_from_dict(dataclasses.asdict(cfg))
    tlaser = laser_from_dict(dataclasses.asdict(laser))
    m = Mapper(cfg, device="cpu")
    ll = tl.LifelongMapper(m)
    scans = []
    for scan, tp in data[:6]:
        s = TorchScan(tlaser, scan.ranges, scan.odom_pose)
        s.set_corrected_pose(tp)
        assert m.process(s)
        scans.append(s)
    running = m.sensor_manager.get_running_scans(tlaser.name)
    old = [s for s in scans if s not in running]
    ll.evaluate_node_depreciation = lambda scan: [running[0].unique_id]
    assert ll.stream_hook(scans[-1]) is True
    if old:
        ll.evaluate_node_depreciation = lambda scan: [old[0].unique_id]
        assert ll.stream_hook(scans[-1]) is False
    ll.evaluate_node_depreciation = lambda scan: []
    assert ll.stream_hook(scans[-1]) is False
