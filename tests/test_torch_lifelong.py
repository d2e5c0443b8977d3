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
verify (SLAM_FUSED_LOOP=1), as the port's streaming session does.

The port's decay computes its geometry in batches (overlap_rows, the
native reading-overlap and box passes over its store of packed points):
those are held to their NumPy twin and to the scalar metrics bit for
bit, and a third session whose decay takes each candidate's geometry
from the scalar functions, one call per candidate, makes the same
decisions, scores and anchors."""
import dataclasses

import numpy as np
import pytest
import torch

from slam_toolbox_tpu.api import SlamSession as JaxSession
from slam_toolbox_tpu.core.scan import LaserConfig as JaxLaser
from slam_toolbox_tpu.core.scan import LocalizedScan as JaxScan
from slam_toolbox_tpu.io.dataset import LidarSimulator, SegmentWorld
from slam_toolbox_tpu.mapper import lifelong as jl
from slam_toolbox_tpu_torch import native
from slam_toolbox_tpu_torch.api import SlamSession as TorchSession
from slam_toolbox_tpu_torch.core.scan import LocalizedScan as TorchScan
from slam_toolbox_tpu_torch.interop import config_from_dict, laser_from_dict
from slam_toolbox_tpu_torch.mapper import lifelong as tl
from slam_toolbox_tpu_torch.utils.metrics import Stats
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


def _per_candidate(ll):
    """Give the port's LifelongMapper `ll` the per-candidate geometry:
    one scalar call per candidate and metric, each box from the scan's
    own property (the reference of the batched pass)."""
    def overlaps(scan, scans, stats):
        bounds = np.array([tl.intersect_bounds(scan, c) for c in scans],
                          np.float64).reshape(-1, 4)
        return (bounds, np.array([tl.iou(scan, c) for c in scans]),
                np.array([tl.area_overlap_ratio(scan, c) for c in scans]))

    ll._overlaps = overlaps
    ll._reading_overlaps = lambda ref, scans, bounds, stats: [
        tl.reading_overlap_ratio(ref, c) for c in scans]
    ll._box_rows = lambda scans, stats: tl.box_rows(scans)


def _decay_run(pkg, cfg, laser, data, ll_cfg, monkeypatch):
    """One lifelong streaming session of package `pkg` ("scalar": the
    port with _per_candidate's geometry); returns the decisions (scan
    unique id, removed unique ids), the survivors' poses, the scores, the
    anchors and the stage counts."""
    mod = PKGS[pkg.replace("scalar", "torch")]
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
        if pkg == "scalar":
            _per_candidate(ll)
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
                anchors={u: np.array(v) for u, v in getattr(
                    ll, "anchors", {}).items()},
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
                for pkg in (*PKGS, "scalar")}
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


def test_batched_decay_decides_as_the_per_candidate_one(decay_runs):
    """The decay with its batched geometry removes the same nodes in the
    same order as with one scalar call per candidate, and ends with the
    same scores and anchors; only the batched run packs points and runs
    the passes."""
    _, runs = decay_runs
    got, ref = runs["torch"], runs["scalar"]
    assert got["log"] == ref["log"]
    assert sum(len(r) for _, r in got["log"]) >= 20
    assert sorted(got["scores"]) == sorted(ref["scores"])
    for u, v in ref["scores"].items():
        assert abs(got["scores"][u] - v) <= 1e-12 * max(1.0, abs(v)), u
    assert sorted(got["anchors"]) == sorted(ref["anchors"])
    for u, v in ref["anchors"].items():
        np.testing.assert_array_equal(got["anchors"][u], v)
    for k in ("decay_batch_rows", "decay_overlap_rows",
              "decay_points_packed"):
        assert got["counts"].get(k, 0) > 0, k
        assert ref["counts"].get(k, 0) == 0, k


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


def _torch_scans(seed=1):
    """The port's scans of _scan_pairs, and one whose every reading lies
    past the range threshold (no filtered points: its box is its sensor
    position)."""
    scans = [s for _, (a, b) in _scan_pairs(seed) for s in (a, b)]
    far = np.full(scans[0].laser.n_beams, 11.0)
    scans.append(TorchScan(scans[0].laser, far, np.array([0.5, -0.2, 0.7])))
    assert not scans[-1].filtered_mask.any()
    for uid, s in enumerate(scans):
        s.unique_id = uid
    return scans


def test_overlap_rows_equal_the_scalar_metrics():
    """overlap_rows of each scan against all the others: every bound, IOU
    and area overlap equal to the scalar function's, bit for bit."""
    scans = _torch_scans()
    rows = tl.box_rows(scans)
    seen = []
    for a in scans:
        bounds, iou_, area_ov = tl.overlap_rows(tl.box_rows([a]), rows)
        for k, b in enumerate(scans):
            assert tuple(bounds[k]) == tuple(tl.intersect_bounds(a, b))
            assert iou_[k] == tl.iou(a, b)
            assert area_ov[k] == tl.area_overlap_ratio(a, b)
            seen.append(iou_[k])
    assert min(seen) == 0.0 and 0.0 < np.median(seen) < 1.0


def _reading_case(seed):
    """Candidates for the reading-overlap pass: point sets stored out of
    order with gaps (some empty), sensor poses, boxes (some inverted),
    and for some candidates a bound placed exactly on one of their
    points' world coordinates."""
    rng = np.random.default_rng(seed)
    n = 40
    count = rng.integers(0, 50, n)
    count[::7] = 0
    order = rng.permutation(n)
    start = np.empty(n, np.int64)
    at = 3
    for i in order:
        start[i] = at
        at += count[i] + int(rng.integers(0, 4))
    points = rng.normal(0.0, 3.0, (at + 2, 2))
    head = rng.uniform(-np.pi, np.pi, n)
    pose = np.stack([rng.uniform(-5, 5, n), rng.uniform(-5, 5, n),
                     np.cos(head), np.sin(head)], axis=1)
    lo = rng.uniform(-6.0, 2.0, (n, 2))
    hi = lo + rng.uniform(-1.0, 8.0, (n, 2))
    bounds = np.stack([lo[:, 0], hi[:, 0], lo[:, 1], hi[:, 1]], axis=1)
    edged = 0
    for i in range(0, n, 3):
        if count[i] == 0:
            continue
        # a box around the first point, one of its sides through it
        lx, ly = points[start[i]]
        x, y, c, s = pose[i]
        wx, wy = x + c * lx - s * ly, y + s * lx + c * ly
        bounds[i] = (wx - 1.0, wx + 1.0, wy - 1.0, wy + 1.0)
        col = int(rng.integers(0, 4))
        bounds[i, col] = wx if col < 2 else wy
        edged += 1
    assert edged >= 5
    return start, count, points, pose, bounds


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_reading_overlap_equals_its_twin(seed):
    """native.decay_reading_overlap and _np_decay_reading_overlap count
    the same points on random cases, with points exactly on an edge
    (excluded: the bounds are strict) and candidates with none."""
    if native.get_lib() is None:
        pytest.skip("the native library did not build")
    args = _reading_case(seed)
    got = native.decay_reading_overlap(*args)
    ref = tl._np_decay_reading_overlap(*args)
    assert got.dtype == ref.dtype == np.int64
    np.testing.assert_array_equal(got, ref)
    assert (got[args[1] == 0] == 0).all() and got.max() > 0
    # widened by one ulp, the bounds take in the points on their edges
    start, count, points, pose, bounds = args
    wide = bounds.copy()
    wide[:, 0::2] = np.nextafter(wide[:, 0::2], -np.inf)
    wide[:, 1::2] = np.nextafter(wide[:, 1::2], np.inf)
    more = native.decay_reading_overlap(start, count, points, pose, wide)
    np.testing.assert_array_equal(
        more, tl._np_decay_reading_overlap(start, count, points, pose,
                                           wide))
    assert (more >= got).all() and (more > got).any()


def test_reading_overlap_pass_equals_the_scalar_ratio():
    """The points store, the sensor rows and the pass (native and twin)
    give each pair reading_overlap_ratio's ratio, in both orders."""
    scans = _torch_scans()
    store, stats = tl._PointStore(), Stats()
    pairs = [(a, b) for a in scans[::3] for b in scans if b is not a]
    start, count = store.locate([b for _, b in pairs], stats)
    bounds = np.array([tl.intersect_bounds(a, b) for a, b in pairs])
    pose = tl._sensor_rows([b for _, b in pairs])
    inside = [tl._np_decay_reading_overlap(start, count, store.points,
                                           pose, bounds)]
    if native.get_lib() is not None:
        inside.append(native.decay_reading_overlap(
            start, count, store.points, pose, bounds))
    ref = [tl.reading_overlap_ratio(a, b) for a, b in pairs]
    for got in inside:
        ratio = [float(g) / float(c) if c else 0.0
                 for g, c in zip(got, count)]
        assert ratio == ref
    assert stats.counts["decay_points_packed"] == len(scans)
    assert 0.0 in ref and 0.0 < max(ref) < 1.0 + 1e-12


def test_native_boxes_equal_the_bounding_box():
    """native.decay_boxes from the store's points equals each scan's
    bounding_box bit for bit, at its first pose and after a move."""
    if native.get_lib() is None:
        pytest.skip("the native library did not build")
    scans = _torch_scans(seed=3)
    store = tl._PointStore()
    start, count = store.locate(scans, Stats())
    rng = np.random.default_rng(3)
    for _ in range(2):
        got = native.decay_boxes(start, count, store.points,
                                 tl._sensor_rows(scans))
        np.testing.assert_array_equal(
            got, np.array([s.bounding_box for s in scans]))
        for s in scans:
            s.set_corrected_pose(s.corrected_pose
                                 + rng.normal(0, [0.5, 0.5, 0.4]))


def test_the_points_store_reclaims_removed_rows():
    """Nodes dropped from the store past the live rows are reclaimed at
    the next pack; every live node's rows stay its filtered points."""
    laser = laser_from_dict(dataclasses.asdict(JaxLaser(
        min_range=0.05, max_range=12.0, range_threshold=10.0,
        angular_resolution=np.deg2rad(1.0))))
    rng = np.random.default_rng(5)
    scans = []
    for uid in range(420):
        s = TorchScan(laser, rng.uniform(0.5, 11.0, laser.n_beams),
                      rng.normal(0, 1, 3))
        s.unique_id = uid
        scans.append(s)
    store, stats = tl._PointStore(), Stats()
    store.locate(scans[:400], stats)
    grown = store.size
    for s in scans[:300]:
        store.drop(s.unique_id)
    assert store.dead > store.size - store.dead
    live = scans[300:]
    start, count = store.locate(live, stats)
    assert store.size < grown and store.dead == 0
    assert stats.counts["decay_points_packed"] == 420
    for s, a, c in zip(live, start, count):
        np.testing.assert_array_equal(
            store.points[a:a + c], s.local_points[s.filtered_mask])
    # a new scan under a packed node's id takes its own rows
    other = TorchScan(laser, rng.uniform(0.5, 11.0, laser.n_beams),
                      np.zeros(3))
    other.unique_id = live[0].unique_id
    (a,), (c,) = store.locate([other], stats)
    np.testing.assert_array_equal(store.points[a:a + c],
                                  other.local_points[other.filtered_mask])
    assert len(store.rows) == len(live)


def test_without_the_native_library_the_twin_and_the_property_serve(
        monkeypatch):
    """The decay's passes where the native library is absent: the
    reading overlaps from the NumPy twin and the boxes from the scans'
    own property, equal to the native passes' bit for bit."""
    if native.get_lib() is None:
        pytest.skip("the native library did not build")

    def passes(scans, ref):
        for s in scans:
            s.set_corrected_pose(s.corrected_pose + 0.01)
        ll, stats = tl.LifelongMapper(None), Stats()
        rows = ll._box_rows(scans, stats)
        bounds, _, _ = tl.overlap_rows(tl.box_rows([ref]), rows)
        return rows, ll._reading_overlaps(ref, scans, bounds, stats), stats

    scans = _torch_scans(seed=4)
    ref = scans[0]
    got = passes(scans[1:], ref)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    scans = _torch_scans(seed=4)
    plain = passes(scans[1:], scans[0])
    for a, b in zip(got[0], plain[0]):
        np.testing.assert_array_equal(a, b)
    assert got[1] == plain[1] and max(got[1]) > 0.0
    assert got[2].counts["decay_box_refresh"] == len(scans) - 1
    assert "decay_box_refresh" not in plain[2].counts
    assert got[2].counts["decay_overlap_rows"] == len(scans) - 1
