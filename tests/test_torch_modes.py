"""The session's modes in the port against the JAX package on the CPU,
following tests/test_modes.py and tests/test_queue_modes.py.

A short mapping run of the rooms world (test_modes.py's, at a 0.05 m
correlation grid) is written by the JAX package; both packages then load
that snapshot and run the same scans: elastic localization from
LOCALIZE_AT_POSE, classic and streaming (the same buffer unique ids and
node counts as the JAX session, trajectories within PARITY.md's 4 cm),
the runtime mapping<->localization switch, set_initial_pose,
clear_localization_buffer, modify_node and manual_loop_closure (from the
same loaded graph: poses equal to 1e-6 m, both solve in f64 on the host),
then the pause and interactive domains and the sync/async queues. A JAX
streaming session runs the fused loop verify (SLAM_FUSED_LOOP=1), as the
port's streaming sessions do, so closures land at the same drains."""
import contextlib
import dataclasses
import threading
import warnings

import numpy as np
import pytest
import torch

from slam_toolbox_tpu.api import MatchType as JaxMatchType
from slam_toolbox_tpu.api import SlamSession as JaxSession
from slam_toolbox_tpu.api import queue_modes as jq
from slam_toolbox_tpu.api.slam import PausedApplication as JaxPaused
from slam_toolbox_tpu.io.dataset import LidarSimulator, SegmentWorld
from slam_toolbox_tpu_torch.api import MatchType, SlamSession
from slam_toolbox_tpu_torch.api import queue_modes as tq
from slam_toolbox_tpu_torch.api.slam import PausedApplication, ProcessType
from slam_toolbox_tpu_torch.interop import config_from_dict, laser_from_dict
from test_pipeline import sim_config

WORLD = SegmentWorld.rooms(16.0, 10.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(**kw):
    laser, cfg = sim_config()
    return laser, cfg.replace(correlation_search_space_resolution=0.05, **kw)


def _session(pkg, cfg, laser, **kw):
    if pkg == "jax":
        return JaxSession(cfg, laser, **kw)
    return SlamSession(config_from_dict(dataclasses.asdict(cfg)),
                       laser_from_dict(dataclasses.asdict(laser)),
                       device="cpu", **kw)


@contextlib.contextmanager
def _fused(pkg, streaming):
    """The JAX package's fused loop verify for a streaming session (read
    at each loop event, so it stays set for the session's run)."""
    with pytest.MonkeyPatch.context() as mp:
        if pkg == "jax" and streaming:
            mp.setenv("SLAM_FUSED_LOOP", "1")
        yield


def _match(pkg):
    return JaxMatchType if pkg == "jax" else MatchType


def _sim(laser, seed, waypoints):
    sim = LidarSimulator(WORLD, laser, range_noise=0.01,
                         odom_noise=(0.01, 0.004), seed=seed)
    return sim.simulate(np.array(waypoints), step=0.45)


def _feed(sess, data, t0=0.0):
    """(online poses of the accepted scans, their ground truth)."""
    poses, gts = [], []
    for i, (scan, tp) in enumerate(data):
        out = sess.process_scan(scan.ranges, scan.odom_pose,
                                time=t0 + i * 0.1)
        if out is not None:
            poses.append(np.array(out[0]))
            gts.append(tp)
    return poses, gts


@pytest.fixture(scope="module")
def prior(tmp_path_factory):
    """test_modes.mapped_session through the JAX package, serialized."""
    laser, cfg = _config()
    data = _sim(laser, 11, [(-6.0, -3.5), (1.5, -3.5), (5.5, -3.5),
                            (5.5, 1.0)])
    sess = JaxSession(cfg, laser)
    _feed(sess, data)
    path = str(tmp_path_factory.mktemp("modes") / "prior.npz")
    sess.serialize(path)
    return path, data


def _localize(pkg, prior, streaming):
    with _fused(pkg, streaming):
        return _localize_run(pkg, prior, streaming)


def _localize_run(pkg, prior, streaming):
    path, data = prior
    laser, cfg = _config(scan_buffer_size=5)
    sess = _session(pkg, cfg, laser, mode="localization",
                    streaming=streaming, drain_every=4)
    sess.deserialize(path, _match(pkg).LOCALIZE_AT_POSE,
                     initial_pose=data[0][0].odom_pose)
    n_prior = sess.mapper.solver.n_nodes
    new = _sim(laser, 23, [(-6.0, -3.5), (0.0, -3.5), (3.0, -3.5)])
    poses, gts = _feed(sess, new)
    sess.flush()
    return dict(sess=sess, n_prior=n_prior, poses=np.stack(poses),
                gts=np.stack(gts), nodes=sess.mapper.solver.n_nodes,
                buffer=sorted(sess.localization_buffer_uids()),
                traj=sess.trajectory, cfg=cfg)


@pytest.fixture(scope="module", params=[False, True],
                ids=["classic", "streaming"])
def localized(request, prior):
    return request.param, {pkg: _localize(pkg, prior, request.param)
                           for pkg in ("jax", "torch")}


def test_localize_at_pose_matches_jax(localized):
    """LOCALIZE_AT_POSE then 15+ scans: the same accepted scans, buffer
    unique ids and node count as the JAX session (the graph bounded by
    prior + buffer), online poses and the final trajectory within 4 cm;
    the session turned to localization and stays there."""
    streaming, runs = localized
    got, ref = runs["torch"], runs["jax"]
    assert got["n_prior"] == ref["n_prior"]
    assert got["buffer"] == ref["buffer"] and len(got["buffer"]) == 5
    assert got["nodes"] == ref["nodes"] <= got["n_prior"] + 5
    assert len(got["poses"]) == len(ref["poses"]) > 6
    assert np.max(np.hypot(*(got["poses"][:, :2]
                             - ref["poses"][:, :2]).T)) < 0.04
    assert got["traj"].shape == ref["traj"].shape
    assert np.max(np.hypot(*(got["traj"][:, :2]
                             - ref["traj"][:, :2]).T)) < 0.04
    sess = got["sess"]
    assert sess.mode == "localization"
    assert sess.processor_type == ProcessType.PROCESS_LOCALIZATION
    assert (sess._pipe is not None) == streaming
    if streaming:
        assert sess._pipe.post_finish == sess._loc_post_finish


def test_streaming_localization_matches_classic(prior):
    """test_modes.test_localization_streaming_matches_classic in the port:
    both routes bound the graph by the same buffer, and the streaming
    route's survivors localize within the prior map (median error below
    0.5 m against ground truth, the classic route's online median below
    0.3 m)."""
    classic = _localize("torch", prior, False)
    stream = _localize("torch", prior, True)
    assert classic["nodes"] == stream["nodes"]
    assert len(classic["poses"]) == len(stream["poses"])
    err = np.hypot(*(classic["poses"][:, :2] - classic["gts"][:, :2]).T)
    assert np.median(err) < 0.3
    new = _sim(_config()[0], 23, [(-6.0, -3.5), (0.0, -3.5), (3.0, -3.5)])
    sess = stream["sess"]
    errs = [np.hypot(*(s.corrected_pose[:2] - new[int(round(s.time * 10))]
                       [1][:2]))
            for s in sess.mapper.all_processed_scans()[stream["n_prior"]:]]
    assert errs and np.median(errs) < 0.5


def _toggled(pkg, streaming):
    with _fused(pkg, streaming):
        return _toggled_run(pkg, streaming)


def _toggled_run(pkg, streaming):
    laser, cfg = _config(scan_buffer_size=4)
    sess = _session(pkg, cfg, laser, streaming=streaming, drain_every=4)
    d = _sim(laser, 41, [(-6.0, -3.5), (0.0, -3.5), (3.0, -3.5)])
    half = len(d) // 2
    _feed(sess, d[:half])
    sess.flush()
    counts = [sess.mapper.solver.n_nodes]
    sess.toggle_mode("localization")
    _feed(sess, d[half:], t0=half * 0.1)
    sess.flush()
    counts.append(sess.mapper.solver.n_nodes)
    buffer = sorted(sess.localization_buffer_uids())
    sess.toggle_mode("mapping")
    d2 = _sim(laser, 43, [(3.0, -3.5), (5.0, -3.5)])
    _feed(sess, d2, t0=len(d) * 0.1)
    sess.flush()
    counts.append(sess.mapper.solver.n_nodes)
    return dict(sess=sess, counts=counts, buffer=buffer,
                traj=sess.trajectory, cfg=cfg)


@pytest.mark.parametrize("streaming", [False, True],
                         ids=["classic", "streaming"])
def test_toggle_mode_matches_jax(streaming):
    """test_modes.test_toggle_mode_runtime in both packages: localization
    bounds growth to the buffer, returning to mapping keeps the buffered
    nodes and grows the graph again; node counts and buffers equal to the
    JAX session's, trajectories within 4 cm."""
    got, ref = (_toggled(pkg, streaming) for pkg in ("torch", "jax"))
    assert got["counts"] == ref["counts"]
    assert got["buffer"] == ref["buffer"] and got["buffer"]
    n_map, n_loc, n_end = got["counts"]
    assert n_loc <= n_map + got["cfg"].scan_buffer_size
    assert n_end > n_loc
    sess = got["sess"]
    assert sess.mode == "mapping" and not sess.localization_buffer_uids()
    assert sess.processor_type == ProcessType.PROCESS
    if streaming:
        assert sess._pipe.post_finish is None
    assert got["traj"].shape == ref["traj"].shape
    assert np.max(np.hypot(*(got["traj"][:, :2]
                             - ref["traj"][:, :2]).T)) < 0.04
    with pytest.raises(ValueError):
        sess.toggle_mode("surveying")


def test_set_initial_pose_and_clear_buffer_match_jax(prior):
    """After a localization run, set_initial_pose at a pose 0.2 m off the
    next scan's true pose relocalizes that scan against the nodes near it
    (the same pose as the JAX session's, within 4 cm of it and 0.1 m of
    the truth); clear_localization_buffer then removes every buffered
    node in both."""
    path, data = prior
    out = {}
    for pkg in ("jax", "torch"):
        run = _localize(pkg, prior, False)
        sess = run["sess"]
        laser = sess.laser
        later = _sim(_config()[0], 47, [(1.5, -3.4), (2.5, -3.4)])
        scan, truth = later[0]
        sess.set_initial_pose(truth + np.array([0.15, -0.13, 0.02]))
        assert sess.processor_type.name == "PROCESS_NEAR_REGION"
        pose, _ = sess.process_scan(scan.ranges, scan.odom_pose, time=50.0)
        n_before = sess.mapper.solver.n_nodes
        buffered = len(sess.localization_buffer_uids())
        sess.clear_localization_buffer()
        out[pkg] = dict(pose=np.array(pose), truth=truth,
                        removed=n_before - sess.mapper.solver.n_nodes,
                        buffered=buffered, laser=laser,
                        left=sess.localization_buffer_uids())
    got, ref = out["torch"], out["jax"]
    assert np.hypot(*(got["pose"][:2] - ref["pose"][:2])) < 0.04
    assert np.hypot(*(got["pose"][:2] - got["truth"][:2])) < 0.1
    assert got["buffered"] == ref["buffered"] == 5
    assert got["removed"] == ref["removed"] == 5
    assert got["left"] == ref["left"] == set()


@pytest.fixture(scope="module")
def loaded_pair(prior):
    """The prior loaded (UNSET) into a session of each package."""
    path, _ = prior
    laser, cfg = _config()
    out = {}
    for pkg in ("jax", "torch"):
        sess = _session(pkg, cfg, laser)
        sess.deserialize(path)
        out[pkg] = sess
    return out


def test_manual_loop_closure_matches_jax(loaded_pair):
    """loop_closure_assistant's manual closure on the same loaded graph:
    one node moved 0.5 m (the pose's third entry is a yaw increment, as
    in the reference's ModifyNode), then the solve writes back. The move
    adds no constraint, so the solve pulls the node back onto its edges;
    every pose equal to the JAX session's to 1e-6 m."""
    before = loaded_pair["torch"].trajectory.copy()
    uid = len(before) // 2
    target = [before[uid][0] + 0.5, before[uid][1], 0.0]
    moved_in_solver = []
    for sess in loaded_pair.values():
        sess.modify_node(uid, target)
        moved_in_solver.append(np.hypot(*(
            sess.mapper.solver.get_node_pose(uid)[:2] - before[uid][:2])))
        sess.manual_loop_closure([(uid, target)])
    assert np.allclose(moved_in_solver, 0.5)
    got = loaded_pair["torch"].trajectory
    ref = loaded_pair["jax"].trajectory
    assert np.max(np.hypot(*(got[:, :2] - ref[:, :2]).T)) < 1e-6
    assert np.max(np.abs(got[:, 2] - ref[:, 2])) < 1e-6
    assert np.hypot(*(got[uid][:2] - before[uid][:2])) < 0.01


def test_modify_node_matches_jax(loaded_pair):
    """modify_node moves the solver's node only, adding the given yaw to
    the stored one (ceres_solver.cpp:451-461); the scans keep their poses
    until the next solve, as in the JAX package."""
    uid = 3
    traj0 = loaded_pair["torch"].trajectory.copy()
    poses = []
    for sess in loaded_pair.values():
        yaw0 = sess.mapper.solver.get_node_pose(uid)[2]
        sess.modify_node(uid, [0.25, -0.5, 0.3])
        poses.append(np.array(sess.mapper.solver.get_node_pose(uid)))
        np.testing.assert_allclose(poses[-1], [0.25, -0.5, yaw0 + 0.3],
                                   rtol=0, atol=1e-12)
    np.testing.assert_allclose(poses[0], poses[1], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(loaded_pair["torch"].trajectory, traj0)


def _small_session(pkg):
    from slam_toolbox_tpu.core.params import MapperConfig
    from slam_toolbox_tpu.core.scan import LaserConfig

    laser = LaserConfig(beam_count=31, min_angle=-1.0, max_angle=1.0,
                        min_range=0.05, max_range=10.0,
                        range_threshold=8.0, is_360=False)
    cfg = MapperConfig(use_scan_matching=False, minimum_travel_distance=0.0,
                       minimum_time_interval=0.0)
    return _session(pkg, cfg, laser)


def _pause_trace(pkg):
    """test_queue_modes.test_session_pause_domains_are_independent as a
    trace of observations, for either package."""
    paused = JaxPaused if pkg == "jax" else PausedApplication
    sess = _small_session(pkg)
    r = np.full(31, 4.0)
    t = [sess.process_scan(r, [0.0, 0.0, 0.0], time=0) is not None,
         sess.pause(),
         sess.process_scan(r, [0.5, 0.0, 0.0], time=1) is None,
         sess.pause(),
         sess.process_scan(r, [1.0, 0.0, 0.0], time=2) is not None,
         sess.get_graph() is not None]
    sess.paused_state.set(paused.VISUALIZING_GRAPH, True)
    t.append(sess.get_graph() is None)
    sess.paused_state.set(paused.VISUALIZING_GRAPH, False)
    t.append(sess.toggle_interactive_mode())
    t += [sess.is_paused(a) for a in paused] + [sess.interactive_mode]
    t.append(sess.toggle_interactive_mode())
    t += [sess.is_paused(a) for a in paused]
    sess.pause_processing(True)
    t += [sess.is_paused(a) for a in paused]
    return t


def test_pause_and_interactive_domains_match_jax():
    """NEW_MEASUREMENTS drops scans at the gate, VISUALIZING_GRAPH hides
    the graph, interactive mode pauses PROCESSING and VISUALIZING_GRAPH
    together, pause_processing only PROCESSING: the same observations as
    the JAX session's."""
    got = _pause_trace("torch")
    assert got == _pause_trace("jax")
    assert got[:8] == [True, True, True, False, True, True, True, True]


class _Recorder:
    """Records process_scan calls; optionally blocks inside one."""

    def __init__(self, gate=None):
        self.processed = []
        self.gate = gate

    def process_scan(self, ranges, odom_pose, t):
        self.processed.append(t)
        if self.gate is not None:
            self.gate.wait(5.0)
        return np.zeros(3), np.eye(3)


@pytest.mark.parametrize("mod", [jq, tq], ids=["jax", "torch"])
def test_sync_queue_orders_warns_and_clears(mod):
    """SyncQueue: in-order pump, max_items, the backlog warning and
    clear; the port's behaves as the JAX one (both run here)."""
    s = _Recorder()
    q = mod.SyncQueue(s, backlog_warn=3)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        for i in range(6):
            q.add_scan(np.full(3, i), np.zeros(3), t=i)
    assert sum("backlog" in str(x.message) for x in w) == 3
    assert q.pump(max_items=2) == 2 and s.processed == [0, 1]
    assert q.pump() == 4 and s.processed == [0, 1, 2, 3, 4, 5]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i in range(4):
            q.add_scan(np.zeros(3), np.zeros(3), t=10 + i)
    assert q.clear() == 4 and q.pump() == 0


def test_sync_queue_honors_the_processing_pause():
    """SyncQueue.pump on a port session: while PROCESSING is paused
    (pause_processing, or interactive mode) the consumer idles and scans
    keep queueing; afterwards they are processed in order, as the JAX
    queue does on the JAX session."""
    counts = {}
    for pkg, mod in (("jax", jq), ("torch", tq)):
        sess = _small_session(pkg)
        q = mod.SyncQueue(sess, backlog_warn=100)
        sess.pause_processing(True)
        for i in range(4):
            q.add_scan(np.full(31, 4.0), [0.3 * i, 0.0, 0.0], t=float(i))
        idle = q.pump()
        sess.pause_processing(False)
        sess.toggle_interactive_mode()
        idle += q.pump()
        sess.toggle_interactive_mode()
        n = q.pump()
        traj = sess.trajectory
        counts[pkg] = (idle, len(q.queue), n, len(traj),
                       [round(float(p[0]), 9) for p in traj])
    assert counts["torch"] == counts["jax"]
    assert counts["torch"][:4] == (0, 0, 4, 4)


@pytest.mark.parametrize("mod", [jq, tq], ids=["jax", "torch"])
def test_async_policy_drops_while_busy(mod):
    """AsyncPolicy processes a scan when free and drops the ones that
    arrive while a scan is in flight."""
    gate = threading.Event()
    s = _Recorder(gate)
    a = mod.AsyncPolicy(s)
    worker = threading.Thread(
        target=a.add_scan, args=(np.zeros(3), np.zeros(3), 0.0))
    worker.start()
    while not s.processed:
        pass
    assert a.add_scan(np.zeros(3), np.zeros(3), 1.0) is None
    assert a.add_scan(np.zeros(3), np.zeros(3), 2.0) is None
    gate.set()
    worker.join()
    assert a.dropped == 2 and s.processed == [0.0]
    assert a.add_scan(np.zeros(3), np.zeros(3), 3.0) is not None
    assert s.processed == [0.0, 3.0] and a.dropped == 2


def test_async_policy_on_a_port_session():
    """AsyncPolicy in front of a port session processes scans in turn and
    returns the session's pose, as the JAX policy on the JAX session."""
    out = {}
    for pkg, mod in (("jax", jq), ("torch", tq)):
        a = mod.AsyncPolicy(_small_session(pkg))
        poses = [a.add_scan(np.full(31, 4.0), [0.3 * i, 0.1 * i, 0.0],
                            float(i)) for i in range(3)]
        out[pkg] = (a.dropped, [np.asarray(p[0]) for p in poses])
    assert out["torch"][0] == out["jax"][0] == 0
    for g, r in zip(out["torch"][1], out["jax"][1]):
        np.testing.assert_allclose(g, r, atol=1e-9)
