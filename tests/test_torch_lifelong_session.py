"""A lifelong SlamSession of the port (SlamSession(lifelong=...)) on the
CPU, at a cut of config 3's deployment: the warehouse of
workloads_torch with 2 aisles 20 m long, 6 laps of its serpentine, 271
beams, a 0.05 m correlation grid, removals marginalized, the top-up at
12 candidates (the small world's setting of test_torch_lifelong.py).

Every decay evaluation of a streaming and of a classic session is held
to the plain reference bench_port/ref/decay.py, recomputed from a
snapshot of the graph taken just before it: the same candidates,
removals, scored ids and anchors, and each score within 1e-9 (relative
where a score passes 1 in size, ref/decay.compare). The
session's route makes the same removals and node curve, bit for bit, as
a session whose pipeline has LifelongMapper.stream_hook set by hand (the
wiring the session replaced); toggling to localization and back keeps
the decay."""
import dataclasses

import numpy as np
import pytest
import torch

import workloads_torch as wl
from bench_port.ref import decay
from bench_port.runners.lifelong import decisions, snapshot
from slam_toolbox_tpu_torch.api import SlamSession
from slam_toolbox_tpu_torch.io.dataset import LidarSimulator
from slam_toolbox_tpu_torch.mapper.lifelong import (
    LifelongConfig, LifelongMapper,
)

LL = LifelongConfig(steady_state_min_candidates=12)
CURVE_EVERY = 50          # raw scans between node-curve points


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cut():
    """(mapper config, laser, scans) of the cut."""
    laser = wl.suite_laser(4.0 / 3.0)
    assert laser.n_beams == 271
    world, aisles, length, pitch = wl.warehouse(aisles=2, length=20.0)
    sim = LidarSimulator(world, laser, range_noise=0.01,
                         odom_noise=(0.012, 0.005), seed=11)
    data = sim.simulate(
        np.concatenate([wl.serpentine(aisles, length, pitch)] * 6),
        step=0.3)
    cfg = wl.lifelong_cfg(True, correlation_search_space_resolution=0.05)
    return cfg, laser, data


def _run(cut, streaming=True, by_hand=False, snapshots=False):
    """One session over the cut: each evaluation's (scan, removed ids),
    the node curve, and with `snapshots` (snapshot, the program's
    decisions) of every evaluation and the raw index of each accepted
    scan."""
    cfg, laser, data = cut
    if by_hand:
        sess = SlamSession(cfg, laser, streaming=True, drain_every=96,
                           device="cpu")
        ll = LifelongMapper(sess.mapper, LL)
        sess._ensure_pipe().post_finish = ll.stream_hook
    else:
        sess = SlamSession(cfg, laser, streaming=streaming, drain_every=96,
                           device="cpu", lifelong=LL)
        ll = sess.lifelong
    sess.stats.enabled = True
    log, snaps, curve, accepted = [], [], [], []
    evaluate = ll.evaluate_node_depreciation

    def watched(scan):
        snap = snapshot(sess, scan) if snapshots else None
        removed = evaluate(scan)
        log.append((scan.unique_id, list(removed)))
        if snap is not None:
            snaps.append((snap, decisions(sess, snap, removed)))
        return removed

    ll.evaluate_node_depreciation = watched
    for i, (scan, _) in enumerate(data):
        if sess.process_scan(scan.ranges, scan.odom_pose,
                             time=i * 0.1) is not None:
            accepted.append(i)
        if i % CURVE_EVERY == 0:
            curve.append((i, sess.mapper.solver.n_nodes))
    sess.flush()
    curve.append((len(data), sess.mapper.solver.n_nodes))
    survivors = {s.unique_id for s in sess.mapper.all_processed_scans()}
    return dict(log=log, snaps=snaps, curve=curve, accepted=accepted,
                survivors=survivors, counts=dict(sess.stats.counts))


@pytest.fixture(scope="module")
def streaming_run(cut):
    return _run(cut, snapshots=True)


@pytest.fixture(scope="module")
def classic_run(cut):
    return _run(cut, streaming=False, snapshots=True)


def _held_to_reference(cut, run):
    cfg, laser, data = cut
    ranges = np.stack([s.ranges for s, _ in data])
    raw = np.asarray(run["accepted"])
    lifelong = dataclasses.asdict(LL)
    assert run["snaps"] and len(run["snaps"]) == len(run["log"])
    worst = 0.0
    for snap, prog in run["snaps"]:
        snap = dict(snap, ranges=ranges[raw[snap["uid"]]])
        ref = decay.evaluate(snap, laser, lifelong, cfg.scan_buffer_size,
                             cfg.loop_match_minimum_chain_size,
                             cfg.marginalize_on_removal)
        differ, gap = decay.compare(prog, ref)
        assert differ == 0, (snap["scan"], prog["removed"], ref["removed"])
        worst = max(worst, gap)
    assert worst <= 1e-9, worst
    # the cut works every part: removals by score and by the top-up,
    # marginalized, and anchors
    c = run["counts"]
    assert c["decay_evals"] == len(run["log"]) == len(run["accepted"])
    assert c["decay_removed"] == sum(len(r) for _, r in run["log"]) >= 100
    assert c["decay_forced"] >= 20
    assert c["marginal_factor_added"] >= 20
    assert run["snaps"][-1][1]["anchors"]


def test_streaming_decay_matches_the_reference(cut, streaming_run):
    _held_to_reference(cut, streaming_run)


def test_classic_decay_matches_the_reference(cut, classic_run):
    _held_to_reference(cut, classic_run)


@pytest.mark.parametrize("route", ["streaming", "classic"])
def test_survivors_are_the_accepted_scans_not_removed(streaming_run,
                                                      classic_run, route):
    run = streaming_run if route == "streaming" else classic_run
    removed = [u for _, r in run["log"] for u in r]
    assert len(set(removed)) == len(removed)
    assert run["survivors"] == set(range(len(run["accepted"]))) - set(
        removed)
    assert [u for u, _ in run["log"]] == list(range(len(run["accepted"])))


def test_the_session_route_decides_as_the_hand_set_hook(cut, streaming_run):
    """The same removals, scan by scan, and the same node curve, as a
    session whose pipeline has the decay's hook set by hand."""
    by_hand = _run(cut, by_hand=True)
    assert streaming_run["log"] == by_hand["log"]
    assert streaming_run["curve"] == by_hand["curve"]


def test_toggling_to_localization_and_back_keeps_the_decay(cut):
    cfg, laser, data = cut
    sess = SlamSession(cfg, laser, streaming=True, drain_every=32,
                       device="cpu", lifelong=LL)
    sess.stats.enabled = True
    counts = sess.stats.counts

    def feed(lo, hi):
        for i in range(lo, hi):
            scan = data[i][0]
            sess.process_scan(scan.ranges, scan.odom_pose, time=i * 0.1)
        sess.flush()

    feed(0, 120)
    hook = sess._pipe.post_finish
    assert hook == sess.lifelong.stream_hook
    n0 = counts["decay_evals"]
    assert n0 > 0
    sess.toggle_mode("localization")
    assert sess._pipe.post_finish == sess._loc_post_finish
    feed(120, 160)
    assert counts["decay_evals"] == n0
    sess.toggle_mode("mapping")
    assert sess._pipe.post_finish == sess.lifelong.stream_hook
    feed(160, 260)
    assert counts["decay_evals"] > n0
    ll = sess.lifelong
    sess.close()
    assert sess.lifelong is not ll and not sess.lifelong.anchors
    assert not sess.mapper.vertex_scores
