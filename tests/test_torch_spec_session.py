"""The speculative near-chain and loop-verify dispatch of the port's
streaming pipeline (slam_toolbox_tpu_torch/mapper/streaming.py) end to
end on the CPU: the chains it predicts are the JAX package's, and a
session gives the same poses bit for bit with speculation on and off,
also when every loop prediction is forced to miss. Two laps of the rooms
world (tests/test_spec_adaptive.py's lap, bench.py's settings at the
reduced geometry of test_torch_streaming.py: 0.05 m grid, 361 beams),
drains of 16 scans; the JAX side runs the fused loop verify
(SLAM_FUSED_LOOP=1), as test_streaming_session_matches_jax does."""
import dataclasses

import numpy as np
import pytest
import torch

from slam_toolbox_tpu.api import SlamSession as JaxSession
from slam_toolbox_tpu.graph.pose_graph import PoseGraph as JaxGraph
from slam_toolbox_tpu.mapper import streaming as js
from slam_toolbox_tpu_torch.api import SlamSession as TorchSession
from slam_toolbox_tpu_torch.graph.pose_graph import PoseGraph as TorchGraph
from slam_toolbox_tpu_torch.interop import config_from_dict, laser_from_dict
from slam_toolbox_tpu_torch.mapper import streaming as ts
from test_torch_slam import LAP, _workload

WAYPOINTS = LAP * 2 + [LAP[0], (-3.0, -3.5)]
PACKAGES = {"jax": (js, JaxGraph), "torch": (ts, TorchGraph)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def loop_data():
    """(cfg, laser, data): two laps, 151 scans, loop closures on the
    revisits."""
    return _workload(0.05, 1.0, WAYPOINTS, 0.55)


def run_session(pkg, cfg, laser, data, drain_every=16, patches=(),
                **switches):
    """One streaming session of package `pkg` ("jax" or "torch") over
    `data`, with the streaming module's `switches` set and `patches`
    ((owner, name, value) triples) applied for the run. Returns the
    corrected poses, the closures, the edge count and the stage counts."""
    mod, _ = PACKAGES[pkg]
    mp = pytest.MonkeyPatch()
    try:
        for name, value in switches.items():
            mp.setattr(mod, name, value)
        for owner, name, value in patches:
            mp.setattr(owner, name, value)
        if pkg == "jax":
            mp.setenv("SLAM_FUSED_LOOP", "1")
            sess = JaxSession(cfg, laser, streaming=True,
                              drain_every=drain_every)
        else:
            sess = TorchSession(
                config_from_dict(dataclasses.asdict(cfg)),
                laser_from_dict(dataclasses.asdict(laser)), device="cpu",
                streaming=True, drain_every=drain_every)
        sess.stats.enabled = True
        closures = []
        sess.mapper.listeners.append(closures.append)
        for i, (scan, _) in enumerate(data):
            sess.process_scan(scan.ranges, scan.odom_pose, time=i * 0.1)
        traj = sess.trajectory
    finally:
        mp.undo()
    return dict(traj=traj, closures=len(closures),
                edges=len(sess.mapper.graph.edges),
                counts=dict(sess.stats.counts))


def assert_identical(a, b):
    """Bit-identical corrected poses and the same graph, with a loop
    closed (otherwise the comparison says nothing about loop work)."""
    np.testing.assert_array_equal(a["traj"], b["traj"])
    assert a["edges"] == b["edges"]
    assert a["closures"] == b["closures"] >= 1


def _ids(chains):
    return None if chains is None else [
        tuple(s.unique_id for s in c) for c in chains]


def _recording(graph_cls, log):
    """predict_near_chains / predict_loop_chains of `graph_cls` wrapped to
    log (method, pending scans' ids, anchor id, predicted ids)."""
    near = graph_cls.predict_near_chains
    loop = graph_cls.predict_loop_chains

    def pred_near(self, pending, anchor):
        out = near(self, pending, anchor)
        log.append(("near", [s.unique_id for s in pending], anchor.unique_id,
                    [_ids(c) for c in out]))
        return out

    def pred_loop(self, pending, anchor, sensor_name, pred_chains=None):
        out = loop(self, pending, anchor, sensor_name,
                   pred_chains=pred_chains)
        log.append(("loop", [s.unique_id for s in pending], anchor.unique_id,
                    _ids(out)))
        return out

    return [(graph_cls, "predict_near_chains", pred_near),
            (graph_cls, "predict_loop_chains", pred_loop)]


LOOP_SPEC = dict(SPEC_LOOP=True, EARLY_VERIFY=False)


@pytest.fixture(scope="module")
def predictions(loop_data):
    """Both packages' predictions over the same session, with the loop
    verify's speculation on (it needs the early-verify ordering off)."""
    logs = {}
    runs = {}
    for pkg, (_, graph_cls) in PACKAGES.items():
        logs[pkg] = []
        runs[pkg] = run_session(pkg, *loop_data,
                                patches=_recording(graph_cls, logs[pkg]),
                                **LOOP_SPEC)
    return logs, runs


@pytest.fixture(scope="module")
def loop_spec_off(loop_data):
    return run_session("torch", *loop_data, SPEC_LOOP=False,
                       EARLY_VERIFY=False)


def test_predicted_chains_match_jax(predictions):
    """predict_near_chains and predict_loop_chains of the port give the
    JAX package's chains, by unique ids, for the same pending batches and
    anchors; some predictions are non-empty, so the comparison bites."""
    logs, runs = predictions
    assert logs["torch"] == logs["jax"]
    assert any(kind == "near" and any(c for c in pred)
               for kind, _, _, pred in logs["torch"])
    assert any(kind == "loop" and pred for kind, _, _, pred in logs["torch"])
    assert runs["torch"]["closures"] == runs["jax"]["closures"] >= 1
    gap = np.hypot(*(runs["torch"]["traj"][:, :2]
                     - runs["jax"]["traj"][:, :2]).T)
    assert gap.max() < 0.04, gap.max()


def test_near_chain_speculation_is_bit_identical(loop_data):
    """SPECULATE on (the default) against off: the same poses bit for
    bit, with speculative rows used (spec_chain_hit > 0) and none
    launched with it off."""
    on = run_session("torch", *loop_data)
    off = run_session("torch", *loop_data, SPECULATE=False)
    assert on["counts"]["spec_chain_hit"] >= 1
    assert on["counts"]["spec_pairs"] >= on["counts"]["spec_chain_hit"]
    assert "spec_pairs" not in off["counts"]
    assert_identical(on, off)


def test_near_chain_forced_miss_redispatches(loop_data):
    """Predictions reversed chain by chain cannot validate: every
    speculative near-chain row is dropped, the commit matches those chains
    itself, and the poses stay those of SPECULATE off."""
    orig = TorchGraph.predict_near_chains

    def reversed_chains(self, pending, anchor):
        return [c if not c else [ch[::-1] for ch in c]
                for c in orig(self, pending, anchor)]

    miss = run_session("torch", *loop_data, patches=[
        (TorchGraph, "predict_near_chains", reversed_chains)])
    off = run_session("torch", *loop_data, SPECULATE=False)
    assert miss["counts"]["spec_chain_miss"] >= 1
    assert "spec_chain_hit" not in miss["counts"]
    assert_identical(miss, off)


def test_loop_speculation_is_bit_identical(predictions, loop_spec_off):
    """With EARLY_VERIFY off, SPEC_LOOP on against off: the same poses bit
    for bit, and speculative verify rows were used (spec_loop_hit or
    spec_loop_partial > 0)."""
    on = predictions[1]["torch"]
    counts = on["counts"]
    assert counts["spec_loop_dispatched"] >= 1
    assert counts.get("spec_loop_hit", 0) + counts.get(
        "spec_loop_partial", 0) >= 1
    assert "spec_loop_dispatched" not in loop_spec_off["counts"]
    assert_identical(on, loop_spec_off)


def test_loop_forced_miss_redispatches(loop_data, loop_spec_off):
    """Every predicted loop chain corrupted (multi-scan chains reversed,
    single scans dropped), as tests/test_spec_adaptive.py does: no
    speculative row validates, the commit launches the verify itself, and
    the poses stay those of SPEC_LOOP off."""
    orig = TorchGraph.predict_loop_chains

    def perturbed(self, pending, anchor, sensor_name, pred_chains=None):
        out = orig(self, pending, anchor, sensor_name,
                   pred_chains=pred_chains)
        if out:
            out = [c[::-1] if len(c) > 1 else c[:0] for c in out]
            out = [c for c in out if c] or None
        return out

    miss = run_session("torch", *loop_data, patches=[
        (TorchGraph, "predict_loop_chains", perturbed)], **LOOP_SPEC)
    counts = miss["counts"]
    assert counts["spec_loop_dispatched"] >= 1
    assert counts.get("spec_loop_miss", 0) + counts.get(
        "spec_loop_partial", 0) >= 1
    assert "spec_loop_hit" not in counts
    assert_identical(miss, loop_spec_off)
