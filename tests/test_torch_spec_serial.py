"""The port's serial A/B drain (PIPELINED off) and warm() on the CPU. At
loop_attempt_interval_scans 0 the serial drain gives the pipelined poses
bit for bit. Above 0, drain() settles before every serial drain, so the
terminal loop attempt of settle() fires each time (the reference's own
behavior, ADVICE r5): the port must do the same as the JAX session.
warm() runs a batch on a zero state of its own and leaves the
pipeline's state and pack pool as they were."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from slam_toolbox_tpu_torch.api import SlamSession as TorchSession
from slam_toolbox_tpu_torch.interop import config_from_dict, laser_from_dict
from test_torch_spec_session import (  # noqa: F401 (fixtures)
    PACKAGES, _one_thread, loop_data, run_session,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _attempts(pkg, log):
    """Patches logging each loop attempt of package `pkg` as (scan id,
    "cadence" when a drain's bookkeeping made it, else "terminal")."""
    mod, graph_cls = PACKAGES[pkg]
    bookkeep = mod.StreamingPipeline._bookkeep
    begin = graph_cls.try_close_loop_begin
    depth = [0]

    def counting_bookkeep(self, *a, **k):
        depth[0] += 1
        try:
            return bookkeep(self, *a, **k)
        finally:
            depth[0] -= 1

    def logging_begin(self, scan, sensor_name, spec=None):
        log.append((scan.unique_id,
                    "cadence" if depth[0] else "terminal"))
        return begin(self, scan, sensor_name, spec=spec)

    return [(mod.StreamingPipeline, "_bookkeep", counting_bookkeep),
            (graph_cls, "try_close_loop_begin", logging_begin)]


def test_serial_drain_equals_pipelined(loop_data):
    """PIPELINED off against on, loop_attempt_interval_scans 0: the same
    poses bit for bit."""
    serial = run_session("torch", *loop_data, PIPELINED=False)
    piped = run_session("torch", *loop_data)
    np.testing.assert_array_equal(serial["traj"], piped["traj"])
    assert serial["edges"] == piped["edges"]
    assert serial["closures"] == piped["closures"] >= 1
    assert serial["counts"]["spec_chain_hit"] >= 1


def test_serial_drain_with_cadence_matches_jax(loop_data):
    """PIPELINED off with loop_attempt_interval_scans 40 (drains of 16):
    settle() before each serial drain makes a terminal loop attempt every
    drain, in both packages, on the same scans; the same closures, and
    positions within PARITY.md's 4 cm envelope."""
    cfg, laser, data = loop_data
    cfg = dataclasses.replace(cfg, loop_attempt_interval_scans=40)
    logs, runs = {}, {}
    for pkg in PACKAGES:
        logs[pkg] = []
        runs[pkg] = run_session(pkg, cfg, laser, data, PIPELINED=False,
                                patches=_attempts(pkg, logs[pkg]))
    assert logs["torch"] == logs["jax"]
    terminal = [uid for uid, kind in logs["torch"] if kind == "terminal"]
    assert len(terminal) >= len(data) // 16 - 1, logs["torch"]
    assert runs["torch"]["closures"] == runs["jax"]["closures"] >= 1
    assert runs["torch"]["edges"] == runs["jax"]["edges"]
    gap = np.hypot(*(runs["torch"]["traj"][:, :2]
                     - runs["jax"]["traj"][:, :2]).T)
    assert gap.max() < 0.04, gap.max()


def test_warm_leaves_the_pipeline_as_it_was(loop_data):
    """warm() on a pipeline with a batch in flight and scans pending:
    every state tensor, the result ring, the pack pool and the pending
    work are as they were, and the session then ends as a cold one."""
    cfg, laser, data = loop_data
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    tlaser = laser_from_dict(dataclasses.asdict(laser))

    def session():
        return TorchSession(tcfg, tlaser, device="cpu", streaming=True,
                            drain_every=16)

    sess, cold = session(), session()
    for s in (sess, cold):
        for i, (scan, _) in enumerate(data[:40]):
            s.process_scan(scan.ranges, scan.odom_pose, time=i * 0.1)
    pipe = sess._pipe
    assert pipe._pending_drain is not None and pipe.pending
    state = {k: v.clone() if isinstance(v, torch.Tensor) else v
             for k, v in pipe.state.items()}
    tensors = {k: v for k, v in pipe.state.items()}
    pool = (pipe.pack_pool.buf.clone(), pipe.pack_pool.n,
            dict(pipe.pack_pool._owners))
    pending = (list(pipe.pending), pipe._pending_drain,
               pipe._pending_drain.results.clone())

    pipe.warm()

    assert pipe.state.keys() == state.keys()
    for k, v in state.items():
        assert pipe.state[k] is tensors[k]
        if isinstance(v, torch.Tensor):
            assert torch.equal(pipe.state[k], v), k
        else:
            assert pipe.state[k] == v, k
    assert torch.equal(pipe.pack_pool.buf, pool[0])
    assert (pipe.pack_pool.n, pipe.pack_pool._owners) == pool[1:]
    assert pipe.pending == pending[0]
    assert pipe._pending_drain is pending[1]
    assert torch.equal(pipe._pending_drain.results, pending[2])
    for s in (sess, cold):
        for i, (scan, _) in enumerate(data[40:80], start=40):
            s.process_scan(scan.ranges, scan.odom_pose, time=i * 0.1)
    np.testing.assert_array_equal(sess.trajectory, cold.trajectory)


SWITCHES = {"PIPELINED": "SLAM_STREAM_PIPELINE", "SPECULATE": "SLAM_SPEC",
            "SPEC_LOOP": "SLAM_SPEC_LOOP", "ADAPTIVE": "SLAM_ADAPTIVE",
            "EARLY_VERIFY": "SLAM_EARLY_VERIFY"}


@pytest.mark.parametrize("value", ["default", "0"])
def test_switches_read_at_import(value):
    """The reference's switches come from its environment variables when
    the module is imported: on by default, off for "0"."""
    env = {k: v for k, v in os.environ.items() if k not in SWITCHES.values()}
    env.pop("PYTHONPATH", None)
    if value != "default":
        env.update({var: value for var in SWITCHES.values()})
    probe = ("import json, sys; sys.path.insert(0, {!r}); "
             "from slam_toolbox_tpu_torch.mapper import streaming as s; "
             "print(json.dumps([getattr(s, k) for k in {!r}]))").format(
                 REPO, list(SWITCHES))
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.splitlines()[-1]) == [value == "default"] * 5
