"""The streaming pipeline's round-5 gates in the port against the JAX
session on the CPU, on the two-lap data of test_torch_spec_session.py:

- the staleness-gated resync (RESYNC_EPS, _flag_resync, _ring_staleness):
  after bookkeeping moves host poses, the device ring is rebuilt only
  when a ring-mirrored scan moved beyond RESYNC_EPS;
- the loop_attempt_interval_scans cadence: loop closure is attempted on
  the batch's newest scan once that many scans have drained;
- settle()'s terminal attempt: with a cadence above 0, the newest scan
  gets one more attempt when scans drained since the last one.

The port's default cadence is 0, so these tests set it. Each decision is
logged in both packages and compared one for one."""
import dataclasses

import numpy as np
import pytest

from test_torch_spec_session import (  # noqa: F401 (fixtures)
    PACKAGES, _one_thread, loop_data, run_session,
)
from test_torch_spec_serial import _attempts


def _resyncs(pkg, log):
    """Patches logging every resync decision of package `pkg` that follows
    a pose move or a closure: (staleness in m, resync flagged)."""
    mod, _ = PACKAGES[pkg]
    flag = mod.StreamingPipeline._flag_resync

    def logging_flag(self, *args):
        # (..., moved_uids, any_closed, buffer_changed) in both packages
        moved, closed = args[-3], args[-2]
        out = flag(self, *args)
        if moved or closed:
            log.append((self._ring_staleness(), self._needs_resync))
        return out

    return [(mod.StreamingPipeline, "_flag_resync", logging_flag)]


def _both(cfg, laser, data, patcher, **switches):
    logs, runs = {}, {}
    for pkg in PACKAGES:
        logs[pkg] = []
        runs[pkg] = run_session(pkg, cfg, laser, data,
                                patches=patcher(pkg, logs[pkg]), **switches)
    assert runs["torch"]["closures"] == runs["jax"]["closures"] >= 1
    assert runs["torch"]["edges"] == runs["jax"]["edges"]
    gap = np.hypot(*(runs["torch"]["traj"][:, :2]
                     - runs["jax"]["traj"][:, :2]).T)
    assert gap.max() < 0.04, gap.max()
    return logs, runs


@pytest.fixture(scope="module")
def resync_runs(loop_data):
    """Both packages' resync decisions at a RESYNC_EPS (None: the
    default), each run once."""
    cache = {}

    def runs(eps):
        if eps not in cache:
            switches = {} if eps is None else {"RESYNC_EPS": eps}
            cache[eps] = _both(*loop_data, _resyncs, **switches)
        return cache[eps]

    return runs


@pytest.fixture(scope="module")
def cadence_runs(loop_data):
    """Both packages at loop_attempt_interval_scans 40, drains of 16."""
    cfg, laser, data = loop_data
    cfg = dataclasses.replace(cfg, loop_attempt_interval_scans=40)
    return _both(cfg, laser, data, _attempts)


@pytest.mark.parametrize("eps", [None, 1.0], ids=["default", "wide"])
def test_resync_gate_matches_jax(resync_runs, eps):
    """Every resync decision after a pose move or closure: the ring's
    staleness (within f32 noise) and the decision equal to the JAX
    package's. At the default RESYNC_EPS a closure that moves the ring
    by centimetres rebuilds it; with the gate at 1 m the same move is
    let through, in both, and the ring is rebuilt less often."""
    logs, runs = resync_runs(eps)
    got, ref = np.array(logs["torch"]), np.array(logs["jax"])
    assert got.shape == ref.shape and len(got) >= 1
    np.testing.assert_allclose(got[:, 0], ref[:, 0], atol=1e-4)
    np.testing.assert_array_equal(got[:, 1], ref[:, 1])
    assert (runs["torch"]["counts"]["refresh_state"]
            == runs["jax"]["counts"]["refresh_state"])
    stale = got[:, 0] > 0.003
    assert stale.any()
    if eps is None:
        np.testing.assert_array_equal(got[:, 1], stale)
    else:
        assert not got[:, 1].any()
        default = resync_runs(None)[1]
        assert (runs["torch"]["counts"]["refresh_state"]
                < default["torch"]["counts"]["refresh_state"])


def test_loop_attempt_cadence_matches_jax(cadence_runs):
    """The drains' loop attempts fall on the same scans in both packages,
    one every third drain of 16 (40 scans or more since the last)."""
    logs, _ = cadence_runs
    assert logs["torch"] == logs["jax"]
    cadence = [uid for uid, kind in logs["torch"] if kind == "cadence"]
    assert len(cadence) >= 2
    assert all(b - a >= 40 for a, b in zip(cadence, cadence[1:]))


def test_terminal_settle_attempt_matches_jax(cadence_runs, loop_data):
    """With the cadence above 0 the final flush leaves scans drained since
    the last attempt, and settle() makes one terminal attempt on the
    newest scan, in both packages; at cadence 0 every drain attempts and
    settle() makes none."""
    logs, runs = cadence_runs
    newest = len(runs["torch"]["traj"]) - 1   # unique ids count from 0
    assert [e for e in logs["torch"] if e[1] == "terminal"] == [
        (newest, "terminal")]
    every = _both(*loop_data, _attempts)[0]
    assert every["torch"] == every["jax"]
    assert all(kind == "cadence" for _, kind in every["torch"])
    assert len(every["torch"]) > len(logs["torch"])
