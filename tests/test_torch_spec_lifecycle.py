"""The port's session surface for supervised deployments, on the CPU:
lifecycle transitions driving the pause domains and the bond heartbeat,
the watchdog over the streaming drain's fetches and health(), shutdown()
settling a streaming pipe before it stops the watchdog, and warming
(warm_all, warm_async) leaving results as a cold session's. The first
three are tests/test_lifecycle.py's TestSessionIntegration, ported."""
import dataclasses
import sys
import threading
import time

import numpy as np
import pytest

from slam_toolbox_tpu_torch.api import SlamSession
from slam_toolbox_tpu_torch.api.slam import PausedApplication
from slam_toolbox_tpu_torch.core.params import MapperConfig
from slam_toolbox_tpu_torch.core.scan import LaserConfig
from slam_toolbox_tpu_torch.interop import config_from_dict, laser_from_dict
from slam_toolbox_tpu_torch.utils.lifecycle import LifecycleState
from test_torch_spec_session import _one_thread, loop_data  # noqa: F401


def _wait_for(pred, timeout=5.0, poll=0.005):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(poll)
    return pred()


def _session():
    return SlamSession(MapperConfig(), LaserConfig(), device="cpu")


@pytest.fixture
def streaming(loop_data):
    """A factory of streaming sessions on the two-lap data, and the data."""
    cfg, laser, data = loop_data
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    tlaser = laser_from_dict(dataclasses.asdict(laser))

    def make(**kw):
        return SlamSession(tcfg, tlaser, device="cpu", streaming=True,
                           drain_every=16, **kw)

    return make, data


def _feed(sess, data):
    for i, (scan, _) in enumerate(data):
        sess.process_scan(scan.ranges, scan.odom_pose, time=i * 0.1)


def test_transitions_drive_pause_domains():
    s = _session()
    s.configure()
    s.activate()
    assert not s.is_paused(PausedApplication.NEW_MEASUREMENTS)
    assert not s.is_paused(PausedApplication.PROCESSING)
    s.deactivate()
    assert s.is_paused(PausedApplication.NEW_MEASUREMENTS)
    assert s.is_paused(PausedApplication.PROCESSING)
    s.cleanup()
    assert s.lifecycle.state is LifecycleState.UNCONFIGURED


def test_bond_follows_activation(tmp_path):
    s = _session()
    bond = s.create_bond(path=str(tmp_path / "live"), period=0.01)
    assert bond.alive
    assert s.create_bond(path=str(tmp_path / "live"), period=0.01) is bond
    with pytest.raises(ValueError):
        s.create_bond(path=str(tmp_path / "other"), period=0.01)
    s.configure()
    s.activate()
    s.deactivate()  # on_deactivate breaks the bond
    assert not bond.alive
    h = s.health()
    assert h["lifecycle"] == "INACTIVE"
    assert not h["bond_alive"]
    s.shutdown()
    assert s.lifecycle.state is LifecycleState.FINALIZED


def test_health_reports_watchdog():
    s = _session()
    assert s.health()["status"] == "ok"
    wd = s.enable_watchdog(stall_s=0.05)
    try:
        assert s.enable_watchdog(stall_s=0.05) is wd
        with pytest.raises(ValueError):
            s.enable_watchdog(stall_s=1.0)
        with wd.section("drain_fetch"):
            _wait_for(lambda: s.health()["status"] == "stalled")
            assert s.health()["status"] == "stalled"
        assert s.health()["status"] == "ok"
        assert s.health()["stalls"][0]["section"] == "drain_fetch"
    finally:
        wd.stop()


def test_shutdown_settles_the_pipe_before_stopping_the_watchdog(streaming):
    """Every drain's fetch runs inside a watchdog section; shutdown()
    commits the batch in flight and the deferred closure while the
    watchdog still runs, then stops it."""
    make, data = streaming
    sess = make()
    wd = sess.enable_watchdog(stall_s=30.0)
    sections = []
    section = wd.section
    wd.section = lambda name: sections.append(name) or section(name)
    _feed(sess, data[:40])
    pipe = sess._pipe
    assert pipe.watchdog is wd and sections == ["drain_fetch"]
    assert pipe._pending_drain is not None
    seen = []
    settle = pipe.settle
    pipe.settle = lambda: seen.append(wd._thread is not None
                                      and wd._thread.is_alive()) or settle()
    sess.shutdown()
    assert seen == [True]
    assert sections == ["drain_fetch"] * 2
    assert pipe._pending_drain is None and pipe._deferred_loop is None
    assert wd._thread is None
    assert sess.lifecycle.state is LifecycleState.FINALIZED


def test_watchdog_set_after_the_pipe_reaches_it(streaming):
    make, data = streaming
    sess = make()
    _feed(sess, data[:3])
    assert sess._pipe.watchdog is None
    wd = sess.enable_watchdog(stall_s=30.0)
    try:
        assert sess._pipe.watchdog is wd
    finally:
        wd.stop()


@pytest.mark.parametrize("stream", [True, False], ids=["streaming",
                                                        "classic"])
def test_warm_all_leaves_results_as_a_cold_session(streaming, stream):
    """warm_all (each matcher once per path, the streaming batch and
    verify, the solver at 3 and 257 nodes) changes no result."""
    make, data = streaming
    warm, cold = make(), make()
    for s in (warm, cold):
        s.streaming = stream
    warm.warm_all()
    assert (warm._pipe is not None) == stream
    for s in (warm, cold):
        _feed(s, data[:40])
    np.testing.assert_array_equal(warm.trajectory, cold.trajectory)


def test_warm_async_races_the_first_scans(streaming):
    """warm_async's thread warms while scans arrive: one pipeline, the
    thread ends, and the poses are a cold session's."""
    make, data = streaming
    warm, cold = make(), make()
    t = warm.warm_async()
    assert warm.warm_async() is t
    _feed(warm, data[:40])
    t.join(timeout=120)
    assert not t.is_alive()
    _feed(cold, data[:40])
    np.testing.assert_array_equal(warm.trajectory, cold.trajectory)


def test_pipe_is_built_once_under_concurrent_first_use(streaming):
    """Threads asking for the streaming pipeline at once (warm_async and
    process_scan) get one pipeline."""
    make, _ = streaming
    sess = make()
    sess.mapper.initialize(sess.laser.range_threshold)
    barrier = threading.Barrier(8)
    got = []

    def first_use():
        barrier.wait(timeout=30)
        got.append(sess._ensure_pipe())

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=first_use) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 8 and all(p is sess._pipe for p in got)
