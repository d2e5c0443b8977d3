"""Snapshots and resume in the port (io/serialization.py, SlamSession
serialize/deserialize) against the JAX package on the CPU: snapshots
cross packages in both directions with every array and the meta equal,
and sessions resumed from one snapshot continue as the JAX ones do
(same accepted scans and edges, positions inside PARITY.md's 4 cm
engine envelope)."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from slam_toolbox_tpu.api import MatchType as JaxMatchType
from slam_toolbox_tpu.api import SlamSession as JaxSession
from slam_toolbox_tpu.core.scan import LocalizedScan as JaxScan
from slam_toolbox_tpu.io import serialization as jser
from slam_toolbox_tpu.io.dataset import LidarSimulator, SegmentWorld
from slam_toolbox_tpu.mapper import Mapper as JaxMapper
from slam_toolbox_tpu_torch.api import MatchType, SlamSession
from slam_toolbox_tpu_torch.core.scan import LocalizedScan
from slam_toolbox_tpu_torch.interop import config_from_dict, laser_from_dict
from slam_toolbox_tpu_torch.io import serialization as tser
from slam_toolbox_tpu_torch.mapper import Mapper
from test_pipeline import sim_config
from test_torch_slam import LAP, _workload

torch.set_num_threads(1)


def _config():
    """test_pipeline.sim_config at a 0.05 m correlation grid (G 411, not
    2051), which keeps the CPU runs short."""
    laser, cfg = sim_config()
    return laser, cfg.replace(correlation_search_space_resolution=0.05)


def _port(cfg, laser):
    return (config_from_dict(dataclasses.asdict(cfg)),
            laser_from_dict(dataclasses.asdict(laser)))


def _feed(sess, data, t0=0.0):
    n = 0
    for i, (scan, _) in enumerate(data):
        if sess.process_scan(scan.ranges, scan.odom_pose,
                             time=t0 + i * 0.1) is not None:
            n += 1
    return n


def _npz(path):
    with np.load(path, allow_pickle=False) as z:
        out = {k: z[k] for k in z.files}
    out["meta"] = json.loads(bytes(out["meta"]).decode())
    return out


def _assert_snapshots_equal(a, b):
    za, zb = _npz(a), _npz(b)
    assert sorted(za) == sorted(zb)
    assert za.pop("meta") == zb.pop("meta")
    for k in za:
        assert za[k].dtype == zb[k].dtype, k
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


@pytest.fixture(scope="module")
def short_run(tmp_path_factory):
    """test_serialization.py's short run, through both packages, each
    serialized."""
    laser, cfg = _config()
    sim = LidarSimulator(SegmentWorld.box(5.0), laser, range_noise=0.01,
                         seed=3)
    data = sim.simulate(np.array([(-2.0, -2.0), (2.0, -2.0), (2.0, 2.0)]),
                        step=0.45)
    d = tmp_path_factory.mktemp("snap")
    jsess = JaxSession(cfg, laser)
    _feed(jsess, data)
    jsess.serialize(str(d / "jax.npz"))
    tcfg, tlaser = _port(cfg, laser)
    tsess = SlamSession(tcfg, tlaser, device="cpu")
    _feed(tsess, data)
    tsess.serialize(str(d / "port.npz"))
    return dict(dir=d, data=data, jsess=jsess, tsess=tsess,
                jax=str(d / "jax.npz"), port=str(d / "port.npz"))


def test_jax_snapshot_loads_in_the_port_and_back(short_run):
    d = short_run["dir"]
    m = tser.load_snapshot(short_run["jax"], device="cpu")
    tser.save_snapshot(m, str(d / "jax_via_port.npz"))
    _assert_snapshots_equal(short_run["jax"], str(d / "jax_via_port.npz"))
    jm = jser.load_snapshot(str(d / "jax_via_port.npz"))
    jser.save_snapshot(jm, str(d / "jax_via_port_via_jax.npz"))
    _assert_snapshots_equal(short_run["jax"],
                            str(d / "jax_via_port_via_jax.npz"))
    assert m.solver.n_nodes == jm.solver.n_nodes > 5
    assert len(m.graph.edges) == len(jm.graph.edges)


def test_port_snapshot_loads_in_jax_and_back(short_run):
    d = short_run["dir"]
    jm = jser.load_snapshot(short_run["port"])
    jser.save_snapshot(jm, str(d / "port_via_jax.npz"))
    _assert_snapshots_equal(short_run["port"], str(d / "port_via_jax.npz"))
    m = tser.load_snapshot(str(d / "port_via_jax.npz"), device="cpu")
    tser.save_snapshot(m, str(d / "port_via_jax_via_port.npz"))
    _assert_snapshots_equal(short_run["port"],
                            str(d / "port_via_jax_via_port.npz"))


def test_roundtrip_preserves_graph(short_run):
    sess = short_run["tsess"]
    m2 = tser.load_snapshot(short_run["port"], device="cpu")
    assert m2.solver.n_nodes == sess.mapper.solver.n_nodes
    assert len(m2.graph.edges) == len(sess.mapper.graph.edges)
    assert [e._list_idx for e in m2.graph.edges] == list(
        range(len(m2.graph.edges)))
    s1 = sess.mapper.all_processed_scans()
    s2 = m2.all_processed_scans()
    assert len(s1) == len(s2)
    for a, b in zip(s1, s2):
        np.testing.assert_allclose(a.corrected_pose, b.corrected_pose,
                                   atol=1e-9)
        np.testing.assert_allclose(
            np.nan_to_num(a.ranges), np.nan_to_num(b.ranges), atol=3e-5)
        assert a.unique_id == b.unique_id and a.state_id == b.state_id
        assert b._local_bary is not None and b._local_pts is None
        np.testing.assert_allclose(a.barycenter, b.barycenter, atol=5e-5)


@pytest.mark.parametrize("match", ["UNSET", "START_AT_GIVEN_POSE"])
def test_continue_mapping_matches_jax(short_run, match):
    """Both packages resume from the JAX snapshot and map on along the
    path; START_AT_GIVEN_POSE relocalizes its first scan near the given
    pose (PROCESS_NEAR_REGION)."""
    laser, cfg = _config()
    tcfg, tlaser = _port(cfg, laser)
    init = short_run["data"][-1][0].corrected_pose
    jsess = JaxSession(cfg, laser)
    tsess = SlamSession(tcfg, tlaser, device="cpu")
    jsess.deserialize(short_run["jax"], getattr(JaxMatchType, match),
                      initial_pose=init)
    tsess.deserialize(short_run["jax"], getattr(MatchType, match),
                      initial_pose=init)
    n0 = tsess.mapper.solver.n_nodes
    assert n0 == jsess.mapper.solver.n_nodes
    sim = LidarSimulator(SegmentWorld.box(5.0), laser, range_noise=0.01,
                         seed=5)
    last_true = short_run["data"][-1][1]
    more = sim.simulate(
        np.array([last_true[:2], (last_true[0] - 1.5, last_true[1])]),
        step=0.45)
    n_ok = _feed(tsess, more, t0=100.0)
    assert n_ok == _feed(jsess, more, t0=100.0) > 0
    assert tsess.mapper.solver.n_nodes == jsess.mapper.solver.n_nodes > n0
    assert len(tsess.mapper.graph.edges) == len(jsess.mapper.graph.edges)
    gap = np.hypot(*(tsess.trajectory[:, :2] - jsess.trajectory[:, :2]).T)
    assert gap.max() < 0.04, gap.max()


def test_localize_at_pose_is_not_ported(short_run):
    laser, cfg = _config()
    tsess = SlamSession(*_port(cfg, laser), device="cpu")
    with pytest.raises(NotImplementedError, match="item 7"):
        tsess.deserialize(short_run["jax"], MatchType.LOCALIZE_AT_POSE,
                          initial_pose=np.zeros(3))
    assert tsess.mapper.all_processed_scans() == []


def _resume_data(seed, waypoints):
    laser, cfg = _config()
    sim = LidarSimulator(SegmentWorld.box(5.0), laser, range_noise=0.01,
                         odom_noise=(0.005, 0.002), seed=seed)
    return laser, cfg, sim, sim.simulate(np.array(waypoints), step=0.45)


def _mapped(mapper, laser, data, scan_cls):
    accepted = []
    for i, (scan, tp) in enumerate(data):
        s = scan_cls(laser, scan.ranges, scan.odom_pose, time=i * 0.1)
        if mapper.process(s):
            accepted.append((s, tp))
    return accepted


def test_process_at_dock_resumes_from_first_node(tmp_path):
    """test_resume_modes.py's dock case on the port, held to the JAX
    mapper resumed from the same snapshot."""
    laser, cfg, sim, data = _resume_data(9, [(-2.0, -2.0), (1.0, -2.0)])
    jm = JaxMapper(cfg)
    _mapped(jm, laser, data, JaxScan)
    path = str(tmp_path / "dock.npz")
    jser.save_snapshot(jm, path)

    dock_true = data[0][1]
    r = sim.scan_at(dock_true)
    odom = np.array([0.02, -0.01, 0.01]) + dock_true
    m2 = tser.load_snapshot(path, device="cpu")
    s = LocalizedScan(laser_from_dict(dataclasses.asdict(laser)), r, odom,
                      time=100.0)
    assert m2.process_at_dock(s)
    err = np.hypot(*(s.corrected_pose[:2] - dock_true[:2]))
    assert err < 0.1, f"dock relocalization error {err}"
    np.testing.assert_allclose(s.odom_pose, s.corrected_pose)
    jm2 = jser.load_snapshot(path)
    js = JaxScan(laser, r, odom, time=100.0)
    assert jm2.process_at_dock(js)
    assert np.hypot(*(s.corrected_pose[:2] - js.corrected_pose[:2])) < 0.04


def test_process_against_node_seeds_running(tmp_path):
    """test_resume_modes.py's against-node case on the port, from a
    snapshot the port wrote, held to the JAX mapper on the same one."""
    laser, cfg, sim, data = _resume_data(11, [(-2.0, -2.0), (2.0, -2.0)])
    tcfg, tlaser = _port(cfg, laser)
    m = Mapper(tcfg, device="cpu")
    accepted = _mapped(m, tlaser, data, LocalizedScan)
    path = str(tmp_path / "mid.npz")
    tser.save_snapshot(m, path)

    mid_scan, mid_true = accepted[len(accepted) // 2]
    r = sim.scan_at(mid_true)
    m2 = tser.load_snapshot(path, device="cpu")
    s = LocalizedScan(tlaser, r, mid_true + 0.02, time=200.0)
    assert m2.process_against_node(s, mid_scan.state_id)
    err = np.hypot(*(s.corrected_pose[:2] - mid_true[:2]))
    assert err < 0.1, f"against-node error {err}"
    assert s in m2.sensor_manager.get_running_scans(tlaser.name)
    jm2 = jser.load_snapshot(path)
    js = JaxScan(laser, r, mid_true + 0.02, time=200.0)
    assert jm2.process_against_node(js, mid_scan.state_id)
    assert np.hypot(*(s.corrected_pose[:2] - js.corrected_pose[:2])) < 0.04


def _resume_and_run(sess, path, data, k):
    """Stream data[:k], serialize, deserialize into the same session,
    stream the rest; closures counted after the deserialize, the final
    flush included."""
    _feed(sess, data[:k])
    sess.serialize(path)
    sess.deserialize(path)
    closures = []
    sess.mapper.listeners.append(closures.append)
    _feed(sess, data[k:], t0=100.0)
    traj = sess.trajectory
    return dict(traj=traj, closures=len(closures),
                edges=len(sess.mapper.graph.edges))


def test_streaming_session_resumes_after_deserialize(tmp_path):
    """A streaming session that has already streamed loads its own
    snapshot (UNSET) and maps on through a revisit: the pipeline is
    rebuilt from the loaded running scans, with no pack pool or slot of
    the old one. Held to the JAX session doing the same."""
    cfg, laser, data = _workload(0.05, 1.0, LAP + LAP[:3], 0.6)
    k = len(data) // 2
    tcfg, tlaser = _port(cfg, laser)
    mp = pytest.MonkeyPatch()
    mp.setenv("SLAM_FUSED_LOOP", "1")   # read by the JAX package only
    try:
        ref = _resume_and_run(
            JaxSession(cfg, laser, streaming=True, drain_every=8),
            str(tmp_path / "jax.npz"), data, k)
    finally:
        mp.undo()
    tsess = SlamSession(tcfg, tlaser, device="cpu", streaming=True,
                        drain_every=8)
    pools = []
    deserialize = tsess.deserialize

    def spy(*a, **kw):
        pools.append(tsess.mapper._pack_pool)
        deserialize(*a, **kw)
        assert tsess._pipe is None and tsess.mapper._pack_pool is None
        assert all(s._pool_slot is None
                   for s in tsess.mapper.all_processed_scans())

    tsess.deserialize = spy
    got = _resume_and_run(tsess, str(tmp_path / "port.npz"), data, k)
    assert pools[0] is not None
    assert tsess.mapper._pack_pool not in (None, pools[0])
    assert len(got["traj"]) == len(ref["traj"]) > k
    assert got["edges"] == ref["edges"]
    assert got["closures"] == ref["closures"] >= 1
    gap = np.hypot(*(got["traj"][:, :2] - ref["traj"][:, :2]).T)
    assert gap.max() < 0.04, gap.max()


def test_session_start_at_first_node(short_run):
    """deserialize(START_AT_FIRST_NODE): the next scan, taken at the dock,
    matches against node 0 (PROCESS_FIRST_NODE), then mapping goes on."""
    from slam_toolbox_tpu_torch.api import ProcessType

    laser, cfg = _config()
    tsess = SlamSession(*_port(cfg, laser), device="cpu")
    tsess.deserialize(short_run["port"], MatchType.START_AT_FIRST_NODE)
    assert tsess.processor_type == ProcessType.PROCESS_FIRST_NODE
    dock_true = short_run["data"][0][1]
    sim = LidarSimulator(SegmentWorld.box(5.0), laser, range_noise=0.01,
                         seed=3)
    out = tsess.process_scan(sim.scan_at(dock_true),
                             dock_true + [0.03, -0.02, 0.01], time=100.0)
    assert out is not None
    assert np.hypot(*(out[0][:2] - dock_true[:2])) < 0.1
    assert tsess.processor_type == ProcessType.PROCESS
