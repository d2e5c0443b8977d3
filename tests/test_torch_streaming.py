"""The streaming pipeline of the port (slam_toolbox_tpu_torch/mapper/
streaming.py) against the JAX package's on the CPU: the device ring
raster, the ring update with its eviction, a whole drain batch, the pack
pool, and SlamSession(streaming=True) end to end. Inputs are simulated
scans from one seed at the reduced geometry of test_torch_slam.py (0.05 m
grid, 361 beams); both sides get the same numpy arrays."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_toolbox_tpu.api import SlamSession as JaxSession
from slam_toolbox_tpu.kernels import rasterize as jrz
from slam_toolbox_tpu.kernels.match import _raster_quant_impl
from slam_toolbox_tpu.mapper import Mapper as JaxMapper
from slam_toolbox_tpu.mapper import streaming as js
from slam_toolbox_tpu_torch.api import SlamSession as TorchSession
from slam_toolbox_tpu_torch.core.scan import LocalizedScan as TorchScan
from slam_toolbox_tpu_torch.interop import config_from_dict, laser_from_dict
from slam_toolbox_tpu_torch.kernels import rasterize as trz
from slam_toolbox_tpu_torch.mapper import Mapper as TorchMapper
from slam_toolbox_tpu_torch.mapper import streaming as ts
from test_torch_slam import LAP, _run, _workload

K_RING = 12   # scan_buffer_size 10 + 2 slack slots, as the pipeline sizes it


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain versions are many small tensor operations: one intra-op
    thread per test worker keeps them from oversubscribing the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(cfg, laser):
    return (config_from_dict(dataclasses.asdict(cfg)),
            laser_from_dict(dataclasses.asdict(laser)))


def _sessions(cfg, laser, **kw):
    tcfg, tlaser = _port(cfg, laser)
    return (JaxSession(cfg, laser, **kw),
            TorchSession(tcfg, tlaser, device="cpu", **kw))


@pytest.fixture(scope="module")
def ring_case():
    """Both packages' sequential matchers and a ring of simulated scans at
    their true poses, as the JAX scans and the port's scans of the same
    ranges."""
    cfg, laser, data = _workload(0.05, 1.0, LAP[:4], 0.6)
    tcfg, tlaser = _port(cfg, laser)
    jm, tm = JaxMapper(cfg), TorchMapper(tcfg, device="cpu")
    jm.initialize(laser.range_threshold)
    tm.initialize(laser.range_threshold)
    jscans, tscans = [], []
    for scan, tp in data:
        scan.set_corrected_pose(tp)
        t = TorchScan(tlaser, scan.ranges, scan.odom_pose)
        t.set_corrected_pose(tp)
        jscans.append(scan)
        tscans.append(t)
    return dict(cfg=cfg, laser=laser, jm=jm.sequential_matcher,
                tm=tm.sequential_matcher, jscans=jscans, tscans=tscans)


def _states(case, members, slots, head, count, last):
    """The same device state in both layouts: ring scans `members` in
    ring slots `slots` at their f32 sensor poses, odometry and correction
    of scan `last`."""
    jscans, tscans = case["jscans"], case["tscans"]
    B = len(jscans[0].ranges)
    pack = np.zeros((K_RING, B, 8), np.float32)
    pack[:, :, 6] = -1.0
    pose = np.zeros((K_RING, 3), np.float32)
    slot_valid = np.zeros(K_RING, bool)
    for k, i in zip(slots, members):
        p = ts.scan_pack(tscans[i])
        np.testing.assert_array_equal(p, js.scan_pack(jscans[i]))
        pack[k] = p
        pose[k] = jscans[i].sensor_pose
        slot_valid[k] = True
    odom = jscans[last].odom_pose.astype(np.float32)
    corr = jscans[last].corrected_pose.astype(np.float32)
    flags = pack[:, :, 7].astype(np.int32)
    jstate = {
        "ring_local": pack[:, :, 0:2], "ring_anchor": pack[:, :, 2:4],
        "ring_current": pack[:, :, 4:6],
        "ring_dvalid": (flags & 2) > 0,
        "ring_next": pack[:, :, 6].astype(np.int32),
        "ring_finite": (flags & 1) > 0,
        "ring_pose": pose, "ring_slot_valid": slot_valid,
        "head": np.int32(head), "count": np.int32(count),
        "last_odom": odom, "last_corrected": corr,
        "results": np.zeros((ts.RESULT_CAP, 13), np.float32),
        "n_results": np.int32(0),
    }
    tstate = ts._new_state(K_RING, B, ts.RESULT_CAP, 16, "cpu")
    for key, a in (("ring_pack", pack), ("ring_pose", pose),
                   ("ring_slot_valid", slot_valid), ("head", head),
                   ("count", count), ("last_odom", odom),
                   ("last_corrected", corr)):
        tstate[key].copy_(torch.as_tensor(a))
    return {k: jnp.asarray(v) for k, v in jstate.items()}, tstate


def _jax_raster(case, jstate, odom):
    m = case["jm"]
    return js._stream_raster_impl(
        jstate, jnp.asarray(odom), jnp.asarray(case["laser"].offset_pose,
                                               jnp.float32),
        np.float32(m.scale), np.float32(m.sigma_cells),
        np.float32(0.5 * (m.G - 1) * m.resolution),
        m.G, m.half_kernel, m._acc_r, False,
    )


def _torch_raster(case, tstate, odom):
    m = case["tm"]
    return ts._stream_raster_impl(
        tstate, torch.from_numpy(odom), m,
        torch.tensor(case["laser"].offset_pose, dtype=torch.float32),
        ts._f32(0.5 * (m.G - 1) * m.resolution),
    )


@pytest.mark.parametrize("members,slots", [
    (list(range(2, 14)), list(range(K_RING))),          # a full ring
    ([5, 6, 7, 8, 9, 10, 11], [4, 5, 6, 7, 8, 9, 10]),  # empty slots
])
def test_stream_raster_matches_jax(ring_case, members, slots):
    """Prior, center, device FindValidPoints and the int8 ring raster: the
    raster bit-equal to the JAX program's, the valid mask equal to the
    JAX package's f64 host FindValidPoints, the world points within
    1e-5 m of the f64 host points."""
    case = ring_case
    q = members[-1] + 1
    odom = case["jscans"][q].odom_pose.astype(np.float32)
    jstate, tstate = _states(case, members, slots, slots[0], len(members),
                             members[-1])
    jgrid, _, jco, jprior = _jax_raster(case, jstate, odom)
    tgrid, tco, tprior = _torch_raster(case, tstate, odom)
    np.testing.assert_allclose(tprior.numpy(), np.asarray(jprior), atol=1e-6)
    np.testing.assert_allclose(tco.numpy(), np.asarray(jco), atol=1e-6)
    np.testing.assert_array_equal(tgrid.numpy(), np.asarray(jgrid))
    assert (tgrid.numpy() > 0).sum() > 1000

    pts, valid = ts._ring_points(tstate["ring_pack"], tstate["ring_pose"],
                                 tstate["ring_slot_valid"], tco[:2])
    B = len(case["jscans"][0].ranges)
    pts, valid = pts.numpy().reshape(K_RING, B, 2), valid.numpy().reshape(
        K_RING, B)
    vp = tco[:2].numpy().astype(np.float64)
    for k in range(K_RING):
        if k not in slots:
            assert not valid[k].any()
            continue
        s = case["jscans"][members[slots.index(k)]]
        ref_pts = jrz.find_valid_mask(
            s.points_world(filtered=False),
            jrz.find_valid_points_structure(s.points_world(filtered=False)),
            vp)
        np.testing.assert_array_equal(valid[k], ref_pts)
        w = s.points_world(filtered=False)
        fin = np.isfinite(w).all(axis=1)
        np.testing.assert_allclose(pts[k][fin], w[fin], atol=1e-5)


def _score_kwargs(case):
    jm, tm = case["jm"], case["tm"]
    jkw = dict(jm._score_args, penalize=np.bool_(True), grid_size=jm.G,
               na_coarse=jm._na_coarse, na_fine=jm._na_fine,
               acc_r=jm._acc_r, refine=True)
    return jkw, dict(tm._score_args, penalize=True, refine=True)


@pytest.mark.parametrize("kind", ["count", "distance", "first"])
def test_stream_update_matches_jax(ring_case, kind):
    """Score, is_first selects, ring push and the eviction (by count and
    by front-to-back distance) against the JAX program: head, count, the
    pushed pose and the result row."""
    case = ring_case
    cfg = case["cfg"]
    rmax = np.float32(cfg.scan_buffer_maximum_scan_distance)
    if kind == "count":      # a full running buffer: the push evicts one
        members = list(range(3, 13))
    elif kind == "distance":  # 1.2 m spacing: the front is > 3 m behind
        members = [0, 2, 4, 6, 8, 10, 12]
        rmax = np.float32(3.0)
    else:                    # an empty ring: the scan is the first
        members = []
    slots = [(5 + j) % K_RING for j in range(len(members))]
    q = (members[-1] + 1) if members else 13
    jstate, tstate = _states(case, members, slots, 5, len(members),
                             members[-1] if members else q - 1)
    odom = case["jscans"][q].odom_pose.astype(np.float32)
    jpack = jnp.asarray(js.scan_pack(case["jscans"][q]))
    tpack = torch.from_numpy(ts.scan_pack(case["tscans"][q]))
    offset = case["laser"].offset_pose
    jkw, tkw = _score_kwargs(case)

    jgrid, jp, jco, jprior = _jax_raster(case, jstate, odom)
    jnew = js._stream_update_impl(
        jgrid, jp, jco, jprior, jstate, jpack, jnp.asarray(odom),
        jnp.asarray(offset, jnp.float32), np.int32(cfg.scan_buffer_size),
        rmax, jkw)
    tgrid, tco, tprior = _torch_raster(case, tstate, odom)
    ts._stream_update_impl(
        tgrid, tco, tprior, tstate, tpack, torch.from_numpy(odom),
        torch.tensor(offset, dtype=torch.float32), cfg.scan_buffer_size,
        float(rmax * rmax - np.float32(1e-6)), tkw,
        torch.eye(3).reshape(-1))

    assert int(tstate["head"]) == int(jnew["head"])
    assert int(tstate["count"]) == int(jnew["count"])
    assert int(tstate["ridx"]) == int(jnew["n_results"]) == 1
    if kind == "count":
        assert int(jnew["count"]) == cfg.scan_buffer_size
    elif kind == "distance":
        assert int(jnew["count"]) < len(members) - 1
    else:
        assert int(jnew["count"]) == 1
        assert float(jnew["results"][0, 0]) == 0.0
    np.testing.assert_allclose(tstate["results"][0].numpy(),
                               np.asarray(jnew["results"][0]), atol=1e-5)
    np.testing.assert_allclose(tstate["ring_pose"].numpy(),
                               np.asarray(jnew["ring_pose"]), atol=1e-5)
    np.testing.assert_allclose(tstate["last_corrected"].numpy(),
                               np.asarray(jnew["last_corrected"]), atol=1e-5)


def test_stream_batch_matches_jax(ring_case):
    """One drain batch of 16 scans from an empty ring, the port's Python
    loop against the JAX fori_loop program: every result row, head and
    count."""
    case = ring_case
    cfg = case["cfg"]
    n = 16
    jstate, tstate = _states(case, [], [], 0, 0, 0)
    jm = case["jm"]
    jkw, tkw = _score_kwargs(case)
    jkw = {k: v for k, v in jkw.items()
           if k not in ("grid_size", "na_coarse", "na_fine", "acc_r",
                        "refine")}
    packs = np.stack([js.scan_pack(s) for s in case["jscans"][:n]])
    odoms = np.stack([s.odom_pose for s in case["jscans"][:n]]).astype(
        np.float32)
    offset = np.asarray(case["laser"].offset_pose, np.float32)
    half = np.float32(0.5 * (jm.G - 1) * jm.resolution)
    jout = js._stream_batch_jit(
        jstate, jnp.asarray(packs), jnp.asarray(odoms), jnp.int32(n),
        offset_pose=jnp.asarray(offset), scale=np.float32(jm.scale),
        sigma_cells=np.float32(jm.sigma_cells), half_span=half,
        run_buffer_size=np.int32(cfg.scan_buffer_size),
        run_max_distance=np.float32(cfg.scan_buffer_maximum_scan_distance),
        score_args=jkw, grid_size=jm.G, half_kernel=jm.half_kernel,
        acc_r=jm._acc_r, parity=False, na_coarse=jm._na_coarse,
        na_fine=jm._na_fine)
    rmax = np.float32(cfg.scan_buffer_maximum_scan_distance)
    ts._stream_batch_impl(
        tstate, torch.from_numpy(packs), torch.from_numpy(odoms),
        case["tm"], torch.from_numpy(offset), float(half),
        cfg.scan_buffer_size, float(rmax * rmax - np.float32(1e-6)), tkw,
        torch.eye(3).reshape(-1))
    np.testing.assert_allclose(tstate["results"][:n].numpy(),
                               np.asarray(jout["results"][:n]), atol=1e-5)
    assert int(tstate["head"]) == int(jout["head"])
    assert int(tstate["count"]) == int(jout["count"])
    assert tstate["n_results"] == n


def test_pack_pool_append_release_compact_gather(ring_case, monkeypatch):
    """Row 0 stays the zero row; growth keeps rows; released slots are
    reclaimed by a compaction that renumbers the live scans' slots."""
    scans = ring_case["tscans"][:12]
    packs = np.stack([ts.scan_pack(s) for s in scans])
    monkeypatch.setattr(ts, "POOL_CAP", 8)
    pool = ts.PackPool(packs.shape[1], torch.device("cpu"))
    pool.append_batch(torch.from_numpy(packs[:6]), scans[:6])
    pool.append_batch(torch.from_numpy(packs[6:]), scans[6:])
    assert pool.cap == 16 and pool.n == 13
    assert [s._pool_slot for s in scans] == list(range(1, 13))
    np.testing.assert_array_equal(pool.gather([[0, 3], [12, 1]]).numpy(),
                                  np.stack([[np.zeros_like(packs[0]),
                                             packs[2]],
                                            [packs[11], packs[0]]]))
    for s in scans[:8]:
        pool.release(s)
    assert all(s._pool_slot is None for s in scans[:8])
    pool.append_batch(torch.from_numpy(packs[:4]), scans[:4])  # compacts
    assert pool.cap == 16 and pool.n == 9
    assert [s._pool_slot for s in scans[8:]] == [1, 2, 3, 4]
    assert [s._pool_slot for s in scans[:4]] == [5, 6, 7, 8]
    np.testing.assert_array_equal(
        pool.gather([s._pool_slot for s in scans[8:] + scans[:4]]).numpy(),
        np.concatenate([packs[8:], packs[:4]]))


def test_streaming_session_matches_jax():
    """SlamSession(streaming=True, drain_every=16): the port on the CPU
    against the JAX session with the fused loop verify, two laps (loop
    closures on the revisits). Same accepted scans, edges and closures;
    positions inside PARITY.md's 4 cm engine envelope."""
    cfg, laser, data = _workload(0.05, 1.0, LAP * 2 + [LAP[0]], 0.6)
    mp = pytest.MonkeyPatch()
    mp.setenv("SLAM_FUSED_LOOP", "1")   # read by the JAX package only
    try:
        jsess, tsess = _sessions(cfg, laser, streaming=True, drain_every=16)
        ref = _run(jsess, data)
    finally:
        mp.undo()
    tsess.stats.enabled = True
    got = _run(tsess, data)
    assert len(got["est"]) == len(ref["est"]) >= 120
    assert got["edges"] == ref["edges"]
    assert got["closures"] == ref["closures"] >= 1
    assert tsess.stats.counts["loop_verify_dispatch"] >= 1
    gap = np.hypot(*(got["traj"][:, :2] - ref["traj"][:, :2]).T)
    assert gap.max() < 0.04, gap.max()


def test_streaming_drain1_matches_classic():
    """drain_every=1 replays the classic per-scan sequence: the port's
    streaming path against its classic path within the JAX package's own
    3.5 cm invariant (f32 device prior against the f64 host prior), on
    that invariant's own data (tests/test_streaming.py:52-60)."""
    from slam_toolbox_tpu.io.dataset import LidarSimulator, SegmentWorld
    from test_pipeline import sim_config

    laser, cfg = sim_config()
    sim = LidarSimulator(SegmentWorld.rooms(16.0, 10.0), laser,
                         range_noise=0.01, odom_noise=(0.02, 0.008), seed=31)
    wp = np.array([(-6.0, -3.5), (1.5, -3.5), (5.5, -3.5), (5.5, 3.5),
                   (1.0, 3.5), (-3.0, 3.5), (-6.0, 3.0)])
    data = sim.simulate(wp, step=0.45)[:25]
    tcfg, tlaser = _port(cfg, laser)
    classic = _run(TorchSession(tcfg, tlaser, device="cpu"), data)
    stream = _run(TorchSession(tcfg, tlaser, device="cpu", streaming=True,
                               drain_every=1), data)
    assert len(classic["traj"]) == len(stream["traj"]) == len(data)
    gap = np.hypot(*(classic["traj"][:, :2] - stream["traj"][:, :2]).T)
    assert gap.max() < 0.035, gap.max()


def test_streaming_session_surface():
    """The online pose between drains is the propagated prior; flush()
    drains and settles; accessors see every scan; localization through
    the pipeline keeps the graph at the mapped scans plus the buffer."""
    cfg, laser, data = _workload(0.05, 1.0, LAP[:2], 0.6)
    tcfg, tlaser = _port(cfg, laser)
    sess = TorchSession(tcfg, tlaser, device="cpu", streaming=True,
                        drain_every=4)
    outs = [sess.process_scan(s.ranges, s.odom_pose, time=i * 0.1)
            for i, (s, _) in enumerate(data[:10])]
    accepted = [o for o in outs if o is not None]
    assert len(accepted) == 10 and len(sess._pipe.pending) == 2
    pose, cov = accepted[-1]
    assert np.all(np.isfinite(pose)) and cov.shape == (3, 3)
    sess.flush()
    assert not sess._pipe.pending and sess._pipe._pending_drain is None
    assert len(sess.trajectory) == 10
    nodes, edges = sess.get_graph()
    assert len(nodes) == 10 and edges
    # localization through the pipeline: after toggle_mode the buffer's
    # append and evict ride the drains (post_finish), bounding the graph
    sess.toggle_mode("localization")
    assert sess._pipe.post_finish == sess._loc_post_finish
    more = _workload(0.05, 1.0, LAP[1:3], 0.6)[2]
    for i, (s, _) in enumerate(more):
        sess.process_scan(s.ranges, s.odom_pose, time=(10 + i) * 0.1)
    sess.flush()
    buffer = sess.localization_buffer_uids()
    assert len(buffer) == min(len(more), tcfg.scan_buffer_size)
    assert sess.mapper.solver.n_nodes == 10 + len(buffer)
    assert not sess._pipe.pending


def test_smear_taps_do_not_change_the_bench_raster():
    """The port's bench-geometry taps (sigma 10 cells, hk 20) are one ulp
    above XLA-CPU's at k = +-19, yet no product of two taps quantizes
    differently, so the raster of a bench-geometry ring is the JAX
    package's bit for bit."""
    from test_torch_slam import _workload as wl

    cfg, laser, data = wl(0.01, 1.0 / 3, LAP[:2], 0.3)
    pts = np.concatenate([s.points_world(filtered=False)
                          for s, _ in data[:K_RING]])
    valid = np.isfinite(pts).all(axis=1)
    pts = np.where(valid[:, None], pts, 0.0).astype(np.float32)
    center = data[K_RING][0].odom_pose[:2]
    G, hk = 2051, 20
    off = (center - 0.5 * (G - 1) * 0.01).astype(np.float32)
    ref, _ = _raster_quant_impl(
        jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(off),
        np.float32(100.0), np.float32(10.0), G, hk, 32, False)
    got = trz.rasterize_smear(torch.from_numpy(pts), torch.from_numpy(valid),
                              torch.from_numpy(off), 100.0, 10.0, G, hk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert len(pts) == K_RING * 1081 and (got.numpy() > 0).sum() > 10000
    # the reason: every product w_i * w_j of either tap vector quantizes
    # to the same int8
    jt = np.asarray(jnp.exp(-0.5 * (jnp.arange(-hk, hk + 1,
                                               dtype=jnp.float32) / 10.0)
                            ** 2))
    tt = trz.smear_weights(10.0, hk)
    assert (jt != tt).sum() == 2

    def quant(w):
        z = (w[:, None] * w[None, :]).astype(np.float32) * np.float32(100.0)
        return np.where(z >= 0, np.floor(z + 0.5), np.ceil(z - 0.5))

    np.testing.assert_array_equal(quant(tt), quant(jt))
