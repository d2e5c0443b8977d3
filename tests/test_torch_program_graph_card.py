"""The per-event programs (slam_toolbox_tpu_torch/kernels/match_cuda.py
Program: the match, the fused loop verify and the near-chain matches as
CUDA graphs on static buffers) on a card, marked `cuda` and skipped without
one: each replay bit-equal to the eager route on fresh tensors, with the
same kernel launches (the graph's by its tally); a function that cannot be
captured raises and leaves no program; warm_async's thread captures beside
a classic session's first scans. The file imports no JAX, so the card's
machine, which has none, runs it with
`python -m pytest --noconftest tests/test_torch_program_graph_card.py`."""
import numpy as np
import pytest
import torch

from slam_toolbox_tpu_torch.api import SlamSession
from slam_toolbox_tpu_torch.core.scan import LocalizedScan
from slam_toolbox_tpu_torch.kernels import loop_verify as lv
from slam_toolbox_tpu_torch.kernels import match_cuda as mc
from slam_toolbox_tpu_torch.kernels.match import Matcher, _scan_device_cache
from slam_toolbox_tpu_torch.mapper import Mapper
from slam_toolbox_tpu_torch.mapper import streaming as ts
from test_torch_stream_graph_card import _workload


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.fixture
def mapped(cuda_device):
    """A mapper on the card, the workload's scans at their true poses and
    a pack pool holding them."""
    cfg, laser, data = _workload()
    mapper = Mapper(cfg, device=cuda_device)
    mapper.initialize(laser.range_threshold)
    scans = []
    for scan, tp in data:
        s = LocalizedScan(laser, scan.ranges, scan.odom_pose)
        s.set_corrected_pose(tp)
        scans.append(s)
    pool = ts.PackPool(laser.n_beams, cuda_device)
    pool.add_scans(scans)
    return mapper, scans, pool


def _counted(fn):
    torch.cuda.synchronize()
    mc.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(mc.LAUNCHES), dict(mc.GRID_LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["sequential", "loop"])
def test_match_replays_equal_eager(mapped, which):
    """Both geometries: matches replayed from their programs (three in
    flight at a time) against the eager route on fresh tensors, bit for
    bit, with the same launches; one program per bucket."""
    mapper, scans, _ = mapped
    m = getattr(mapper, f"{which}_matcher")
    q = scans[30]
    center = np.asarray(q.sensor_pose, np.float64)
    for penalize, refine in ((True, True), (False, True), (False, False)):
        bases = [scans[20:30], scans[25:29], scans[10:28]]
        got, n_graph, g_graph = _counted(lambda: [
            m._dispatch(q, b, center, penalize, refine) for b in bases])
        ref, n_eager, g_eager = _counted(lambda: [
            m._dispatch_eager(q, b, center, penalize, refine)
            for b in bases])
        assert n_graph == n_eager and g_graph == g_eager
        assert n_graph["score_windows"] == 3
        for a, b in zip(got, ref):
            assert torch.equal(a, b), (penalize, refine)
        assert len({a.data_ptr() for a in got}) == 3
    assert all(p.graph is not None for p in m._programs.values())


@pytest.mark.cuda
def test_verify_and_chain_replays_equal_eager(mapped):
    """The fused verify (pooled, unpooled, speculative) and the near-chain
    matches replayed from their programs against each chain unpadded on
    fresh tensors, bit for bit, with the same launches."""
    mapper, scans, pool = mapped
    seq, loop = mapper.sequential_matcher, mapper.loop_matcher
    cfg = mapper.config
    dev = seq.device
    q = scans[-1]
    chains = [scans[2:12], scans[0:5], scans[10:40]]
    local, finite = _scan_device_cache(q, dev)
    center = torch.tensor(np.asarray(q.sensor_pose, np.float32), device=dev)

    def eager_verify():
        return torch.stack([lv._loop_verify_impl(
            torch.stack([lv._pack_dev(s, dev) for s in c]),
            torch.from_numpy(lv.chain_poses([c])[0]).to(dev), None, local,
            finite, center, lv._gates(cfg), loop, seq) for c in chains])

    ref, n_eager, g_eager = _counted(eager_verify)
    for p in (pool, None):
        got, n, g = _counted(lambda: lv.dispatch_loop_verify(
            loop, seq, q, chains, cfg, pool=p).numpy())
        assert (n, g) == (n_eager, g_eager)
        np.testing.assert_array_equal(got, ref.cpu().numpy())
    results = torch.zeros((4, 13), device=dev)
    results[2, 1:4] = center
    (rows, _), n, g = _counted(lambda: lv.dispatch_loop_verify_spec(
        loop, seq, q, 2, chains, cfg, pool, results))
    assert (n, g) == (n_eager, g_eager)
    np.testing.assert_array_equal(rows.numpy(), ref.cpu().numpy())

    pairs = [(scans[-1], c) for c in chains]

    def eager_chain():
        return torch.stack([lv._chain_match_impl(
            lv._pack_dev(qq, dev),
            torch.stack([lv._pack_dev(s, dev) for s in c]),
            torch.from_numpy(lv.chain_poses([c])[0]).to(dev), None,
            center, seq) for qq, c in pairs])

    ref, n_eager, g_eager = _counted(eager_chain)
    got, n, g = _counted(lambda: lv.dispatch_chain_matches(seq, pairs, pool))
    assert (n, g) == (n_eager, g_eager)
    assert torch.equal(got, ref)
    assert all(p.graph is not None for p in seq._programs.values())


@pytest.mark.cuda
def test_failed_capture_raises(mapped, monkeypatch):
    """A match that reads the device from the host cannot be captured:
    the call raises, no program is kept, and nothing runs it eagerly
    instead."""
    mapper, scans, _ = mapped
    m = mapper.sequential_matcher
    match = Matcher._match

    def syncing(self, pts, *args, **kw):
        float(pts[0, 0])
        return match(self, pts, *args, **kw)

    monkeypatch.setattr(Matcher, "_match", syncing)
    mc.reset_launch_counts()
    with pytest.raises(RuntimeError):
        m.match_scan(scans[30], scans[20:30])
    assert not m._programs
    assert not any(mc.LAUNCHES.values())


@pytest.mark.cuda
def test_warm_async_captures_beside_a_classic_session(cuda_device, caplog):
    """warm_async's thread captures the classic session's programs while
    the session's thread maps its first scans: the thread ends without a
    fault, every program it left is captured, and the poses are a cold
    session's bit for bit."""
    cfg, laser, data = _workload()

    def session():
        return SlamSession(cfg, laser, device=cuda_device)

    warm, cold = session(), session()
    t = warm.warm_async()
    for sess in (warm, cold):
        for i, (scan, _) in enumerate(data):
            sess.process_scan(scan.ranges, scan.odom_pose, time=i * 0.1)
        sess.flush()
    t.join(timeout=120)
    assert not t.is_alive()
    assert not [r for r in caplog.records if "warming failed" in r.message]
    progs = warm.mapper.sequential_matcher._programs
    assert progs and all(p.graph is not None for p in progs.values())
    np.testing.assert_array_equal(warm.trajectory, cold.trajectory)
