"""The reference's per-event programs in the port: the match, the fused loop
verify and the near-chain matches as programs on static buffers
(slam_toolbox_tpu_torch/kernels/match_cuda.py Program; CUDA graphs on a
card, the same function run eagerly here), on the CPU:

- chains padded to a bucket (CHAIN_BUCKETS, one chain past 128 members)
  give the unpadded rows bit for bit, and the JAX package's
  _loop_verify_jit / _chain_match_jit rows within test_torch_loop_verify.py's
  bounds;
- matches through the static buffers equal fresh-tensor matches across a
  sequence that changes the base-point bucket, penalize and refine;
- three matches in flight before collect_batch equal three single ones,
  and no result shares storage with another or with a static buffer;
- a pool that grows forces a new capture key;
- warm_all makes the programs of the buckets a session meets first;
- a replay counts its tally once, and returns a copy of the output.

test_torch_program_graph_card.py holds the graphs to the eager route on a
card. Geometry: G 131 (sequential) and 161 (loop), 181 beams."""
import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_toolbox_tpu.core.scan import LaserConfig
from slam_toolbox_tpu.io.dataset import LidarSimulator, SegmentWorld
from slam_toolbox_tpu.kernels import loop_verify as jlv
from slam_toolbox_tpu.kernels.match import Matcher as JaxMatcher
from slam_toolbox_tpu.mapper.streaming import PackPool as JaxPool
from slam_toolbox_tpu.mapper.streaming import scan_pack as jax_pack
from slam_toolbox_tpu_torch.api import SlamSession
from slam_toolbox_tpu_torch.core.params import MapperConfig
from slam_toolbox_tpu_torch.core.scan import LocalizedScan as TorchScan
from slam_toolbox_tpu_torch.interop import laser_from_dict
from slam_toolbox_tpu_torch.kernels import loop_verify as tlv
from slam_toolbox_tpu_torch.kernels import match_cuda as mc
from slam_toolbox_tpu_torch.kernels.match import Matcher as TorchMatcher
from slam_toolbox_tpu_torch.kernels.match import _scan_device_cache
from slam_toolbox_tpu_torch.mapper import streaming
from slam_toolbox_tpu_torch.mapper.streaming import PackPool, scan_pack
from test_torch_loop_verify import GATES, WP, _assert_rows_close

CPU = torch.device("cpu")
RTH = 3.0
# chains as scan index lists: near chains, a loop candidate, and one of
# 130 members (past the 128 bucket, padded to 256)
LONG = list(range(0, 70)) + list(range(0, 60))
CHAINS = [list(range(2, 12)), list(range(0, 6)), list(range(6, 40)), LONG]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(search):
    return dict(
        search_size=search, resolution=0.05, smear_deviation=0.1,
        range_threshold=RTH, coarse_angle_offset=np.deg2rad(10),
        coarse_angle_resolution=np.deg2rad(2),
        fine_angle_offset=np.deg2rad(0.2), dist_var_penalty=0.09,
        ang_var_penalty=0.1218, min_dist_penalty=0.5, min_ang_penalty=0.9,
    )


@pytest.fixture(scope="module")
def case():
    """Both packages' scans of one simulated run and their sequential (G
    131) and loop (G 161) matchers."""
    laser = LaserConfig(min_range=0.05, max_range=10.0, range_threshold=RTH,
                        angular_resolution=np.deg2rad(2.0))
    tlaser = laser_from_dict(dataclasses.asdict(laser))
    sim = LidarSimulator(SegmentWorld.rooms(16.0, 10.0), laser,
                         range_noise=0.01, odom_noise=(0.0, 0.0), seed=3)
    jscans, tscans = [], []
    for i, (scan, _) in enumerate(sim.simulate(np.array(WP), step=0.5)):
        t = TorchScan(tlaser, scan.ranges, scan.odom_pose)
        t.set_corrected_pose(scan.corrected_pose)
        for s in (scan, t):
            s.state_id = s.unique_id = i
        jscans.append(scan)
        tscans.append(t)
    assert len(tscans) >= 70
    out = dict(laser=laser, tlaser=tlaser, jscans=jscans, tscans=tscans,
               jseq=JaxMatcher(**_kw(0.5)), jloop=JaxMatcher(**_kw(2.0)),
               tseq=TorchMatcher(**_kw(0.5), device=CPU),
               tloop=TorchMatcher(**_kw(2.0), device=CPU))
    assert (out["tseq"].G, out["tloop"].G) == (131, 161)
    return out


def _pool(case, monkeypatch, cap=128):
    monkeypatch.setattr(streaming, "POOL_CAP", cap)
    pool = PackPool(case["laser"].n_beams, CPU)
    scans = case["tscans"]
    pool.append_batch(torch.from_numpy(np.stack([scan_pack(s)
                                                 for s in scans])), scans)
    return pool


def _unpadded_verify(case, query, chains):
    """Each chain at its own length, no slot mask, on fresh tensors."""
    local, finite = _scan_device_cache(query, CPU)
    center = torch.from_numpy(np.asarray(query.sensor_pose, np.float32))
    rows = []
    for c in chains:
        packs = torch.from_numpy(np.stack([scan_pack(s) for s in c]))
        poses = torch.from_numpy(tlv.chain_poses([c])[0])
        rows.append(tlv._loop_verify_impl(
            packs, poses, None, local, finite, center, tlv._gates(GATES),
            case["tloop"], case["tseq"]))
    return torch.stack(rows).numpy()


def _unpadded_chain(case, pairs):
    rows = []
    for q, c in pairs:
        packs = torch.from_numpy(np.stack([scan_pack(s) for s in c]))
        poses = torch.from_numpy(tlv.chain_poses([c])[0])
        center = torch.from_numpy(np.asarray(q.sensor_pose, np.float32))
        rows.append(tlv._chain_match_impl(
            torch.from_numpy(scan_pack(q)), packs, poses, None, center,
            case["tseq"]))
    return torch.stack(rows).numpy()


def test_chain_bucket_is_the_reference_s():
    for n in (1, 15, 16, 17, 64, 65, 128, 129, 256, 257, 1000):
        assert tlv.chain_bucket(n) == jlv.chain_bucket(n), n
    assert tlv.CHAIN_BUCKETS == jlv.CHAIN_BUCKETS


@pytest.mark.parametrize("pooled", [False, True])
def test_padded_verify_rows(case, monkeypatch, pooled):
    """The fused verify of four chains (buckets 16, 16, 64 and 256),
    pooled and not: bit-equal to each chain unpadded, and within the
    bounds of test_torch_loop_verify.py of the JAX program's rows."""
    scans = case["tscans"]
    query = scans[-1]
    chains = [[scans[i] for i in c] for c in CHAINS]
    pool = _pool(case, monkeypatch) if pooled else None
    got = tlv.dispatch_loop_verify(case["tloop"], case["tseq"], query,
                                   chains, GATES, pool=pool).numpy()
    np.testing.assert_array_equal(got, _unpadded_verify(case, query, chains))
    keys = {k[3] for k in case["tseq"]._programs if k[0] == "verify"}
    assert {16, 64, 256} <= keys
    if pooled:
        return
    js = case["jscans"]
    ref = np.asarray(jlv.dispatch_loop_verify(
        case["jloop"], case["jseq"], js[-1],
        [[js[i] for i in c] for c in CHAINS], GATES), np.float64)
    assert got.shape == ref.shape == (len(CHAINS), 27)
    assert got[0, 26] == 1.0   # the fine stage is exercised
    _assert_rows_close(got.astype(np.float64), ref)


def test_padded_chain_match_rows(case, monkeypatch):
    """Near-chain matches of four pairs (one chain of 130 members):
    bit-equal to each pair unpadded, and within the bounds of
    test_torch_loop_verify.py of the JAX program's rows."""
    pool = _pool(case, monkeypatch)
    scans = case["tscans"]
    qs = [-1, -2, 30, 69]
    pairs = [(scans[q], [scans[i] for i in c]) for q, c in zip(qs, CHAINS)]
    got = tlv.dispatch_chain_matches(case["tseq"], pairs, pool).numpy()
    np.testing.assert_array_equal(got, _unpadded_chain(case, pairs))

    js = case["jscans"]
    jpool = JaxPool(case["laser"].n_beams, cap=128)
    jpool.append_batch(jnp.asarray(np.stack([jax_pack(s) for s in js])), js)
    ref = np.asarray(jnp.concatenate(jlv.dispatch_chain_matches(
        case["jseq"], [(js[q], [js[i] for i in c])
                       for q, c in zip(qs, CHAINS)], jpool)), np.float64)
    got = got.astype(np.float64)
    assert got.shape == ref.shape == (len(pairs), 13)
    np.testing.assert_allclose(got[:, 0], ref[:, 0], atol=1e-6)
    np.testing.assert_allclose(got[:, 1:4], ref[:, 1:4], atol=1e-5)
    np.testing.assert_allclose(got[:, 4:], ref[:, 4:], rtol=1e-4, atol=1e-6)


def test_spec_routes_read_the_ring(case, monkeypatch):
    """The speculative verify and near-chain matches, their centers read
    from a result ring on the device: rows bit-equal to the dispatches'
    at those centers, and the echo's head is the ring."""
    pool = _pool(case, monkeypatch)
    scans = case["tscans"]
    chains = [[scans[i] for i in c] for c in CHAINS[:3]]
    results = torch.zeros((8, 13))
    q = scans[-1]
    results[5, 1:4] = torch.from_numpy(np.asarray(q.sensor_pose,
                                                  np.float32))
    rows, snap = tlv.dispatch_loop_verify_spec(
        case["tloop"], case["tseq"], q, 5, chains, GATES, pool, results)
    ref = tlv.dispatch_loop_verify(case["tloop"], case["tseq"], q, chains,
                                   GATES, pool=pool).numpy()
    np.testing.assert_array_equal(rows.numpy(), ref)
    assert all(np.array_equal(a, b)
               for a, b in zip(snap, tlv.chain_poses(chains)))
    echo, _ = tlv.dispatch_chain_matches_spec(
        case["tseq"], [(q, 5, c) for c in chains], pool, results)
    assert torch.equal(echo[:8], results)
    np.testing.assert_array_equal(
        echo[8:].numpy(),
        tlv.dispatch_chain_matches(case["tseq"], [(q, c) for c in chains],
                                   pool).numpy())


def test_pool_growth_recaptures(case, monkeypatch):
    """A pool that grows has new storage: the next near-chain match
    makes its program again under a new key, and the rows stay those of
    the unpadded match."""
    monkeypatch.setattr(streaming, "POOL_CAP", 16)
    scans = []   # scans no other pool has given a slot
    for s in case["tscans"]:
        t = TorchScan(s.laser, s.ranges, s.odom_pose)
        t.set_corrected_pose(s.corrected_pose)
        scans.append(t)
    seq = TorchMatcher(**_kw(0.5), device=CPU)
    pool = PackPool(case["laser"].n_beams, CPU)
    pool.append_batch(torch.from_numpy(np.stack(
        [scan_pack(s) for s in scans[:14]])), scans[:14])
    pairs = [(scans[13], scans[2:12])]
    rows = tlv.dispatch_chain_matches(seq, pairs, pool).numpy()
    first = seq._programs[("chain", 16, pool.B)]
    assert first.storage == tlv._pool_storage(pool)
    far = [(scans[40], scans[30:40])]   # scans 30-39 pooled on demand
    rows_far = tlv.dispatch_chain_matches(seq, far, pool).numpy()
    assert pool.cap == 32
    second = seq._programs[("chain", 16, pool.B)]
    assert second is not first and second.storage != first.storage
    assert second.storage == tlv._pool_storage(pool)
    np.testing.assert_array_equal(rows_far, _unpadded_chain(case, far))
    np.testing.assert_array_equal(
        tlv.dispatch_chain_matches(seq, pairs, pool).numpy(), rows)
    assert seq._programs[("chain", 16, pool.B)] is second


def test_static_buffers_equal_fresh_tensors(case):
    """One matcher's matches through its programs' static buffers against
    the same matches on fresh tensors, bit for bit, over a sequence that
    moves the base-point bucket (1,024 to 8,192 points), penalize and
    refine; one program per (P, B, penalize, refine)."""
    scans = case["tscans"]
    m = TorchMatcher(**_kw(0.5), device=CPU)
    seq = [(1, True, True), (12, False, True), (6, True, False),
           (25, True, True), (1, False, False), (12, False, True)]
    for n, penalize, refine in seq:
        q = scans[n + 1]
        center = np.asarray(q.sensor_pose, np.float64)
        base = scans[1:n + 1]
        got = m._dispatch(q, base, center, penalize, refine)
        ref = m._dispatch_eager(q, base, center, penalize, refine)
        assert torch.equal(got, ref), (n, penalize, refine)
    B = case["laser"].n_beams
    assert set(m._programs) == {
        ("match", 1024, B, True, True), ("match", 4096, B, False, True),
        ("match", 2048, B, True, False), ("match", 8192, B, True, True),
        ("match", 1024, B, False, False)}


def test_batch_in_flight_equals_singles(case):
    """Three base sets dispatched before collect_batch equal three single
    match_scans: no result aliases another or a program's buffers."""
    scans = case["tscans"]
    m = TorchMatcher(**_kw(0.5), device=CPU)
    q = scans[20]
    bases = [scans[10:20], scans[12:19], scans[5:15]]
    packs = m.dispatch_scans_batch(q, bases)
    prog = m._programs[("match", 2048, case["laser"].n_beams, True, True)]
    static = {t.data_ptr() for t in prog.inputs.values()}
    ptrs = [p.data_ptr() for p in packs]
    assert len(set(ptrs)) == 3 and not static & set(ptrs)
    got = TorchMatcher.collect_batch(packs)
    for res, base in zip(got, bases):
        ref = m.match_scan(q, base)
        assert res.response == ref.response
        np.testing.assert_array_equal(res.sensor_pose, ref.sensor_pose)
        np.testing.assert_array_equal(res.covariance, ref.covariance)


def test_warm_all_makes_the_first_buckets(case):
    """warm_all on a streaming session makes the sequential match's
    programs at each running-buffer length's bucket (penalized) and the
    full buffer's (unpenalized), the loop coarse match's, and the verify
    and near-chain programs at chain bucket 16 on the session's pool;
    nothing is counted."""
    cfg = MapperConfig(scan_buffer_size=10, loop_match_minimum_chain_size=5,
                       correlation_search_space_dimension=0.5,
                       correlation_search_space_resolution=0.05,
                       correlation_search_space_smear_deviation=0.1,
                       loop_search_space_dimension=2.0,
                       loop_search_space_resolution=0.05)
    sess = SlamSession(cfg, case["tlaser"], device="cpu", streaming=True,
                       drain_every=8)
    before = dict(mc.LAUNCHES)
    sess.warm_all()
    assert dict(mc.LAUNCHES) == before
    seq = sess.mapper.sequential_matcher
    loop = sess.mapper.loop_matcher
    B = case["laser"].n_beams
    keys = set(seq._programs)
    assert {("match", P, B, True, True) for P in (1024, 2048)} <= keys
    assert ("match", 2048, B, False, True) in keys
    assert set(loop._programs) == {("match", 1024, B, False, False)}
    pool = sess._pipe.pack_pool
    assert seq._programs[("chain", 16, B)].storage == tlv._pool_storage(pool)
    assert any(k[0] == "verify" and k[1] is loop and k[3:] == (16, B, True)
               for k in keys)


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.fixture
def launch_counts():
    saved = dict(mc.LAUNCHES), dict(mc.GRID_LAUNCHES)
    mc.reset_launch_counts()
    yield
    mc.reset_launch_counts()
    mc.LAUNCHES.update(saved[0])
    mc.GRID_LAUNCHES.update(saved[1])


def test_replay_counts_its_tally(launch_counts):
    """Each run of a captured program replays its graph once, counts its
    tally once, and returns a copy of the graph's output (or writes it
    into `out`); uncounted() suppresses the counts."""
    prog = object.__new__(mc.Program)
    prog.graph = _FakeGraph()
    prog.tally = {("scatter_occupancy", 2051): 1,
                  ("smear_quantize", 2051): 1, ("score_windows", 2051): 1}
    prog.out = torch.arange(13, dtype=torch.float32)
    prog.replays = 0
    outs = [prog.run() for _ in range(3)]
    dst = torch.zeros(13)
    assert prog.run(out=dst) is dst and torch.equal(dst, prog.out)
    assert prog.graph.replays == prog.replays == 4
    assert all(o.data_ptr() != prog.out.data_ptr() for o in outs)
    assert mc.LAUNCHES["score_windows"] == mc.LAUNCHES["smear_quantize"] == 4
    assert mc.GRID_LAUNCHES[("scatter_occupancy", 2051)] == 4
    with mc.uncounted():
        prog.run()
    assert mc.LAUNCHES["score_windows"] == 4 and prog.replays == 5


def test_cpu_program_runs_eagerly(case):
    """On the CPU a program is its function on its static buffers: no
    graph, and the output is the function's own tensor."""
    seen = []

    def fn(x):
        seen.append(x)
        return x * 2

    prog = mc.Program(fn, {"x": torch.ones(4)})
    assert prog.graph is None
    prog.inputs["x"].fill_(3.0)
    assert torch.equal(prog.run(), torch.full((4,), 6.0))
    assert seen[-1] is prog.inputs["x"]


def test_gates_key_the_verify_program(case, monkeypatch):
    """Other gates are another program: a config's thresholds are
    constants of the captured verify."""
    scans = case["tscans"]
    m_seq = TorchMatcher(**_kw(0.5), device=CPU)
    chain = [scans[2:12]]
    other = SimpleNamespace(loop_match_minimum_response_coarse=0.9,
                            loop_match_maximum_variance_coarse=0.01)
    a = tlv.dispatch_loop_verify(case["tloop"], m_seq, scans[-1], chain,
                                 GATES).numpy()
    b = tlv.dispatch_loop_verify(case["tloop"], m_seq, scans[-1], chain,
                                 other).numpy()
    assert a[0, 26] == 1.0 and b[0, 26] == 0.0
    np.testing.assert_array_equal(a[:, :26], b[:, :26])
    assert len([k for k in m_seq._programs if k[0] == "verify"]) == 2
