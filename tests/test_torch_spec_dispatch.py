"""The port's speculative dispatches (slam_toolbox_tpu_torch/kernels/
loop_verify.py): the near-chain matches and the fused loop verify whose
centers are read on the device from a drain batch's result ring. Their
rows equal the non-speculative path's bit for bit, and the JAX package's
speculative programs' within the tolerances of test_torch_loop_verify.py,
on its scenario (2-degree beams, a 0.02 m sequential and a 0.05 m loop
matcher, scans of one seed at their true poses)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_toolbox_tpu.kernels import loop_verify as jlv
from slam_toolbox_tpu.mapper.streaming import PackPool as JaxPool
from slam_toolbox_tpu.mapper.streaming import scan_pack as jax_pack
from slam_toolbox_tpu_torch.core.scan import LocalizedScan as TorchScan
from slam_toolbox_tpu_torch.kernels import loop_verify as tlv
from slam_toolbox_tpu_torch.mapper import streaming
from slam_toolbox_tpu_torch.mapper.streaming import PackPool, scan_pack
from test_torch_loop_verify import (  # noqa: F401 (fixtures)
    CPU, GATES, _assert_rows_close, _chains, _one_thread, case,
)

PAIRS = [(-1, 0, 6), (-2, 3, 9), (-1, 6, 12), (30, 14, 24)]
RING = 24   # result-ring rows; pair p's query sits at row 3 + 5 p


def _ring(queries):
    """A result ring whose row 3 + 5 p holds query p's f32 sensor pose as
    the batch writes it (response, mean, covariance)."""
    ring = np.zeros((RING, 13), np.float32)
    for p, q in enumerate(queries):
        ring[3 + 5 * p, 0] = 0.5
        ring[3 + 5 * p, 1:4] = q.sensor_pose
        ring[3 + 5 * p, 4:13] = np.eye(3).reshape(-1)
    return ring


def _port_pool(scans, monkeypatch):
    monkeypatch.setattr(streaming, "POOL_CAP", 64)
    pool = PackPool(len(scans[0].ranges), CPU)
    pool.append_batch(torch.from_numpy(
        np.stack([scan_pack(s) for s in scans])), scans)
    return pool


def _jax_pool(scans):
    pool = JaxPool(len(scans[0].ranges), cap=64)
    pool.append_batch(jnp.asarray(np.stack([jax_pack(s) for s in scans])),
                      scans)
    return pool


def _blinded(scan, laser):
    """The scan with every seventh beam out of range (inf) and every
    eleventh lost (NaN): the query's pack zeroes those beams where the
    non-speculative path's device cache holds NaN -> 0 and inf -> f32 max."""
    ranges = scan.ranges.copy()
    ranges[::7] = np.inf
    ranges[::11] = np.nan
    t = TorchScan(laser, ranges, scan.odom_pose)
    t.set_corrected_pose(scan.corrected_pose)
    t.state_id = t.unique_id = 1000
    return t


def test_chain_spec_rows_equal_dispatch_and_jax(case, monkeypatch):
    """dispatch_chain_matches_spec's echo: the ring unchanged, then one
    row per pair, bit-equal to dispatch_chain_matches' rows; the chains'
    f32 poses beside it; the rows against the JAX echo program's."""
    tscans, jscans = case["tscans"], case["jscans"]
    pool = _port_pool(tscans, monkeypatch)
    tq = [tscans[q] for q, _, _ in PAIRS]
    ring = torch.from_numpy(_ring(tq))
    spairs = [(tscans[q], 3 + 5 * p, tscans[a:b])
              for p, (q, a, b) in enumerate(PAIRS)]
    echo, snap = tlv.dispatch_chain_matches_spec(case["tseq"], spairs, pool,
                                                 ring)
    ref = tlv.dispatch_chain_matches(
        case["tseq"], [(q, c) for q, _, c in spairs], pool)
    assert echo.shape == (RING + len(PAIRS), 13)
    assert torch.equal(echo[:RING], ring)
    assert torch.equal(echo[RING:], ref)
    for got, (_, _, c) in zip(snap, spairs):
        np.testing.assert_array_equal(
            got, np.stack([s.sensor_pose for s in c]).astype(np.float32))

    jpool = _jax_pool(jscans)
    jecho = jlv.dispatch_chain_matches_spec(
        case["jseq"], [(jscans[q], 3 + 5 * p, jscans[a:b])
                       for p, (q, a, b) in enumerate(PAIRS)],
        jpool, jnp.asarray(_ring([jscans[q] for q, _, _ in PAIRS])))
    jrows = np.asarray(jecho, np.float64)[RING:RING + len(PAIRS)]
    got = echo[RING:].numpy().astype(np.float64)
    np.testing.assert_allclose(got[:, 0], jrows[:, 0], atol=1e-6)
    np.testing.assert_allclose(got[:, 1:4], jrows[:, 1:4], atol=1e-5)
    np.testing.assert_allclose(got[:, 4:], jrows[:, 4:], rtol=1e-4,
                               atol=1e-6)
    assert (got[:, 0] > 0.1).all()


@pytest.mark.parametrize("blind", [False, True], ids=["clean", "inf-nan"])
def test_loop_spec_rows_equal_dispatch_and_jax(case, monkeypatch, blind):
    """dispatch_loop_verify_spec with the query's center in the ring and
    its points from its pool slot: rows bit-equal to dispatch_loop_verify's
    (also for a query with out-of-range and lost beams), the chains' f32
    poses beside them; and the rows against the JAX speculative program's."""
    tscans, jscans = case["tscans"], case["jscans"]
    query = tscans[-1]
    if blind:
        query = _blinded(query, tscans[0].laser)
    pool = _port_pool(tscans + [query], monkeypatch)
    ring = torch.from_numpy(_ring([query]))
    chains = _chains(tscans)
    rows, snap = tlv.dispatch_loop_verify_spec(
        case["tloop"], case["tseq"], query, 3, chains, GATES, pool, ring)
    ref = tlv.dispatch_loop_verify(case["tloop"], case["tseq"], query, chains,
                                   GATES, pool=pool).numpy()
    got = rows.numpy()
    assert got.shape == (len(chains), 27) and got[0, 26] == 1.0
    np.testing.assert_array_equal(got, ref)
    for s, c in zip(snap, chains):
        np.testing.assert_array_equal(
            s, np.stack([sc.sensor_pose for sc in c]).astype(np.float32))
    if blind:
        return
    jpool = _jax_pool(jscans)
    jrows, jsnap = jlv.dispatch_loop_verify_spec(
        case["jloop"], case["jseq"], jscans[-1], 3, _chains(jscans), GATES,
        jpool, jnp.asarray(_ring([jscans[-1]])))
    _assert_rows_close(got.astype(np.float64), np.asarray(jrows, np.float64))
    for ci, c in enumerate(snap):
        np.testing.assert_array_equal(c, jsnap[ci, :len(c)])


def test_spec_dispatches_return_none_instead_of_raising(case, monkeypatch):
    """Where the commit must take the normal path the speculative
    dispatches return None: more pairs than PAIR_CHUNK, a scan the pool
    cannot hold (another beam count), no pool. The non-speculative
    dispatch raises for that scan."""
    tscans = case["tscans"]
    pool = _port_pool(tscans, monkeypatch)
    ring = torch.from_numpy(_ring([tscans[-1]]))
    many = [(tscans[-1], 3, tscans[0:6])] * (tlv.PAIR_CHUNK + 1)
    assert tlv.dispatch_chain_matches_spec(case["tseq"], many, pool,
                                           ring) is None
    assert tlv.dispatch_chain_matches_spec(case["tseq"], many[:1], None,
                                           ring) is None
    # a scan with one beam fewer than the pool's
    odd = TorchScan(tscans[0].laser, tscans[5].ranges[:-1],
                    tscans[5].odom_pose)
    chain = tscans[0:4] + [odd]
    assert tlv.dispatch_chain_matches_spec(
        case["tseq"], [(tscans[-1], 3, chain)], pool, ring) is None
    assert tlv.dispatch_loop_verify_spec(
        case["tloop"], case["tseq"], tscans[-1], 3, [chain], GATES, pool,
        ring) is None
    assert tlv.dispatch_loop_verify_spec(
        case["tloop"], case["tseq"], tscans[-1], 3, [tscans[0:6]], GATES,
        None, ring) is None
    with pytest.raises(ValueError):
        tlv.dispatch_chain_matches(case["tseq"], [(tscans[-1], chain)], pool)
