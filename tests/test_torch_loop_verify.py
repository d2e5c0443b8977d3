"""The port's fused loop verify and pool-gathered near-chain matches
(slam_toolbox_tpu_torch/kernels/loop_verify.py) against the JAX package's
on the CPU, and against the port's own staged path, on the JAX tests'
scenario (tests/test_loop_verify.py): 2-degree beams, a 0.02 m sequential
and a 0.05 m loop matcher, scans of one seed at their true poses."""
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
from slam_toolbox_tpu_torch.core.scan import LocalizedScan as TorchScan
from slam_toolbox_tpu_torch.interop import laser_from_dict
from slam_toolbox_tpu_torch.kernels import loop_verify as tlv
from slam_toolbox_tpu_torch.kernels.match import Matcher as TorchMatcher
from slam_toolbox_tpu_torch.mapper import streaming
from slam_toolbox_tpu_torch.mapper.streaming import PackPool, scan_pack

CPU = torch.device("cpu")
GATES = SimpleNamespace(loop_match_minimum_response_coarse=0.2,
                        loop_match_maximum_variance_coarse=5.0)
WP = [(-6.0, -3.5), (1.5, -3.5), (5.5, -3.5), (5.5, 0.5), (5.5, 3.5),
      (1.0, 3.5), (-3.0, 3.5), (-6.0, 3.0), (-6.5, -1.0), (-6.0, -3.5)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(search, res, rth):
    return dict(
        search_size=search, resolution=res, smear_deviation=0.03,
        range_threshold=rth, coarse_angle_offset=np.deg2rad(10),
        coarse_angle_resolution=np.deg2rad(2),
        fine_angle_offset=np.deg2rad(0.2), dist_var_penalty=0.09,
        ang_var_penalty=0.1218, min_dist_penalty=0.5, min_ang_penalty=0.9,
    )


@pytest.fixture(scope="module")
def case():
    """The JAX scans, the port's scans of the same ranges and poses, and
    both packages' sequential and loop matchers."""
    laser = LaserConfig(min_range=0.05, max_range=10.0, range_threshold=8.0,
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
    rth = laser.range_threshold
    return dict(
        laser=laser, jscans=jscans, tscans=tscans,
        jseq=JaxMatcher(**_kw(0.3, 0.02, rth)),
        jloop=JaxMatcher(**_kw(2.0, 0.05, rth)),
        tseq=TorchMatcher(**_kw(0.3, 0.02, rth), device=CPU),
        tloop=TorchMatcher(**_kw(2.0, 0.05, rth), device=CPU),
    )


CHAINS = [(2, 12), (0, 6), (6, 14), (30, 40)]


def _chains(scans):
    return [scans[a:b] for a, b in CHAINS]


def _assert_rows_close(got, ref):
    """27-float verify rows: the gate bit equal; responses, poses and
    covariances of both passes within f32 raster tolerances."""
    np.testing.assert_array_equal(got[:, 26], ref[:, 26])
    for lo in (0, 13):
        np.testing.assert_allclose(got[:, lo], ref[:, lo], atol=1e-6)
        np.testing.assert_allclose(got[:, lo + 1:lo + 4],
                                   ref[:, lo + 1:lo + 4], atol=1e-5)
        np.testing.assert_allclose(got[:, lo + 4:lo + 13],
                                   ref[:, lo + 4:lo + 13], rtol=1e-4,
                                   atol=1e-6)


def test_fused_rows_match_jax(case):
    """dispatch_loop_verify of four candidate chains (one far from the
    query): the port's rows against the JAX program's."""
    query_j, query_t = case["jscans"][-1], case["tscans"][-1]
    ref = np.asarray(jlv.dispatch_loop_verify(
        case["jloop"], case["jseq"], query_j, _chains(case["jscans"]),
        GATES), np.float64)
    got = np.asarray(tlv.dispatch_loop_verify(
        case["tloop"], case["tseq"], query_t, _chains(case["tscans"]),
        GATES).numpy(), np.float64)
    assert got.shape == ref.shape == (len(CHAINS), 27)
    assert got[0, 26] == 1.0  # the fine stage is exercised
    _assert_rows_close(got, ref)


def test_fused_matches_staged(case):
    """The port's fused verify against its own staged path: coarse
    match_scans_batch at the loop matcher, the gates on the host, the fine
    match_scan seeded at the coarse pose."""
    query = case["tscans"][-1]
    chain = case["tscans"][2:12]
    coarse = case["tloop"].match_scans_batch(query, [chain], penalize=False,
                                             refine=False)[0]
    gate = (coarse.response > GATES.loop_match_minimum_response_coarse
            and coarse.covariance[0, 0]
            < GATES.loop_match_maximum_variance_coarse
            and coarse.covariance[1, 1]
            < GATES.loop_match_maximum_variance_coarse)
    tmp = TorchScan(query.laser, query.ranges, query.odom_pose, query.time)
    tmp.set_corrected_pose(query.corrected_pose)
    tmp.set_sensor_pose(coarse.sensor_pose)
    fine = case["tseq"].match_scan(tmp, chain, penalize=False)

    rows = np.asarray(tlv.dispatch_loop_verify(
        case["tloop"], case["tseq"], query, [chain], GATES).numpy(),
        np.float64)
    got_c = TorchMatcher.results_from_packed(rows[0, :13])[0]
    got_f = TorchMatcher.results_from_packed(rows[0, 13:26])[0]
    assert gate and rows[0, 26] > 0.5
    np.testing.assert_allclose(got_c.response, coarse.response, atol=1e-6)
    np.testing.assert_allclose(got_c.sensor_pose, coarse.sensor_pose,
                               atol=1e-5)
    np.testing.assert_allclose(got_c.covariance, coarse.covariance,
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got_f.response, fine.response, atol=1e-6)
    np.testing.assert_allclose(got_f.sensor_pose, fine.sensor_pose, atol=1e-5)


def test_pooled_and_chunked_rows_equal_upload(case, monkeypatch):
    """Chains gathered from a PackPool (grown once on the way) and the
    chunked dispatch give the rows of the per-scan upload path."""
    query, scans = case["tscans"][-1], case["tscans"]
    chains = _chains(scans)
    ref = tlv.dispatch_loop_verify(case["tloop"], case["tseq"], query, chains,
                                   GATES).numpy()
    monkeypatch.setattr(streaming, "POOL_CAP", 16)
    monkeypatch.setattr(tlv, "CHUNK", 3)
    pool = PackPool(case["laser"].n_beams, CPU)
    pool.append_batch(torch.from_numpy(np.stack(
        [scan_pack(s) for s in scans[:14]])), scans[:14])
    assert pool.cap == 16
    got = tlv.dispatch_loop_verify(case["tloop"], case["tseq"], query, chains,
                                   GATES, pool=pool).numpy()
    assert pool.cap == 32   # scans 30-39 were pooled on demand
    np.testing.assert_array_equal(got, ref)
    blocks = tlv.dispatch_loop_verify_chunked(
        case["tloop"], case["tseq"], query, chains, GATES, pool=pool)
    assert [len(sl) for _, sl in blocks] == [3, 1]
    np.testing.assert_array_equal(
        np.concatenate([rows.numpy() for rows, _ in blocks]), ref)


def test_chain_matches_match_jax(case, monkeypatch):
    """dispatch_chain_matches (near-chain matches gathered from the pool,
    unpenalized, refined) against the JAX package's program."""
    pairs = [(-1, 0, 6), (-2, 3, 9), (-1, 6, 12), (30, 14, 24)]
    out = {}
    for side in ("j", "t"):
        scans = case[f"{side}scans"]
        packs = np.stack([scan_pack(s) if side == "t" else jax_pack(s)
                          for s in scans])
        if side == "j":
            pool = JaxPool(case["laser"].n_beams, cap=64)
            pool.append_batch(jnp.asarray(packs), scans)
            rows = jlv.dispatch_chain_matches(
                case["jseq"], [(scans[q], scans[a:b]) for q, a, b in pairs],
                pool)
            out[side] = np.asarray(jnp.concatenate(rows), np.float64)
        else:
            monkeypatch.setattr(streaming, "POOL_CAP", 64)
            pool = PackPool(case["laser"].n_beams, CPU)
            pool.append_batch(torch.from_numpy(packs), scans)
            out[side] = tlv.dispatch_chain_matches(
                case["tseq"], [(scans[q], scans[a:b]) for q, a, b in pairs],
                pool).numpy().astype(np.float64)
    got, ref = out["t"], out["j"]
    assert got.shape == ref.shape == (len(pairs), 13)
    np.testing.assert_allclose(got[:, 0], ref[:, 0], atol=1e-6)
    np.testing.assert_allclose(got[:, 1:4], ref[:, 1:4], atol=1e-5)
    np.testing.assert_allclose(got[:, 4:], ref[:, 4:], rtol=1e-4, atol=1e-6)
    assert (got[:, 0] > 0.1).all()
