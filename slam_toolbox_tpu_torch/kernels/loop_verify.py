"""Fused loop-closure verification and pool-gathered near-chain matches.

PyTorch counterpart of slam_toolbox_tpu/kernels/loop_verify.py. For every candidate chain of a loop event the
coarse match at the loop matcher's geometry, the response/variance gates
(Mapper.cpp:1523-1525) and the fine verification at the sequential
matcher's geometry, centered at the coarse pose (the reference's
temporary-scan seeding, Mapper.cpp:1527-1535), run on the device with no
host round trip in between; the host fetches one (n_chains, 27) row
block per event. A chain's world points and FindValidPoints come from
the scans' pack buffers (mapper/streaming.py layout), gathered from the
pipeline's PackPool.

The reference pads chains into size buckets to bound XLA's executable
cache, and skips pad slots on the device; the port runs each real chain
at its own length, so there is no padding to skip. Each chain's row
depends only on its own members and the query, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from slam_toolbox_tpu_torch.device import HostCopy, upload
from slam_toolbox_tpu_torch.kernels.match import (
    _f32, _scan_device_cache, _score_impl,
)
from slam_toolbox_tpu_torch.mapper.streaming import _ring_points, scan_pack

# chains per dispatch of the chunked verify
CHUNK = 8
# most (query, chain) pairs of one speculative near-chain dispatch
PAIR_CHUNK = 16


def _half_span(matcher) -> float:
    return _f32(0.5 * (matcher.G - 1) * matcher.resolution)


def _chain_raster(packs, poses, viewpoint_xy, offset, matcher):
    """World points + device FindValidPoints + raster for a chain of scan
    packs (C, B, 8) at f32 poses (C, 3): the streaming ring raster with
    explicit poses."""
    pts, valid = _ring_points(packs, poses, None, viewpoint_xy)
    return matcher._raster(pts, valid, offset)


def _loop_verify_impl(packs, poses, scan_local, scan_finite, center, gates,
                      loop_matcher, seq_matcher):
    """One chain: returns (27,) = [coarse packed 13 | fine packed 13 |
    gate]."""
    # coarse at the loop matcher's geometry, viewpoint = current pose
    off_l = center[:2] - _half_span(loop_matcher)
    grid_l = _chain_raster(packs, poses, center[:2], off_l, loop_matcher)
    packed_c = _score_impl(
        grid_l, torch.cat([center, off_l]), scan_local, scan_finite,
        penalize=False, refine=False, **loop_matcher._score_args,
    )
    # gates (Mapper.cpp:1523-1525): response and x/y variance, against
    # the f32-rounded thresholds
    gate = (
        (packed_c[0] > gates[0])
        & (packed_c[4] < gates[1])
        & (packed_c[8] < gates[1])
    )
    # fine at the sequential matcher's geometry, centered at the coarse
    # pose (the reference's temporary scan seeding)
    center2 = packed_c[1:4]
    off_s = center2[:2] - _half_span(seq_matcher)
    grid_s = _chain_raster(packs, poses, center2[:2], off_s, seq_matcher)
    packed_f = _score_impl(
        grid_s, torch.cat([center2, off_s]), scan_local, scan_finite,
        penalize=False, refine=True, **seq_matcher._score_args,
    )
    return torch.cat([packed_c, packed_f, gate.to(torch.float32)[None]])


def _loop_verify_scan_impl(packs, poses, lengths, scan_local, scan_finite,
                           center, gates, loop_matcher, seq_matcher):
    """Every candidate chain of one loop event, in order: `packs` (sum C,
    B, 8) and `poses` (sum C, 3) hold the chains back to back, `lengths`
    (host ints) their sizes. Returns the (n_chains, 27) device rows."""
    rows = []
    o = 0
    for n in lengths:
        rows.append(_loop_verify_impl(
            packs[o:o + n], poses[o:o + n], scan_local, scan_finite,
            center, gates, loop_matcher, seq_matcher,
        ))
        o += n
    return torch.stack(rows)


def _chain_match_impl(qpack, packs, poses, center, seq_matcher):
    """One near-chain match (LinkNearChains matches unpenalized,
    Mapper.cpp:1653): the query's pack, the chain's packs and poses, the
    query's sensor pose as the center. Returns the packed (13,) row."""
    local = qpack[:, 0:2]
    finite = (qpack[:, 7].to(torch.int32) & 1) > 0
    off = center[:2] - _half_span(seq_matcher)
    grid = _chain_raster(packs, poses, center[:2], off, seq_matcher)
    return _score_impl(
        grid, torch.cat([center, off]), local, finite,
        penalize=False, refine=True, **seq_matcher._score_args,
    )


def _pooled(pool, scans) -> bool:
    """Seed pool slots for any of `scans` missing one (priors beyond the
    eager seeding cap); False if a scan still has none (its beam count is
    not the pool's)."""
    missing = [s for s in scans if getattr(s, "_pool_slot", None) is None]
    if missing:
        pool.add_scans(missing)
    return all(getattr(s, "_pool_slot", None) is not None for s in missing)


def _ensure_pooled(pool, scans) -> None:
    """_pooled, raising where a scan has no slot."""
    if not _pooled(pool, scans):
        raise ValueError("a scan's beam count differs from the pack pool's")


def chain_poses(chains):
    """Per chain, its members' f32 sensor poses (len, 3): what the device
    rasterizes them at."""
    return [np.asarray([sc.sensor_pose for sc in c], np.float32)
            for c in chains]


def _chain_rows(seq_matcher, pool, queries, chains, center_of):
    """Every (query, chain) pair's near-chain match with packs gathered
    from the pool; `center_of(p)` is pair p's device center. Returns the
    (n_pairs, 13) device rows and the chains' f32 member poses."""
    members = [sc for chain in chains for sc in chain]
    qpacks = pool.gather([q._pool_slot for q in queries])
    cpacks = pool.gather([sc._pool_slot for sc in members])
    snap = chain_poses(chains)
    poses = upload(np.concatenate(snap), pool.device)
    rows = []
    o = 0
    for p, chain in enumerate(chains):
        n = len(chain)
        rows.append(_chain_match_impl(
            qpacks[p], cpacks[o:o + n], poses[o:o + n], center_of(p),
            seq_matcher,
        ))
        o += n
    return torch.stack(rows), snap


def dispatch_chain_matches(seq_matcher, pairs, pool):
    """pairs: list of (query_scan, chain). Runs every pair's match with
    packs gathered from the pool and returns the (n_pairs, 13) device
    rows in pairs order."""
    _ensure_pooled(pool, [q for q, _ in pairs]
                   + [sc for _, chain in pairs for sc in chain])
    centers = upload(np.stack([q.sensor_pose for q, _ in pairs])
                     .astype(np.float32), pool.device)
    rows, _ = _chain_rows(seq_matcher, pool, [q for q, _ in pairs],
                          [c for _, c in pairs], lambda p: centers[p])
    return rows


def dispatch_chain_matches_spec(seq_matcher, pairs, pool, results):
    """Speculative near-chain matches of a drain batch in flight. pairs:
    list of (query_scan, ring_row, chain); `results` is the batch's
    result ring, and pair p's center is results[ring_row, 1:4], read on
    the device. Returns (echo, poses): echo is the (R + n_pairs, 13)
    device tensor of the R ring rows followed by one row per pair, so
    one host copy brings back both; poses, per pair, the chain members'
    f32 poses the rows were computed at. None (no raise) when a scan has
    no pool slot or the batch has more than PAIR_CHUNK pairs: the commit
    then takes the non-speculative path."""
    if pool is None or not pairs or len(pairs) > PAIR_CHUNK:
        return None
    if not _pooled(pool, [q for q, _, _ in pairs]
                   + [sc for _, _, chain in pairs for sc in chain]):
        return None
    rows, snap = _chain_rows(
        seq_matcher, pool, [q for q, _, _ in pairs], [c for _, _, c in pairs],
        lambda p: results[pairs[p][1], 1:4])
    return torch.cat([results, rows]), snap


def _pack_dev(scan, device):
    """Per-scan device-resident pack, uploaded once per scan (the pack is
    sensor-frame, pose-independent); the path for scans outside a pool."""
    dev = getattr(scan, "_pack_dev", None)
    if dev is None or dev.device != device:
        dev = upload(scan_pack(scan), device)
        try:
            scan._pack_dev = dev
        except AttributeError:
            pass
    return dev


def dispatch_loop_verify_chunked(loop_matcher, seq_matcher, scan, chains,
                                 cfg, pool=None):
    """The fused verify as a sequence of <= CHUNK-chain dispatches. The
    reference's TryCloseLoop stops at the first accepted chain and
    re-sweeps with corrected poses (Mapper.cpp:1500-1561), so the finish
    fetches chunks in order and stops at the first acceptance. Gate
    values and acceptance order are those of one dispatch.

    Returns [(HostCopy of the rows, chains_slice), ...]."""
    return [
        (dispatch_loop_verify(loop_matcher, seq_matcher, scan,
                              chains[lo:lo + CHUNK], cfg, pool=pool),
         chains[lo:lo + CHUNK])
        for lo in range(0, len(chains), CHUNK)
    ]


def _gates(cfg):
    return (_f32(cfg.loop_match_minimum_response_coarse),
            _f32(cfg.loop_match_maximum_variance_coarse))


def dispatch_loop_verify_spec(loop_matcher, seq_matcher, scan, ridx, chains,
                              cfg, pool, results):
    """Speculative fused verify of the PREDICTED candidate chains of a
    drain batch's newest scan, launched with the batch: the query's local
    points and finite mask come from its pool slot (the values
    _scan_device_cache uploads), the center from the batch's result ring,
    results[ridx, 1:4], read on the device. Returns (HostCopy of the
    (n_chains, 27) rows, per chain its members' f32 poses) for the commit
    to validate, or None (no raise) when a scan has no pool slot."""
    if pool is None or not chains:
        return None
    members = [sc for c in chains for sc in c]
    if not _pooled(pool, [scan] + members):
        return None
    qpack = pool.gather([scan._pool_slot])[0]
    local = qpack[:, 0:2]
    finite = (qpack[:, 7].to(torch.int32) & 1) > 0
    snap = chain_poses(chains)
    poses = upload(np.concatenate(snap), pool.device)
    packs = pool.gather([sc._pool_slot for sc in members])
    rows = _loop_verify_scan_impl(
        packs, poses, [len(c) for c in chains], local, finite,
        results[ridx, 1:4], _gates(cfg), loop_matcher, seq_matcher,
    )
    return HostCopy(rows), snap


def dispatch_loop_verify(loop_matcher, seq_matcher, scan, chains, cfg,
                         pool=None):
    """Launch the fused verify of every candidate chain of this loop event
    and start the copy of its (n_chains, 27) rows to the host; returns the
    HostCopy. Chain packs are gathered from `pool` (the streaming
    pipeline's PackPool); with no pool they are uploaded once per scan."""
    dev = loop_matcher.device
    center = upload(np.asarray(scan.sensor_pose, np.float32), dev)
    local_dev, finite_dev = _scan_device_cache(scan, dev)
    members = [sc for c in chains for sc in c]
    poses = upload(np.stack([sc.sensor_pose for sc in members])
                   .astype(np.float32), dev)
    if pool is not None:
        _ensure_pooled(pool, members)
        packs = pool.gather([sc._pool_slot for sc in members])
    else:
        packs = torch.stack([_pack_dev(sc, dev) for sc in members])
    rows = _loop_verify_scan_impl(
        packs, poses, [len(c) for c in chains], local_dev, finite_dev,
        center, _gates(cfg), loop_matcher, seq_matcher,
    )
    return HostCopy(rows)
