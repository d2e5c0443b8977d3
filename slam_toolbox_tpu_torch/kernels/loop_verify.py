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

The reference pads chains to size buckets (CHAIN_BUCKETS) and runs an
event's chains as one lax.scan per bucket. Here the verify of one chain,
and the near-chain match of one (query, chain) pair, are each one
program (match_cuda.Program) per (geometry, bucket Cb, beams B) on
static buffers: on a card a CUDA graph captured once and replayed once
per chain or pair, on the CPU the same function run eagerly. A chain
enters as a (Cb, 5) f32 record, per member slot [pool slot, x, y,
heading, live]; pad slots are not live and are masked out of the raster
(ring_points' slot_valid), so a padded chain's row is the unpadded
one's bit for bit, and the host, which knows the chain count, runs no
pad chain. Pooled programs gather the members' packs (and the near-chain
query's) from the pool inside the program, by slot, and are captured
again when the pool's storage moves; without a pool the packs are copied
into the program's static pack buffer. Each chain's row depends only on
its own members and the query, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from slam_toolbox_tpu_torch.device import HostCopy, upload, upload_into
from slam_toolbox_tpu_torch.kernels.match import _f32, _scan_device_cache
from slam_toolbox_tpu_torch.kernels.match import _score_impl
from slam_toolbox_tpu_torch.kernels.step_cuda import ring_points
from slam_toolbox_tpu_torch.mapper.streaming import scan_pack

# chains per dispatch of the chunked verify
CHUNK = 8
# most (query, chain) pairs of one speculative near-chain dispatch
PAIR_CHUNK = 16
# chain-length buckets, the JAX package's: near chains are 10-16 scans,
# loop candidates longer; past 128, multiples of 128
CHAIN_BUCKETS = (16, 64, 128)
_F32 = torch.float32


def chain_bucket(n: int) -> int:
    """The bucket a chain of n scans is padded to."""
    for b in CHAIN_BUCKETS:
        if n <= b:
            return b
    return ((n + 127) // 128) * 128


def _half_span(matcher) -> float:
    return _f32(0.5 * (matcher.G - 1) * matcher.resolution)


def _chain_raster(packs, poses, slot_valid, viewpoint_xy, offset, matcher):
    """World points + device FindValidPoints + raster for a chain of scan
    packs (C, B, 8) at f32 poses (C, 3), slots masked by `slot_valid`
    (C,): the streaming ring raster with explicit poses."""
    pts, valid = ring_points(packs, poses, slot_valid, viewpoint_xy,
                             matcher.G)
    return matcher._raster(pts, valid, offset)


def _loop_verify_impl(packs, poses, slot_valid, scan_local, scan_finite,
                      center, gates, loop_matcher, seq_matcher):
    """One chain: returns (27,) = [coarse packed 13 | fine packed 13 |
    gate]."""
    # coarse at the loop matcher's geometry, viewpoint = current pose
    off_l = center[:2] - _half_span(loop_matcher)
    grid_l = _chain_raster(packs, poses, slot_valid, center[:2], off_l,
                           loop_matcher)
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
    grid_s = _chain_raster(packs, poses, slot_valid, center2[:2], off_s,
                           seq_matcher)
    packed_f = _score_impl(
        grid_s, torch.cat([center2, off_s]), scan_local, scan_finite,
        penalize=False, refine=True, **seq_matcher._score_args,
    )
    return torch.cat([packed_c, packed_f, gate.to(torch.float32)[None]])


def _chain_match_impl(qpack, packs, poses, slot_valid, center, seq_matcher):
    """One near-chain match (LinkNearChains matches unpenalized,
    Mapper.cpp:1653): the query's pack, the chain's packs, poses and slot
    mask, the query's sensor pose as the center. Returns the packed
    (13,) row."""
    local = qpack[:, 0:2]
    finite = (qpack[:, 7].to(torch.int32) & 1) > 0
    off = center[:2] - _half_span(seq_matcher)
    grid = _chain_raster(packs, poses, slot_valid, center[:2], off,
                         seq_matcher)
    return _score_impl(
        grid, torch.cat([center, off]), local, finite,
        penalize=False, refine=True, **seq_matcher._score_args,
    )


def _records(chains, pool) -> np.ndarray:
    """(n_chains, largest bucket, 5) f32 chain records: per member [pool
    slot (0 without a pool), f32 sensor pose, 1]; pad slots all 0 (slot
    0 is the pool's zero row). Slots are exact in f32 below 2**24."""
    cb = max(chain_bucket(len(c)) for c in chains)
    rec = np.zeros((len(chains), cb, 5), np.float32)
    for i, c in enumerate(chains):
        rec[i, :len(c), 1:4] = chain_poses([c])[0]
        rec[i, :len(c), 4] = 1.0
        if pool is not None:
            rec[i, :len(c), 0] = [sc._pool_slot for sc in c]
    return rec


def _by_bucket(chains) -> dict:
    """{chain bucket: the indices of the chains padded to it}."""
    out = {}
    for i, c in enumerate(chains):
        out.setdefault(chain_bucket(len(c)), []).append(i)
    return out


def _pool_storage(pool):
    """What a pooled program captured: the pool and its buffer's storage
    (a pool that grew or compacted has new storage)."""
    return (id(pool), pool.buf.data_ptr(), tuple(pool.buf.shape))


def _zeros(device, *shape, dtype=_F32):
    return torch.zeros(shape, dtype=dtype, device=device)


def _verify_program(loop_matcher, seq_matcher, gates, Cb: int, B: int,
                    pool):
    """The fused verify of one chain of bucket Cb as a program on the
    sequential matcher: static inputs the chain record, the query's local
    points and finite mask, the center; the members' packs gathered from
    `pool` by slot or, with no pool, a static (Cb, B, 8) pack buffer."""
    dev = seq_matcher.device

    def build():
        inputs = dict(chain=_zeros(dev, Cb, 5), local=_zeros(dev, B, 2),
                      finite=_zeros(dev, B, dtype=torch.bool),
                      center=_zeros(dev, 3))
        if pool is None:
            inputs["packs"] = _zeros(dev, Cb, B, 8)

        def fn(chain, local, finite, center, packs=None):
            if packs is None:
                packs = pool.buf.index_select(0, chain[:, 0].long())
            return _loop_verify_impl(
                packs, chain[:, 1:4], chain[:, 4] > 0, local, finite,
                center, gates, loop_matcher, seq_matcher)

        return fn, inputs

    return seq_matcher.program(
        ("verify", loop_matcher, gates, Cb, B, pool is not None), build,
        None if pool is None else _pool_storage(pool))


def _chain_program(seq_matcher, Cb: int, B: int, pool):
    """The near-chain match of one (query, chain) pair of bucket Cb as a
    program on the sequential matcher: static inputs the chain record,
    the query's pool slot and the center; the query's and the members'
    packs gathered from `pool` by slot."""
    dev = seq_matcher.device

    def build():
        inputs = dict(chain=_zeros(dev, Cb, 5),
                      query=_zeros(dev, 1, dtype=torch.int64),
                      center=_zeros(dev, 3))

        def fn(chain, query, center):
            qpack = pool.buf.index_select(0, query)[0]
            packs = pool.buf.index_select(0, chain[:, 0].long())
            return _chain_match_impl(qpack, packs, chain[:, 1:4],
                                     chain[:, 4] > 0, center, seq_matcher)

        return fn, inputs

    return seq_matcher.program(("chain", Cb, B), build, _pool_storage(pool))


def warm_programs(loop_matcher, seq_matcher, cfg, pool, buckets=(16,)):
    """Capture the fused verify's and the near-chain match's programs on
    `pool` at the chain `buckets` (on the CPU, make their buffers)."""
    for Cb in buckets:
        _verify_program(loop_matcher, seq_matcher, _gates(cfg), Cb, pool.B,
                        pool)
        _chain_program(seq_matcher, Cb, pool.B, pool)


def _verify_rows(loop_matcher, seq_matcher, chains, gates, pool, packs,
                 fill_query):
    """The (n_chains, 27) device rows of the fused verify: per chain one
    run of its bucket's program. `fill_query(inputs)` writes the query's
    local points, finite mask and center into a program's inputs; `packs`
    (sum C, B, 8) holds the chains' packs back to back where there is no
    pool."""
    dev = seq_matcher.device
    B = pool.B if pool is not None else packs.shape[1]
    recs = upload(_records(chains, pool), dev)
    rows = torch.empty((len(chains), 27), dtype=_F32, device=dev)
    starts = np.cumsum([0] + [len(c) for c in chains])
    for Cb, idx in _by_bucket(chains).items():
        prog = _verify_program(loop_matcher, seq_matcher, gates, Cb, B, pool)
        with prog.lock:
            inp = prog.inputs
            fill_query(inp)
            for i in idx:
                inp["chain"].copy_(recs[i, :Cb])
                if pool is None:
                    n = len(chains[i])
                    inp["packs"][:n].copy_(packs[starts[i]:starts[i] + n])
                prog.run(out=rows[i])
    return rows


def _chain_rows(seq_matcher, pool, queries, chains, fill_center):
    """Every (query, chain) pair's near-chain match, one run of its
    bucket's program per pair; `fill_center(p, dst)` writes pair p's
    center into `dst`. Returns the (n_pairs, 13) device rows and the
    chains' f32 member poses."""
    dev = pool.device
    recs = upload(_records(chains, pool), dev)
    qslots = upload(np.asarray([q._pool_slot for q in queries], np.int64),
                    dev)
    rows = torch.empty((len(chains), 13), dtype=_F32, device=dev)
    for Cb, idx in _by_bucket(chains).items():
        prog = _chain_program(seq_matcher, Cb, pool.B, pool)
        with prog.lock:
            inp = prog.inputs
            for p in idx:
                inp["chain"].copy_(recs[p, :Cb])
                inp["query"].copy_(qslots[p:p + 1])
                fill_center(p, inp["center"])
                prog.run(out=rows[p])
    return rows, chain_poses(chains)


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


def dispatch_chain_matches(seq_matcher, pairs, pool):
    """pairs: list of (query_scan, chain). Runs every pair's match with
    packs gathered from the pool and returns the (n_pairs, 13) device
    rows in pairs order."""
    _ensure_pooled(pool, [q for q, _ in pairs]
                   + [sc for _, chain in pairs for sc in chain])
    centers = upload(np.stack([q.sensor_pose for q, _ in pairs])
                     .astype(np.float32), pool.device)
    rows, _ = _chain_rows(seq_matcher, pool, [q for q, _ in pairs],
                          [c for _, c in pairs],
                          lambda p, dst: dst.copy_(centers[p]))
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
        lambda p, dst: dst.copy_(results[pairs[p][1], 1:4]))
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

    def fill_query(inp):
        inp["local"].copy_(local)
        inp["finite"].copy_(finite)
        inp["center"].copy_(results[ridx, 1:4])

    rows = _verify_rows(loop_matcher, seq_matcher, chains, _gates(cfg), pool,
                        None, fill_query)
    return HostCopy(rows), chain_poses(chains)


def dispatch_loop_verify(loop_matcher, seq_matcher, scan, chains, cfg,
                         pool=None):
    """Launch the fused verify of every candidate chain of this loop event
    and start the copy of its (n_chains, 27) rows to the host; returns the
    HostCopy. Chain packs are gathered from `pool` (the streaming
    pipeline's PackPool); with no pool they are uploaded once per scan."""
    dev = loop_matcher.device
    center = np.asarray(scan.sensor_pose, np.float32)
    local_dev, finite_dev = _scan_device_cache(scan, dev)
    members = [sc for c in chains for sc in c]
    packs = None
    if pool is not None:
        _ensure_pooled(pool, members)
    else:
        packs = torch.stack([_pack_dev(sc, dev) for sc in members])

    def fill_query(inp):
        inp["local"].copy_(local_dev)
        inp["finite"].copy_(finite_dev)
        upload_into(inp["center"], center)

    return HostCopy(_verify_rows(loop_matcher, seq_matcher, chains,
                                 _gates(cfg), pool, packs, fill_query))
