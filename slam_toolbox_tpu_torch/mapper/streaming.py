"""Streaming (device-resident) sequential-match pipeline.

PyTorch counterpart of slam_toolbox_tpu/mapper/streaming.py. The
sequential dependency chain stays on the device: a ring of the running
scans' packs and poses, the last odometry and correction, and a ring of
packed match results. A drain runs the whole batch of accumulated scans
(raster -> score -> ring update per scan) with no host synchronization
between its first and its last scan, and the host fetches the batch's
results once. The host then replays the standard graph bookkeeping
(edges, running buffer, near chains, loop closure through the fused
verify of kernels/loop_verify.py) with the fetched poses; the device
state is rebuilt from the host's running buffer whenever bookkeeping
moved a ring scan by more than RESYNC_EPS, so reference semantics hold
at drain boundaries.

Right after a batch, the pipeline speculates (SPECULATE, SPEC_LOOP): it
predicts each scan's near chains, and the newest scan's loop candidates,
from odometry, and launches their matches on the device with centers
read from the batch's result ring, so their rows come back with the
batch's. The commit keeps a speculative row only where the prediction
held exactly (the same chains, members and f32 poses, and the query's
f32 pose the ring row), and launches the rest as it would without
speculation, so the poses are the same either way.

The reference's switches are module attributes read from its environment
variables at import: PIPELINED (SLAM_STREAM_PIPELINE; 0 drains serially,
for A/B), SPECULATE (SLAM_SPEC), SPEC_LOOP (SLAM_SPEC_LOOP), ADAPTIVE
(SLAM_ADAPTIVE) and EARLY_VERIFY (SLAM_EARLY_VERIFY); the code reads
them where the reference does. The staleness gate RESYNC_EPS and the
eager pool seeding up to POOL_SEED_CAP scans are fixed at the
reference's defaults. Packs are uploaded once per drain in one pinned,
non-blocking copy (the reference streams 16-scan chunks during
accumulation). Localization's post_finish hook is called where the
reference calls it; no caller sets it yet.

The reference runs a drain's batch as one jitted fori_loop. Here each
scan of the batch is one step (_stream_step: raster -> score -> ring
update) that reads its scan from the batch buffers at a device index and
updates the device state in place; on a card the step is captured once
as a CUDA graph on the pipeline's static state (_StepGraph) and replayed
n times per batch, with no Python tensor code between steps. On a card
the step is seven hand-written kernels, as the reference's step is a few
XLA fusions around its Pallas calls: ring points and prior, scatter,
smear, score head, window sums, score tail, state update
(kernels/step_cuda.py, kernels/match_cuda.py). On the CPU
the same step runs eagerly (_stream_batch_impl): one body, two
launchers. A capture or replay that fails raises; nothing re-runs
eagerly.

The state's buffers are allocated once per pipeline and keep their
storage: refresh_state() copies the host's running buffer into them. The
result ring and its device write index are not restarted by a refresh:
a re-run writes the rows after the last batch's, and the ring holds two
drains (result_cap), so it never overwrites rows that a batch still in
flight has to read. Each dispatched batch snapshots the ring to the host
(device.HostCopy) before the next batch can write it; the speculative
launches read the ring before the next batch is launched.
"""
from __future__ import annotations

import contextlib
import math
import os
import time
import weakref
from typing import Dict, List

import numpy as np
import torch

from slam_toolbox_tpu_torch.core import geometry
from slam_toolbox_tpu_torch.device import HostCopy, upload, upload_into
from slam_toolbox_tpu_torch.kernels import rasterize as rz
from slam_toolbox_tpu_torch.kernels import step_cuda as sc
from slam_toolbox_tpu_torch.kernels.match import _f32, _score_impl
from slam_toolbox_tpu_torch.kernels.step_cuda import (
    _stream_prior, _unpack_scan, ring_points as _ring_points,
)
from slam_toolbox_tpu_torch.utils.metrics import stage_timer

RESULT_CAP = 256
RESYNC_EPS = 0.003
POOL_SEED_CAP = 8192
POOL_CAP = 2048      # PackPool's initial rows (it doubles when full)
_F32 = torch.float32


def _switch(name: str) -> bool:
    return os.environ.get(name, "1") != "0"


# pipelined drains: drain k launches batch k, then runs batch k-1's host
# bookkeeping while batch k executes; 0 commits each batch inline
PIPELINED = _switch("SLAM_STREAM_PIPELINE")
# speculative near-chain matches launched with the batch (rows ride the
# batch's fetch); 0 matches every near chain at the commit
SPECULATE = _switch("SLAM_SPEC")
# settle-first ordering while loop events keep closing loops that move the
# ring: every batch then runs once, from post-closure state
ADAPTIVE = _switch("SLAM_ADAPTIVE")
# speculative loop verify of the newest scan's predicted candidates,
# launched with the batch; on only where EARLY_VERIFY is off or a
# post_finish hook is set (localization)
SPEC_LOOP = _switch("SLAM_SPEC_LOOP")
# finish the newest scan first and launch its deferred loop verify before
# the rest of the batch's bookkeeping
EARLY_VERIFY = _switch("SLAM_EARLY_VERIFY")


class _PendingDrain:
    """One dispatched-but-uncommitted batch, with its speculative
    launches."""

    __slots__ = ("scans", "packs", "odoms", "start", "results", "_copy",
                 "spec", "spec_poses", "pred_chains", "spec_offsets",
                 "spec_loop")

    def __init__(self, scans, packs, odoms, start, results):
        self.scans = scans
        self.packs = packs        # (n, B, 8) device tensor (for re-runs)
        self.odoms = odoms        # (n, 3) device tensor
        self.start = start        # first result-ring row of this batch
        self.results = results    # the state's result ring
        self._copy = None
        self.clear_spec()

    def rerun(self, start) -> None:
        """The batch ran again, its rows from ring row `start`: drop the
        speculation and any copy of the ring taken before."""
        self.start = start
        self._copy = None
        self.clear_spec()

    def clear_spec(self) -> None:
        """Drop the speculative launches (they read a ring a re-run
        replaced)."""
        self.spec = None          # echo: the ring, then one row per pair
        self.spec_poses = None    # per pair, the chain's f32 poses
        self.pred_chains = None   # per scan, the predicted near chains
        self.spec_offsets = {}    # scan -> (first pair, pairs)
        # (predicted loop candidates, HostCopy of their verify rows, their
        # f32 poses): try_close_loop_begin's `spec`
        self.spec_loop = None

    def _target(self):
        return self.spec if self.spec is not None else self.results

    def prefetch(self) -> None:
        """Start the copy of the result ring (with the speculative rows
        behind it, if any) to the host without waiting."""
        self._copy = HostCopy(self._target())

    def fetch(self):
        """(result ring, speculative rows or None) as f64 on the host, one
        copy (prefetch()'s, unless a re-run dropped it)."""
        if self._copy is None:
            self.prefetch()
        comb = np.asarray(self._copy.numpy(), np.float64)
        cap = self.results.shape[0]
        return comb[:cap], (comb[cap:] if self.spec is not None else None)


def scan_pack(scan) -> np.ndarray:
    """Single packed (B, 8) f32 buffer per scan: [local_xy, anchor_xy,
    current_xy, next_delim, flags(bit0 finite, bit1 delim-valid)]. Cached
    on the scan (the contents are sensor-frame, pose-independent)."""
    cached = getattr(scan, "_stream_arrays", None)
    if cached is not None:
        return cached
    from slam_toolbox_tpu_torch import native

    pack = native.scan_pack(scan.local_points, scan.ranges)
    if pack is None:
        finite = np.isfinite(scan.ranges)
        delim_idx, anchors, next_delim = rz.find_valid_points_structure(
            scan.local_points
        )
        B = len(scan.ranges)
        pack = np.zeros((B, 8), np.float32)
        # f64->f32 assignment preserves NaN; zero exactly the non-finite
        # beams
        pack[:, 0:2] = scan.local_points
        if not finite.all():
            pack[~finite, 0:2] = 0.0
        D = len(delim_idx)
        if D:
            pack[:D, 2:4] = anchors
            pack[:D, 4:6] = pack[delim_idx, 0:2]
        pack[:, 6] = next_delim.astype(np.float32)
        flags = finite.astype(np.int32)
        if D:
            flags[:D] |= 2
        pack[:, 7] = flags.astype(np.float32)
    try:
        scan._stream_arrays = pack
    except AttributeError:
        pass
    return pack


def _stream_raster_impl(state, odom, matcher, offset_pose, half_span):
    """Prior propagation + device FindValidPoints + raster of the ring.
    Returns (grid_flat, center_off, prior)."""
    center_off, prior = _stream_prior(state, odom, offset_pose, half_span)
    pts, valid = _ring_points(
        state["ring_pack"], state["ring_pose"], state["ring_slot_valid"],
        center_off[:2], matcher.G,
    )
    return matcher._raster(pts, valid, center_off[3:5]), center_off, prior


def _stream_update_impl(grid_flat, center_off, prior, state, pack, odom,
                        offset_pose, run_buffer_size: int, max_sq: float,
                        score_kwargs: dict, eye9):
    """Score + pose update + ring push/evict + result append, in place on
    `state` (step_cuda.stream_update): every tensor keeps its storage,
    the result row goes to the device write index `ridx`, which advances
    modulo the ring, and the batch row `step` advances."""
    local_pts, _, _, _, finite, _ = _unpack_scan(pack)
    packed = _score_impl(grid_flat, center_off, local_pts, finite,
                         **score_kwargs)
    sc.stream_update(packed, center_off, pack, odom, offset_pose, eye9,
                     state, run_buffer_size, max_sq,
                     score_kwargs["grid_size"])


def _stream_step(state, matcher, offset_pose, half_span,
                 run_buffer_size: int, max_sq: float, score_kwargs: dict,
                 eye9):
    """One scan of a drain batch: the scan at row `step` of the batch
    buffers (a device index, which the step advances) through raster ->
    score -> state update. No host value enters it, so on a card it is
    captured once as a CUDA graph and replayed: seven launches, the ring
    points with the prior (step_cuda.ring_points_step), the raster's two,
    the score's three and the state update (step_cuda.stream_update)."""
    G = matcher.G
    pts, valid = sc.ring_points_step(state, offset_pose, half_span, G)
    center_off = state["center_off"]
    grid_flat = matcher._raster(pts, valid, center_off[3:5])
    pack = state["scan_pack"]
    packed = _score_impl(grid_flat, center_off, pack[:, 0:2],
                         state["scan_finite"], **score_kwargs)
    sc.stream_update(packed, center_off, pack, state["scan_odom"],
                     offset_pose, eye9, state, run_buffer_size, max_sq, G)


def _fit_batch(state, n: int) -> None:
    """Grow the batch buffers to n scans if they hold fewer (new storage:
    a graph captured on them is then stale)."""
    bp = state["batch_packs"]
    if n > bp.shape[0]:
        state["batch_packs"] = bp.new_zeros((n, *bp.shape[1:]))
        state["batch_odoms"] = state["batch_odoms"].new_zeros((n, 3))


def _load_batch(state, packs, odoms) -> int:
    """Copy a batch's (n, B, 8) packs and (n, 3) odometry into the batch
    buffers and point `step` at its first row; returns n."""
    n = packs.shape[0]
    _fit_batch(state, n)
    state["batch_packs"][:n].copy_(packs)
    state["batch_odoms"][:n].copy_(odoms)
    state["step"].zero_()
    return n


def _stream_batch_impl(state, packs, odoms, matcher, offset_pose, half_span,
                       run_buffer_size: int, max_sq: float,
                       score_kwargs: dict, eye9):
    """A whole drain batch, eagerly: raster -> score -> state update for
    each of the n scans, in order, with no host synchronization between
    them (the host knows n, so no padding and no device-side trip
    count). The CPU route, and the reference of the CUDA graph's
    replays."""
    n = _load_batch(state, packs, odoms)
    for _ in range(n):
        _stream_step(state, matcher, offset_pose, half_span,
                     run_buffer_size, max_sq, score_kwargs, eye9)
    state["n_results"] += n
    return state


def _new_state(K: int, B: int, result_cap: int, batch_cap: int,
               device) -> Dict:
    """A zeroed device state: an empty ring of K slots, the result ring,
    the batch buffers; each allocated here once."""
    def zeros(*shape, dtype=_F32):
        return torch.zeros(shape, dtype=dtype, device=device)

    ring_pack = zeros(K, B, 8)
    ring_pack[:, :, 6] = -1.0   # empty slots have no delimiter
    return {
        "ring_pack": ring_pack,
        "ring_pose": zeros(K, 3),
        "ring_slot_valid": zeros(K, dtype=torch.bool),
        "head": zeros(dtype=torch.int64),
        "count": zeros(dtype=torch.int64),
        "last_odom": zeros(3),
        "last_corrected": zeros(3),
        "results": zeros(result_cap, 13),
        "ridx": zeros(dtype=torch.int64),    # the ring's device write index
        "n_results": 0,                      # rows written (host count)
        "batch_packs": zeros(batch_cap, B, 8),
        "batch_odoms": zeros(batch_cap, 3),
        "step": zeros(dtype=torch.int64),    # the batch row the step reads
        # the step's scan and prior, written by its first launch
        # (step_cuda.ring_points_step) and read by the rest
        "center_off": zeros(5),
        "prior": zeros(3),
        "scan_pack": zeros(B, 8),
        "scan_odom": zeros(3),
        "scan_finite": zeros(B, dtype=torch.bool),
    }


def _storage_key(state) -> tuple:
    """Where each of the state's tensors lives: a graph captured on the
    state is valid while this is unchanged."""
    return tuple((k, v.data_ptr(), tuple(v.shape))
                 for k, v in state.items() if isinstance(v, torch.Tensor))


class _StepGraph:
    """The drain's step captured as a CUDA graph on one static state, and
    the kernel launches one replay makes (match_cuda.capture_graph). Its
    warm-up step runs on a scratch state, so `state` is untouched."""

    def __init__(self, state, step):
        from slam_toolbox_tpu_torch.kernels import match_cuda as mc

        self.state = state
        self.key = _storage_key(state)
        dev = state["results"].device
        scratch = _new_state(state["ring_pack"].shape[0],
                             state["ring_pack"].shape[1],
                             state["results"].shape[0], 1, dev)
        self.graph, self.tally, _ = mc.capture_graph(
            lambda: step(state), dev, warm=lambda: step(scratch))

    def valid_for(self, state) -> bool:
        return self.state is state and self.key == _storage_key(state)

    def run(self, n: int) -> None:
        """Replay n steps; their launches are counted by the tally."""
        from slam_toolbox_tpu_torch.kernels import match_cuda as mc

        for _ in range(n):
            self.graph.replay()
        mc.count_replay(self.tally, n)


class PackPool:
    """Device-resident pool of per-scan pack buffers.

    The pipeline uploads every scan's (B, 8) pack once for the batch;
    retaining those rows here lets loop-closure verification and chain
    matching gather whole chains by slot index instead of uploading each
    chain scan again. Row 0 is a zero row, so valid slots start at 1.
    Appends are contiguous; removed scans release() their slot and a
    whole-pool compaction (one row gather) reclaims the space when freed
    rows would otherwise force a growth.
    """

    def __init__(self, n_beams: int, device):
        self.B = n_beams
        self.cap = POOL_CAP
        self.device = device
        self.n = 1  # row 0 = zeros
        self.buf = torch.zeros((self.cap, n_beams, 8), dtype=_F32,
                               device=device)
        self._owners: Dict[int, object] = {}   # slot -> weakref(scan)
        self._freed = 0
        # how often the buffer moved: doublings and compactions (each one
        # makes the pooled programs capture again)
        self.growths = 0
        self.compactions = 0

    def release(self, scan) -> None:
        """Mark a removed scan's slot reusable (the row is reclaimed at the
        next compaction)."""
        slot = getattr(scan, "_pool_slot", None)
        if slot is None:
            return
        scan._pool_slot = None
        if self._owners.pop(slot, None) is not None:
            self._freed += 1

    def _compact(self) -> None:
        """Gather live rows to the front of the pool and renumber the
        owners' slots."""
        live = []
        for slot in sorted(self._owners):
            s = self._owners[slot]()
            if s is not None:
                live.append((slot, s))
        idx = np.zeros(self.cap, np.int64)   # row 0 stays the zero row
        new_owners = {}
        for j, (slot, s) in enumerate(live, start=1):
            idx[j] = slot
            s._pool_slot = j
            new_owners[j] = weakref.ref(s)
        self.buf = self.buf.index_select(0, upload(idx, self.device))
        self._owners = new_owners
        self.n = 1 + len(live)
        self._freed = 0
        self.compactions += 1

    def append_batch(self, packs, scans) -> None:
        """packs: (n, B, 8) device tensor of the scans' packs, in order."""
        n = len(scans)
        if n == 0:
            return
        if self.n + n > self.cap and self._freed >= self.cap // 2:
            self._compact()
        if self.n + n > self.cap:
            while self.n + n > self.cap:
                self.cap *= 2
            buf = torch.zeros((self.cap, self.B, 8), dtype=_F32,
                              device=self.device)
            buf[:self.n] = self.buf[:self.n]
            self.buf = buf
            self.growths += 1
        self.buf[self.n:self.n + n] = packs[:n]
        for i, s in enumerate(scans):
            try:
                s._pool_slot = self.n + i
                self._owners[self.n + i] = weakref.ref(s)
            except (AttributeError, TypeError):
                pass
        self.n += n

    def add_scans(self, scans) -> None:
        """Host-pack and upload scans that have no slot yet (seeds the pool
        with a prior graph's scans)."""
        todo = [s for s in scans
                if getattr(s, "_pool_slot", None) is None
                and len(s.ranges) == self.B]
        if not todo:
            return
        batch = upload(np.stack([scan_pack(s) for s in todo]), self.device)
        self.append_batch(batch, todo)

    def gather(self, idx) -> torch.Tensor:
        """(...,) slot indices (host) -> (..., B, 8) packs (device)."""
        idx = np.asarray(idx, np.int64)
        rows = self.buf.index_select(
            0, upload(idx.reshape(-1), self.device))
        return rows.reshape(*idx.shape, self.B, 8)


class StreamingPipeline:
    """Drives a Mapper through the device-resident pipeline."""

    def __init__(self, mapper, laser, drain_every: int = 8):
        self.mapper = mapper
        self.laser = laser
        self.drain_every = int(drain_every)
        if not mapper.initialized:
            mapper.initialize(laser.range_threshold)
        m = mapper.sequential_matcher
        self.matcher = m
        self.device = m.device
        self.K = int(mapper.config.scan_buffer_size)
        self.B = laser.n_beams

        self._score_args = dict(m._score_args, penalize=True, refine=True)
        self._offset_pose = upload(
            np.asarray(laser.offset_pose, np.float32), self.device)
        self._half_span = _f32(0.5 * (m.G - 1) * m.resolution)
        # the reference's f32 `run_max_distance**2 - 1e-6`
        rmax = np.float32(mapper.config.scan_buffer_maximum_scan_distance)
        self._max_sq = float(rmax * rmax - np.float32(1e-6))
        self._eye9 = torch.eye(3, dtype=_F32, device=self.device).reshape(-1)

        self.pending: List = []
        self._last_gate_scan = None
        # deferred loop closure: the commit dispatches the fused verify
        # and returns without waiting; the NEXT commit (or settle())
        # fetches the rows and applies the closure BEFORE any later
        # bookkeeping, so results match the blocking order
        self._deferred_loop = None
        # with two batches in flight the result ring must hold both spans
        self.result_cap = max(RESULT_CAP, 2 * self.drain_every)
        # the device state: None until the first refresh_state(), then
        # _buffers, which keep their storage for the pipeline's life (so
        # a thread that warms and one that maps see the same buffers)
        self.state = None
        self._buffers = _new_state(self.K + 2, self.B, self.result_cap,
                                   max(1, self.drain_every), self.device)
        self._graph = None   # _StepGraph of the drain's step, on a card
        self._pending_drain = None
        # host poses moved relative to the device state: the next consumer
        # of device results must refresh_state() (+ re-run in-flight
        # batches) first
        self._needs_resync = False
        # bumped by refresh_state: lets drain() detect that the device
        # chain its freshly dispatched batch rode was rebuilt mid-commit
        self._state_epoch = 0
        # adaptive-drain hysteresis: True while loop events keep finding
        # candidate chains (closures likely -> settle-first ordering)
        self._loop_hot = False
        # True while closures move ring poses beyond RESYNC_EPS
        self._closure_hot = True
        self._scans_since_loop = 0
        self._t_drain_end = None  # accum-window stage timing
        self.pipelined = PIPELINED
        # called with each scan after its bookkeeping in a drain
        # (localization appends to its elastic buffer there); True means
        # it changed the running buffer, so the device ring must resync
        self.post_finish = None
        # utils/lifecycle.Watchdog (SlamSession.enable_watchdog): the
        # drain's fetch runs inside one of its sections
        self.watchdog = None
        self.pack_pool = PackPool(self.B, self.device)
        mapper._pack_pool = self.pack_pool  # loop verify gathers from it
        if mapper.sensor_manager is not None:
            prior = mapper.all_processed_scans()
            if len(prior) <= POOL_SEED_CAP:
                self.pack_pool.add_scans(prior)

    # -- state <-> host sync -----------------------------------------------
    def refresh_state(self) -> None:
        """Copy the host's authoritative running buffer + last scan into
        the device state."""
        with stage_timer(self.mapper.stats, "refresh_state"):
            self._refresh_state_impl()

    def _refresh_state_impl(self) -> None:
        sm = self.mapper.sensor_manager
        running = sm.get_running_scans(self.laser.name)
        last = sm.get_last_scan(self.laser.name)
        K, B = self.K + 2, self.B  # +2 slack for between-drain growth
        ring_pack = np.zeros((K, B, 8), np.float32)
        ring_pack[:, :, 6] = -1.0  # empty slots have no delimiter
        ring_pose = np.zeros((K, 3), np.float32)
        slot_valid = np.zeros(K, bool)
        for i, s in enumerate(running[-K:]):
            ring_pack[i] = scan_pack(s)
            ring_pose[i] = s.sensor_pose
            slot_valid[i] = True
            s._dev_pose = np.array(s.sensor_pose)
        last_odom = np.zeros(3, np.float32)
        last_corrected = np.zeros(3, np.float32)
        if last is not None:
            last_odom = last.odom_pose.astype(np.float32)
            last_corrected = last.corrected_pose.astype(np.float32)
        self.state = self._fill_state(ring_pack, ring_pose, slot_valid,
                                      len(running), last_odom,
                                      last_corrected)
        self._state_epoch += 1

    def _fill_state(self, ring_pack, ring_pose, slot_valid, count,
                    last_odom, last_corrected) -> Dict:
        """Copy host arrays into the device state, in place. The result
        ring and its write index go on from where they were."""
        st = self._buffers
        for key, a in (("ring_pack", ring_pack), ("ring_pose", ring_pose),
                       ("ring_slot_valid", slot_valid),
                       ("last_odom", last_odom),
                       ("last_corrected", last_corrected)):
            upload_into(st[key], a)
        st["head"].zero_()
        st["count"].fill_(count)
        return st

    def warm(self) -> None:
        """On a card, capture the drain's step graph on the pipeline's
        device state (_StepGraph: its eager step runs on a scratch state,
        and capturing runs nothing); on the CPU, run one drain-sized
        batch on a scratch state. The state's values, the pack pool, the
        result ring and the kernels' launch counts stay as they were."""
        from slam_toolbox_tpu_torch.kernels import match_cuda as mc

        if self.device.type == "cuda":
            self._step_graph(self._buffers, self.drain_every)
            return
        n = self.drain_every
        st = _new_state(self.K + 2, self.B, self.result_cap, n, self.device)
        with mc.uncounted():
            self._run_eager(
                st, torch.zeros((n, self.B, 8), dtype=_F32),
                torch.zeros((n, 3), dtype=_F32))

    # -- ingestion ----------------------------------------------------------
    def process_scan(self, scan) -> bool:
        """Gate + accumulate; the batch runs on the device at drain."""
        if not scan.laser.validate(scan.ranges):
            return False
        last_ref = self._last_gate_scan or (
            self.mapper.sensor_manager.get_last_scan(self.laser.name)
        )
        if not self.mapper.has_moved_enough(scan, last_ref):
            return False
        if self.state is None:
            self.refresh_state()
        self.pending.append(scan)
        scan_pack(scan)   # host-side pack now; uploaded once per drain
        self._last_gate_scan = scan
        # the result ring holds two batches: this one and the previous
        # in-flight one
        if len(self.pending) >= self.drain_every:
            self.drain()
        return True

    def _dispatch_batch(self, scans):
        """Upload the batch's packs and odometry in one pinned copy each
        and run the batch on the device."""
        dev = self.device
        packs = upload(np.stack([scan_pack(s) for s in scans]), dev)
        odoms = upload(
            np.stack([s.odom_pose for s in scans]).astype(np.float32), dev)
        self.pack_pool.append_batch(packs, scans)
        self._run_batch(self.state, packs, odoms)
        return packs, odoms

    def _step(self, state) -> None:
        _stream_step(state, self.matcher, self._offset_pose,
                     self._half_span, self.K, self._max_sq,
                     self._score_args, self._eye9)

    def _run_eager(self, state, packs, odoms):
        """The batch step by step from Python: the CPU route."""
        return _stream_batch_impl(
            state, packs, odoms, self.matcher, self._offset_pose,
            self._half_span, self.K, self._max_sq, self._score_args,
            self._eye9,
        )

    def _step_graph(self, state, n: int) -> "_StepGraph":
        """The step graph of `state` with batch buffers for n scans,
        captured at first use and again whenever a buffer moved (a batch
        above their capacity grows them)."""
        from slam_toolbox_tpu_torch.kernels import match_cuda as mc

        _fit_batch(state, n)
        g = self._graph
        if g is None or not g.valid_for(state):
            with mc.capture_lock, stage_timer(self.mapper.stats,
                                              "graph_capture"):
                g = self._graph
                if g is None or not g.valid_for(state):
                    g = self._graph = _StepGraph(state, self._step)
        return g

    def _run_batch(self, state, packs, odoms):
        """Run a batch on `state`: on a card, copy it into the batch
        buffers and replay the step graph once per scan; on the CPU, the
        eager loop."""
        n = packs.shape[0]
        self.mapper.stats.count("batch_steps", n)
        if self.device.type != "cuda":
            return self._run_eager(state, packs, odoms)
        graph = self._step_graph(state, n)
        _load_batch(state, packs, odoms)
        graph.run(n)
        state["n_results"] += n
        return state

    def settle(self) -> None:
        """Terminal completion: commit every dispatched-but-uncommitted
        batch and any deferred loop closure, then resync the device state
        if host bookkeeping moved poses. Scans still accumulating in
        `pending` are untouched (drain() dispatches those)."""
        while (self._pending_drain is not None
               or self._deferred_loop is not None):
            self._commit()
        # rate-limited cadences (loop_attempt_interval_scans > 0) may
        # leave the tail scans without a closure attempt: a terminal
        # attempt on the newest scan restores the reference's flush
        # semantics (the classic path attempts every scan)
        cfg = self.mapper.config
        if (cfg.loop_attempt_interval_scans > 0
                and self._scans_since_loop > 0
                and cfg.use_scan_matching and cfg.do_loop_closing):
            last = self.mapper.sensor_manager.get_last_scan(
                self.laser.name
            )
            if last is not None:
                handle = self.mapper.graph.try_close_loop_begin(
                    last, self.laser.name
                )
                closed = (handle if isinstance(handle, bool)
                          else self.mapper.graph.try_close_loop_finish(
                              handle))
                self._scans_since_loop = 0
                if closed:
                    self._needs_resync = True
        if self._needs_resync:
            self.refresh_state()
            self._needs_resync = False

    def drain(self) -> None:
        """Dispatch the pending batch. Pipelined (PIPELINED): the dispatch
        happens FIRST, then the PREVIOUS batch's host bookkeeping runs
        while this batch executes on the device; its own bookkeeping runs
        at the next drain (or settle()). When the previous commit moved
        poses the in-flight batch is re-run from the refreshed state
        before its results are read. While loop events keep producing
        closures that move ring poses (ADAPTIVE), the order flips to
        settle-first (commit, settle the deferred verify, then dispatch),
        so every batch runs once from post-closure state. Serial
        (PIPELINED off, for A/B): settle, then dispatch, fetch and commit
        inline. With drain_every=1 the commit sequence is exactly the
        classic per-scan path."""
        if not self.pipelined:
            # settle() first: with loop_attempt_interval_scans > 0 its
            # terminal loop attempt fires before every serial drain, as in
            # the reference
            self.settle()
            if not self.pending:
                return
            scans = self.pending
            self.pending = []
            self._drain_serial(scans)
            return
        if not self.pending:
            return
        stats0 = self.mapper.stats
        if stats0.enabled and self._t_drain_end is not None:
            stats0.add("accum_window", time.perf_counter() - self._t_drain_end)

        scans = self.pending
        n = len(scans)
        self.pending = []
        # can the commit we are about to run even ATTEMPT a closure? With
        # loop_attempt_interval_scans rate-limiting, attempt-free commits
        # keep the dispatch-first overlap regardless of the hysteresis
        cfg_m = self.mapper.config
        pd_prev = self._pending_drain
        attempt_next = (
            pd_prev is not None
            and cfg_m.use_scan_matching and cfg_m.do_loop_closing
            and (self._scans_since_loop + len(pd_prev.scans))
            >= cfg_m.loop_attempt_interval_scans
        )
        settle_first = ADAPTIVE and (
            self._needs_resync
            or ((self._deferred_loop is not None
                 or (self._loop_hot and attempt_next))
                and self._closure_hot)
        )
        if settle_first:
            with stage_timer(stats0, "commit_total"):
                self._commit()  # previous batch: fetch+bookkeep+verify
            self._settle_deferred()  # wait the verify it just dispatched
            if self._needs_resync:
                self.refresh_state()
                self._needs_resync = False
        with stage_timer(stats0, "batch_dispatch"):
            packs, odoms = self._dispatch_batch(scans)
        pd = _PendingDrain(
            scans, packs, odoms, start=self.state["n_results"] - n,
            results=self.state["results"],
        )
        # gate the next accumulation against the newest DISPATCHED scan
        # (its host bookkeeping hasn't run yet, so sm.last_scan is stale)
        self._last_gate_scan = scans[-1]
        if not settle_first:
            epoch0 = self._state_epoch
            with stage_timer(stats0, "commit_total"):
                self._commit()  # previous batch's bookkeeping; overlaps
            if self._needs_resync:
                self.refresh_state()
                self._needs_resync = False
            if self._state_epoch != epoch0:
                # the device chain this batch rode was rebuilt mid-commit:
                # re-run it from the authoritative state
                self._run_batch(self.state, pd.packs, pd.odoms)
                pd.rerun(self.state["n_results"] - n)
        # after any re-run and before the next batch writes the ring
        with stage_timer(stats0, "spec_dispatch"):
            self._dispatch_spec(pd)
        pd.prefetch()
        self._pending_drain = pd
        if stats0.enabled:
            self._t_drain_end = time.perf_counter()

    def _dispatch_spec(self, pd, loop: bool = True) -> None:
        """Speculative launches for a dispatched batch, with no host
        synchronization: each scan's near chains predicted from odometry
        (graph.predict_near_chains) and matched against centers read from
        the batch's result ring, their rows appended to the ring in one
        echo tensor that the commit's single fetch brings back; and, with
        `loop`, the fused verify of the newest scan's predicted loop
        candidates. The commit validates every prediction and launches
        what missed, so the rows it uses are those of the non-speculative
        path."""
        cfg = self.mapper.config
        if len(pd.scans) <= 1 or not SPECULATE or not cfg.use_scan_matching:
            return
        anchor = self.mapper.sensor_manager.get_last_scan(
            pd.scans[0].laser.name)
        if anchor is None:
            return
        from slam_toolbox_tpu_torch.kernels import loop_verify as lv

        graph = self.mapper.graph
        stats = self.mapper.stats
        pred_chains = graph.predict_near_chains(pd.scans, anchor)
        stats.count("spec_pred_unavailable",
                    sum(1 for c in pred_chains if c is None))
        cap = self.result_cap
        spairs = []
        spec_offsets = {}
        for i, chains in enumerate(pred_chains):
            if not chains:
                continue
            spec_offsets[i] = (len(spairs), len(chains))
            spairs.extend((pd.scans[i], (pd.start + i) % cap, c)
                          for c in chains)
        if spairs:
            stats.count("spec_pairs", len(spairs))
            out = lv.dispatch_chain_matches_spec(
                self.matcher, spairs, self.pack_pool, pd.results)
            if out is None:
                stats.count("spec_dispatch_abort")
            else:
                pd.spec, pd.spec_poses = out
                pd.pred_chains = pred_chains
                pd.spec_offsets = spec_offsets
        # the loop verify's speculation only where the early-verify
        # ordering is off: there the verify's device time would otherwise
        # sit on the settle-first path (localization keeps it)
        spec_loop_on = loop and SPEC_LOOP and not (
            EARLY_VERIFY and self.post_finish is None)
        will_attempt = (self._scans_since_loop + len(pd.scans)
                        >= cfg.loop_attempt_interval_scans)
        if (spec_loop_on and will_attempt and cfg.do_loop_closing
                and any(c is not None for c in pred_chains)):
            pred_loop = graph.predict_loop_chains(
                pd.scans, anchor, pd.scans[-1].laser.name,
                pred_chains=pred_chains)
            if pred_loop:
                out = lv.dispatch_loop_verify_spec(
                    self.mapper.loop_matcher, self.matcher, pd.scans[-1],
                    (pd.start + len(pd.scans) - 1) % cap, pred_loop, cfg,
                    self.pack_pool, pd.results)
                if out is not None:
                    pd.spec_loop = (pred_loop, *out)
                    stats.count("spec_loop_dispatched")

    def _settle_deferred(self) -> bool:
        """Finish the deferred loop closure dispatched by the previous
        commit. A closure that moved ring poses beyond RESYNC_EPS flags
        _needs_resync (the flag survives an exception in the fetch)."""
        if self._deferred_loop is None:
            return False
        handle = self._deferred_loop
        self._deferred_loop = None
        any_closed = False
        try:
            with stage_timer(self.mapper.stats, "loop_closure_settle"):
                any_closed = self.mapper.graph.try_close_loop_finish(
                    handle
                )
        finally:
            if any_closed:
                hot = self._ring_staleness() > RESYNC_EPS
                # drives the settle-first hysteresis
                self._closure_hot = hot
                if hot:
                    self._needs_resync = True
        return any_closed

    def _commit(self) -> None:
        """Host bookkeeping for the oldest in-flight batch: settle the
        previous commit's deferred loop closure, re-run the batch if that
        closure (or an earlier flagged change) moved host poses after the
        batch ran, then fetch its results and replay the standard graph
        bookkeeping."""
        self._settle_deferred()
        pd = self._pending_drain
        self._pending_drain = None
        if pd is None:
            if self._needs_resync and self.state is not None:
                self.refresh_state()
                self._needs_resync = False
            return
        if self._needs_resync:
            self.refresh_state()
            self._needs_resync = False
            self._run_batch(self.state, pd.packs, pd.odoms)
            pd.rerun(self.state["n_results"] - len(pd.scans))
        res_np, spec_np = self._fetch(pd)
        with stage_timer(self.mapper.stats, "commit_bookkeep"):
            moved_uids, any_closed, buffer_changed = self._bookkeep(
                pd, res_np, spec_np)
        self._flag_resync(moved_uids, any_closed, buffer_changed)

    def _fetch(self, pd):
        """The batch's rows on the host, the wait sectioned by the
        watchdog when one is set (a wedged device shows up there)."""
        wd = self.watchdog
        wd_sec = (wd.section("drain_fetch") if wd is not None
                  else contextlib.nullcontext())
        with stage_timer(self.mapper.stats, "drain_fetch"), wd_sec:
            return pd.fetch()

    def _flag_resync(self, moved_uids, any_closed, buffer_changed):
        """Decide whether host bookkeeping diverged from the device ring:
        a running-buffer edit by post_finish always does; pose moves (loop
        closures, chain fusion) matter only when a ring-mirrored scan
        moved beyond RESYNC_EPS, since late-run closure corrections are
        sub-millimeter and a rebuild forces the settle-first drain
        ordering."""
        if buffer_changed:
            self._needs_resync = True
            return
        if not (any_closed or moved_uids):
            return
        stale = self._ring_staleness() > RESYNC_EPS
        if any_closed:
            self._closure_hot = stale
        if stale:
            self._needs_resync = True

    def _ring_staleness(self) -> float:
        """Max endpoint-level divergence between the host's current
        sensor poses and what the device ring believes, over the
        ring-mirrored scans (running window + last): position delta plus
        heading delta at the 10 m max-beam lever arm. Scans with no
        recorded device pose count as infinitely stale."""
        sm = self.mapper.sensor_manager
        name = self.laser.name
        last = sm.get_last_scan(name)
        worst = 0.0
        check = list(sm.get_running_scans(name))[-(self.K + 2):]
        if last is not None and last not in check:
            check.append(last)
        for s in check:
            dev = getattr(s, "_dev_pose", None)
            if dev is None:
                return float("inf")
            cur = s.sensor_pose
            d = math.hypot(cur[0] - dev[0], cur[1] - dev[1])
            dth = abs(math.atan2(math.sin(cur[2] - dev[2]),
                                 math.cos(cur[2] - dev[2])))
            worst = max(worst, d + 10.0 * dth)
        return worst

    def _drain_serial(self, scans) -> None:
        """Serial drain (PIPELINED off, for A/B): dispatch, fetch and
        commit inline, with the near-chain speculation of the pipelined
        drain (no loop speculation). A resync follows any pose move or
        closure, without the staleness gate; with a deferred loop closure
        in flight the decision moves to the next settle."""
        n = len(scans)
        stats = self.mapper.stats
        with stage_timer(stats, "batch_dispatch"):
            self._dispatch_batch(scans)
        pd = _PendingDrain(scans, None, None,
                           start=self.state["n_results"] - n,
                           results=self.state["results"])
        self._last_gate_scan = None
        with stage_timer(stats, "spec_dispatch"):
            self._dispatch_spec(pd, loop=False)
        pd.prefetch()
        res_np, spec_np = self._fetch(pd)
        moved_uids, any_closed, buffer_changed = self._bookkeep(
            pd, res_np, spec_np)
        if moved_uids or any_closed or buffer_changed:
            self._needs_resync = True
        if self._deferred_loop is None and self._needs_resync:
            self.refresh_state()
            self._needs_resync = False

    def _bookkeep(self, pd, res_np, spec_np):
        """Replay standard graph bookkeeping for the fetched batch `pd` in
        two phases (host links for every scan; then the near-chain rows,
        from the speculation where it held and from one batched match for
        the rest, and the per-scan link/fuse), with one loop-closure
        attempt on the newest scan. `res_np` is the result ring and
        `spec_np` the speculative near-chain rows (None: none). Returns
        (moved_uids, any_closed, buffer_changed)."""
        from slam_toolbox_tpu_torch.kernels import loop_verify as lv
        from slam_toolbox_tpu_torch.kernels.match import Matcher

        stats = self.mapper.stats
        scans, start = pd.scans, pd.start
        n = len(scans)
        cap = self.result_cap
        cfg = self.mapper.config
        matching = cfg.use_scan_matching
        moved_uids = set()
        any_closed = False
        buffer_changed = False
        sm = self.mapper.sensor_manager
        graph = self.mapper.graph

        def set_poses(i, scan):
            packed = res_np[(start + i) % cap]
            response = packed[0]
            mean = packed[1:4]
            cov = packed[4:13].reshape(3, 3)
            last = sm.get_last_scan(scan.laser.name)
            if last is not None:
                scan.set_corrected_pose(np.asarray(
                    geometry.transform_pose_between(
                        last.odom_pose, last.corrected_pose,
                        scan.odom_pose,
                    )
                ))
            if last is not None and response > 0.0:
                scan.set_sensor_pose(mean)
            else:
                cov = np.eye(3)
            # what the device ring believes this scan's sensor pose is
            # (the staleness-gated resync compares against it)
            scan._dev_pose = np.array(scan.sensor_pose)
            return cov

        def at_ring_row(scan, i) -> bool:
            """The scan's f32 sensor pose is its ring row's, which the
            speculative launches read as their center."""
            row = res_np[(start + i) % cap]
            return row[0] > 0.0 and np.array_equal(
                np.asarray(scan.sensor_pose, np.float32),
                row[1:4].astype(np.float32))

        if n == 1:
            # single-scan drain: exactly the classic per-scan sequence
            scan = scans[0]
            cov = set_poses(0, scan)
            pose_before = scan.corrected_pose.copy()
            any_closed = self.mapper.finish_scan(scan, cov)
            if np.any(np.abs(scan.corrected_pose - pose_before) > 1e-7):
                moved_uids.add(scan.unique_id)
            if self.post_finish is not None:
                buffer_changed = bool(self.post_finish(scan))
            return moved_uids, any_closed, buffer_changed

        # phase 1 (per scan): set poses from the fetched ring results, add
        # the vertex + host-side links, and collect the near chains
        # without matching them. Running-buffer eviction sees the
        # pre-fusion pose here (mm-scale difference at the eviction
        # boundary only).
        staged = []
        for i, scan in enumerate(scans):
            cov = set_poses(i, scan)
            sm.add_scan(scan)
            pf = None
            if matching:
                with stage_timer(stats, "graph_edges"):
                    graph.add_vertex(scan)
                    pf = graph.add_edges_begin(scan, cov, dispatch=False)
                sm.add_running_scan(scan)
            sm.set_last_scan(scan)
            staged.append((scan, pf))
        # phase 2: a scan's speculative rows stand where it was predicted
        # exactly (the same chains, members and f32 poses, and the query
        # at its ring row's f32 pose); every other scan's near chains run
        # as one pool-gather program with a single fetch
        plan = []  # per staged entry: ("none" | "spec" | "miss", off, cnt)
        miss_pairs = []
        spec_results = (Matcher.results_from_packed(spec_np)
                        if spec_np is not None else [])
        for i, (scan, pf) in enumerate(staged):
            chains = pf[0] if pf is not None else []
            if not chains:
                plan.append(("none", 0, 0))
                continue
            hit = False
            if spec_np is not None and i in pd.spec_offsets:
                off, cnt = pd.spec_offsets[i]
                hit = (
                    [tuple(s.unique_id for s in c) for c in chains]
                    == [tuple(s.unique_id for s in c)
                        for c in pd.pred_chains[i]]
                    and at_ring_row(scan, i)
                    and all(np.array_equal(snap, poses) for snap, poses in
                            zip(pd.spec_poses[off:off + cnt],
                                lv.chain_poses(chains)))
                )
            if hit:
                plan.append(("spec", off, cnt))
                stats.count("spec_chain_hit")
            else:
                plan.append(("miss", len(miss_pairs), len(chains)))
                miss_pairs.extend((scan, c) for c in chains)
                if spec_np is not None:
                    stats.count("spec_chain_miss")
        fetched_miss = []
        if miss_pairs:
            with stage_timer(stats, "near_chain_match"):
                rows = lv.dispatch_chain_matches(
                    self.matcher, miss_pairs, self.pack_pool
                )
                fetched_miss = Matcher.results_from_packed(
                    rows.cpu().numpy())
        # loop closure once per batch on the newest scan (candidate chains
        # persist across consecutive scans, so closures fire a few scans
        # later at most); loop_attempt_interval_scans > 0 rate-limits it
        self._scans_since_loop += n
        attempt_loop = (
            matching and cfg.do_loop_closing
            and self._scans_since_loop >= cfg.loop_attempt_interval_scans
        )
        if attempt_loop:
            self._scans_since_loop = 0
        names = sm.sensor_names() if attempt_loop else []

        def finish_one(i) -> bool:
            scan, pf = staged[i]
            kind, off, cnt = plan[i]
            rows = {"spec": spec_results, "miss": fetched_miss}.get(kind, [])
            pose_before = scan.corrected_pose.copy()
            with stage_timer(stats, "graph_edges"):
                graph.add_edges_finish(scan, pf,
                                       results=rows[off:off + cnt])
            if np.any(np.abs(scan.corrected_pose - pose_before) > 1e-7):
                # near-chain fusion moved this scan
                moved_uids.add(scan.unique_id)
            if self.post_finish is not None:
                return bool(self.post_finish(scan))
            return False

        def begin_loop():
            # the speculative verify's rows stand only when the center
            # they read (the newest scan's ring row) is bit for bit its
            # current f32 sensor pose: a fusion move below the f64
            # bookkeeping threshold can still flip an f32 ulp
            spec = (pd.spec_loop if pd.spec_loop is not None
                    and at_ring_row(scans[-1], n - 1) else None)
            with stage_timer(stats, "loop_closure"):
                handle = graph.try_close_loop_begin(scans[-1], names[0],
                                                    spec=spec)
            # adaptive hysteresis: candidate chains present -> closures
            # likely -> settle-first ordering next drain
            self._loop_hot = bool(handle) or not isinstance(handle, bool)
            return handle

        # early-verify ordering: finish the NEWEST scan first, dispatch
        # the deferred loop verify, then finish the rest, so the verify's
        # device time overlaps the remaining host bookkeeping. The sweep
        # sees batch-mates at their pre-fusion (phase-1) poses. Off where
        # post_finish is set: a mid-batch buffer eviction could remove a
        # swept chain member before the rest is finished.
        early_verify = (EARLY_VERIFY and attempt_loop and len(names) == 1
                        and self.post_finish is None)
        handle = None
        if early_verify:
            buffer_changed |= finish_one(n - 1)
            handle = begin_loop()
            for i in range(n - 1):
                buffer_changed |= finish_one(i)
        else:
            for i in range(n):
                buffer_changed |= finish_one(i)
            if attempt_loop and len(names) == 1:
                handle = begin_loop()
        if handle is not None:
            if isinstance(handle, bool):
                any_closed |= handle
            else:
                self._deferred_loop = handle
        elif attempt_loop and len(names) > 1:
            with stage_timer(stats, "loop_closure"):
                hot = False
                for name in names:
                    if graph.try_close_loop(scans[-1], name):
                        any_closed = True
                        hot = True
                self._loop_hot = hot
        return moved_uids, any_closed, buffer_changed
