#!/usr/bin/env python3
"""Smoke run of the PyTorch port (slam_toolbox_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is caught:
  1. build    — compile the nine CUDA kernel sources from csrc/ with nvcc
                for sm_90a (one process per source, in parallel), and beside
                them score_tail.cu with SCORE_TAIL_PHASE_CLOCK as a
                library that only this script loads; check score_tail's
                static shared memory against
                step_cuda.TAIL_STATIC_SMEM;
  2. kernels  — for the scatter, smear and window-score kernels, at the
                sequential matcher's (G = 2051) and the loop matcher's
                (G = 561) geometry, hold each kernel against its plain
                PyTorch version on the card on inputs from simulated scans
                (the sequential ring; a loop chain as pose_graph builds
                one) plus out-of-grid, -1e9 and non-finite beams
                (bit-equal required), and time both with CUDA events;
                the scatter, the smear, the library scatter and the window
                score also by CUDA graph replays (device time per launch),
                with the share of the smear's tile rows that are empty and
                the shares of the window score's (heading, beam) pairs
                that are full, partial and empty; the window score also
                bit-equal on tables with INT_MIN and 1 << 28 entries, with
                no finite beam and on 7 x 11 and 11 x 7 lattices; then the
                scatter and the smear on the adversarial occupancy
                patterns (empty, full, random, corners, word and tile
                edges, full rows and columns) at (G, hk) = (2051, 20),
                (561, 1), (257, 0) and (257, 40), word- and bit-equal
                required;
                the scan step's kernels (ring_points, the window sums'
                head form score_windows_head, score_tail, stream_update)
                at both geometries on the same scans, each against its
                plain version on the path's inputs and on edge cases
                (masked and pad chain slots, NaN beams, an empty ring; a
                strided local view, a heading at pi, a lattice off the
                grid and no finite beam, the head form bit-equal to the
                plain head then the plain sums; every flag pair, no finite
                beam, an all-zero and
                a flat raster; the first scan, evictions by count and
                distance, the result ring's wrap): integer and
                elementwise outputs bit-equal, score_tail's coarse best
                and tie count bit-equal, its means and covariances within
                step_cuda's MEAN_ATOL and COV_RTOL, its fine and angular
                parts bit-equal at its own means, and 100 launches on the
                path's inputs bit-identical (output and aux); each timed
                (CUDA events and graph replays) beside its bound and the
                device time of the PyTorch ops it replaces; score_tail
                also with its cluster shape and the clusters the card
                holds of it (cudaOccupancyMaxActiveClusters), its five
                phases timed apart (the phase clock build), the other
                launch geometries of TAIL_SWEEP timed beside the chosen
                one, and its streamed and wide modes bit-equal to the
                resident mode under every flag pair and timed; ring_points
                also on a
                ring of WIDE_BEAMS beams in both modes; then
                score_tail's streamed mode on a 21 x 201 x 201 lattice
                (a 20 m loop search) and at 600 headings on a 3 x 3
                lattice, each at 1,081 and 271 beams, against its plain
                version (check_tail_wide), and
                stream_update at 12, 25, 100, 4,096, 4,097 and 20,000
                slots with the eviction's leading run ending at 0, 5, 32,
                64 and K (check_update_edges), bit-equal; every kernel
                past its former limits (check_limits): K1 in both forms
                at 70,000 headings, on a 2 x 70,000 lattice and on a
                G 46,400 raster (2.15 GB), K7 at 65 and 200 fine headings
                and at 27,009 and 60,000 beams (its wide mode), K5 at
                49,153 and 300,000 beams, each against its plain version
                (exact parts bit-equal) and timed; K3 past its shared
                memory at (G, hk) = (2051, 900) among the patterns;
                and the window-score ceiling (score_ceiling), the
                roofline measurement at the bench geometry: its device
                time (CUDA graph replays) beside score_windows' on the
                table that tiles its offsets, at equal work, with the
                gathers of each run; held bit-equal to its plain version
                and to score_windows on that table at four origins, on
                7 x 11 and 11 x 7 lattices, with 65 slots and on a grid
                that every offset misses; its byte loads counted in the
                SASS where cuobjdump is present;
  3. parity   — a 40-scan session at a reduced geometry on the card and on
                the CPU (plain versions), classic and streaming:
                trajectories within 4 cm;
  4. classic  — the bench workload (bench.py's configuration, seed 42) cut
                to 2 laps (about 260 scans, one revisit) through
                SlamSession(device="cuda"): ATE below half of odometry's,
                at least one loop closure, every path kernel launched;
                every match a replay of its program (a CUDA graph per
                shape bucket); then again with the matchers' eager route
                patched in: the same trajectory and closures bit for bit
                and the same K1-K3 launches by grid;
  5. no sync  — on a pipeline that has committed the bench workload's
                first drain, the second drain's batch (256 replays of the
                step graph the first drain captured) and
                its speculative launches (the near-chain matches of its
                predicted chains, here 16 pairs of its scans with chains
                of committed scans, and the fused verify of its newest
                scan's predicted loop candidates, with EARLY_VERIFY off as
                in localization) under
                torch.cuda.set_sync_debug_mode("error"), the verify and
                the near-chain matches as replays of their programs
                (captured before, at chain buckets 16, 64 and 128); the
                speculative rows bit-equal to the non-speculative path's,
                and the commit then uses the speculative rows;
 5b. graph    — that second drain's batch from one saved state, eagerly
                (the Python loop), as replays of the pipeline's step
                graph and of a graph of UNROLL (16) steps, in turns:
                every state tensor bit-equal, the tallies' launches equal
                to the loop's;
                capture ms, host us per replay, device ms per step and
                each route's batch launch on the host (`# graph:`); a
                replay's launches by the tally (one each of the six
                step kernels) and its device kernels in a profiler trace
                (fewer than 20) (`# graph step:`);
 5c. programs — on phase 4's workload, the per-event programs at the
                buckets a session meets (the sequential match penalized
                and not, the loop coarse match, the fused verify at chain
                buckets 16 and 64, the near-chain match at 16): per
                program and bucket the capture ms, host us per replay,
                device ms per replay (CUDA events over replays), the
                eager route's host ms for the same work, each replay
                bit-equal to the eager function on the same inputs, and
                the graphs' reserved device memory (`# programs:`); then
                the exact two-call match forced on both matchers (a
                query moved off the map, fused response 0, so the coarse
                pass, three expansions and the fine pass; and
                match_scan(exact=True) on the map) as raster and pass
                replays against the fresh-tensor route, in turns:
                bit-equal, K1-K3 launches equal by grid and none outside
                a graph on the replayed runs (`# exact:`);
  6. streaming — bench.py's full workload (16 laps, about 2,030 scans)
                through SlamSession(streaming=True, drain_every=256,
                device="cuda") with the defaults (speculation on), the main
                path: ATE below half of odometry's, at least one loop
                closure and one fused verify, speculative near-chain rows
                used, every path kernel launched (counted by the step
                graph's tally per replay); then again with the pipeline's
                batches run by the eager loop: the same trajectory,
                closures and launches;
  7. spec off — the same workload with SPECULATE off: the same trajectory
                and closures (bit for bit; or, if the card's path proves
                nondeterministic by a second spec-off run, within 4 cm),
                both rates printed;
  8. serial   — 2 laps with PIPELINED off against pipelined, drains of 32,
                loop attempts every drain: the same trajectory;
  9. warm     — warm_all() on a fresh streaming session (launches made
                while warming are not counted), then 2 laps through it;
 10. map path — the outputs of phase 6's session: its occupancy grid at
                0.05 m on the native host route and on the tensor route on
                the card (bit-equal), 2 more laps and a publish (the
                incremental fold while the new scans stay inside the
                extent; equal to the full rebuild either way), its
                snapshot; resume: 8 laps, serialize, deserialize into a new
                streaming session, laps 9-16 (ATE below half of
                odometry's, a closure after the load); merge: 8 submaps of
                the snapshot 20 m apart, one perturbed by (0.3 m, -0.2 m,
                3 deg) and auto-aligned back (within 0.1 m and 1 deg, the
                CPU's correction to 1e-5), merged on both routes
                (bit-equal); the CLI on the CARMEN fixture, classic and
                streaming (test_fixture_end_to_end's bars), and `cli
                merge` of the two; K1-K3 launches of the align and CLI
                paths by grid;
 11. modes    — config 3's lifelong deployment (scripts/bench_suite.py's
                warehouse, 1081 beams, seed 11, cut to its first 6,400
                raw scans) through SlamSession(streaming=True,
                drain_every=96, lifelong=...) with
                marginalize_on_removal: survivors-ATE below half of their
                odometry's, a closure, second-half growth below 0.02
                nodes/scan, a marginalized removal; then on that map 200
                scans in localization and 200 back in mapping,
                set_initial_pose (relocalized within 0.1 m) and
                manual_loop_closure (card and CPU equal to 1e-6 m);
                config 4's localization against a 10,000-node prior (cut
                from 100,010) over 4 rows out and back, LOCALIZE_AT_POSE
                with drains of 16: rmse below 0.35 m, the graph bounded by
                prior + buffer, an accepted closure, a windowed solve, and
                with SPEC_LOOP off the same trajectory bit for bit; K1-K3
                launches by grid, every grid one that phase 2 checked;
 11b. config2 — BASELINE config 2 whole (configs_torch.config2): the
                apartment's 40 laps (5,080 raw scans) through
                SlamSession(streaming=True, drain_every=96), a warm pass
                and a timed pass: ATE below 0.15 m (and half of
                odometry's), a closure, K1-K3 launches by grid at grids
                phase 2 checked, a pass's peak device memory over its
                start (`# config2:`); each pass's session closed;
 11c. config5 — BASELINE config 5 at a cut (configs_torch.config5,
                scripts/bench_merge500k.py's run): 8 sessions of 2,500
                nodes at 61 beams (20,000 nodes, 32,768 padded) built,
                saved, loaded, each auto-aligned against the one before
                (7 of 7), merged at 0.1 m on the card's route and
                natively (bit-equal), the joint graph solved by
                distributed_lm_solve on a mesh of one (3 LM steps, 50 CG
                iterations, Schwarz blocks of 512) twice, replayed
                bit-equal, within 1 cm of host_sparse_lm of the same LM
                steps; K1 (head form), K2, K3, K5, K7 and K8 held to their
                plain versions at the align geometry (G 441, hk 1, 61
                beams) on the match auto_align makes of session 1 against
                session 0, K2 and K3 also on the adversarial patterns, and
                timed; the alignment's K1-K3 launches at G 441 (`#
                config5:`);
 12. dist     — under a world-size-1 NCCL group on the card: lm_solve's
                three device tiers, each one program (the LM loop and its
                CG loop CUDA-graph WHILE nodes, K10) held bit for bit to
                the same functions run from the host's Python loop
                (LMLoop.run_eager) and launched again: poses, chi2, LM and
                CG iterations, one host read a solve, no cudaLaunchKernel
                inside the loop's launch (one LM step traced each way);
                the PCG tier with PCR on scripts/bench_dist.py's
                12,288-node snake padded to 16,384 nodes (f32), the
                Thomas tier (K9's sweeps) on a 3,072-node snake, the
                dense tier on a 1,500-node snake padded to 2,048, each
                against host_sparse_lm (chi2 within 0.2% of the host
                solution's on the same f32 arrays; positions within
                PCG_TIER_MAX_DXY); K9 and K10 launched there (counts from
                0); K10's cost a condition test (while_test_ms, CUDA
                events); K9 against the plain sweeps at n = 2,100 and
                3,072, the Thomas tier's (f32 within 1e-5, f64 within
                1e-12 of each output's largest magnitude) and timed at n
                = 2,100, 3,072, 4,095 and 100,000 in f32 and f64, and the
                sweeps against PCR at n = 2,100 (rtol 1e-4, atol 1e-5);
                distributed_lm_solve on
                that graph in f32 and f64 (within 1 cm of the host solve,
                no LM step at the CG cap) and with schwarz=False, each
                graphed (NCCL's all_reduces inside the graphs), eager and
                graphed again (the programs replayed), with the same
                checks; match_chains_sharded on the bench
                workload's loop chains (rows bit-equal to
                match_scans_batch, K1-K3 launches at G 561 counted); the
                sharded raster of phase 10's main-path map (2,017 scans) and
                merge (16,136 scans) bit-equal to create_from_scans on the
                card, and the halo refresh's windows;
 13. the kernels line (JSON), the card's name and power limit, and the
     last line {"ok": true, "device": {...}}.

It exits non-zero with no result when no CUDA device is present. It imports
nothing of JAX and nothing of the JAX package. The workloads and the
session runs come from workloads_torch.py, configs 2 and 5 from
configs_torch.py.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

from workloads_torch import (
    LAP, LOOP_ROWS, PATH_KERNELS, SPEC_COUNTS, STREAM_KERNELS, bench_workload,
    build_prior_snapshot, card_line, graph_pool_bytes, grid_check,
    grid_summary, launches_by_grid, lifelong_bars, lifelong_cfg,
    lifelong_run, loc_circuit, loc_cfg, localization_run, merge_laser,
    occupancy_route, run_mapping, run_session, same_grid, stage_times,
    timed_host, warehouse, warehouse_workload,
)

MEM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
SCALAR_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
# the scan step's kernels, which replace no Pallas kernel
STEP_KERNELS = ("ring_points", "score_tail", "stream_update")
REPLACES = {
    "scatter_occupancy": "slam_toolbox_tpu/kernels/match_pallas.py:234",
    "smear_quantize": "slam_toolbox_tpu/kernels/match_pallas.py:394",
    "score_windows": "slam_toolbox_tpu/kernels/match_pallas.py:119",
    "score_ceiling": "scripts/exp_roofline.py:123",
    # no Pallas kernel: the JAX functions whose XLA-fused code each is
    "ring_points": "slam_toolbox_tpu/mapper/streaming.py:165 "
                   "_stream_raster_impl (prior, points, FindValidPoints); "
                   "slam_toolbox_tpu/kernels/loop_verify.py:47 _chain_raster",
    "score_tail": "slam_toolbox_tpu/kernels/match.py:717 _score_impl after "
                  "the window sums (:599 _tie_average, :626 "
                  "_positional_cov, :656 _angular_cov, :493 _score_tensor)",
    "stream_update": "slam_toolbox_tpu/mapper/streaming.py:223 "
                     "_stream_update_impl (pose, ring push, eviction, row)",
    "chain_thomas": "slam_toolbox_tpu/solver/chain_precond.py:82 factorize's "
                    "lax.scan, :162 and :172 apply's forward and backward "
                    "lax.scans",
    "device_loop": "slam_toolbox_tpu/solver/se2_solver.py:457 lm_solve's LM "
                   "lax.while_loop, :414 its CG lax.while_loop",
}
# the solver's kernels (phase 12), which replace no Pallas kernel: K9, the
# block Thomas factorization and sweeps, and K10, the WHILE nodes
SOLVER_KERNELS = ("chain_thomas", "device_loop")
# H100 SXM f64 outside the tensor cores (NVIDIA's data sheet), for K9's
# f64 bound
F64_OPS_PER_S = 34e12
# device time per launch from CUDA graph replays, where phase 2 takes it;
# for the step kernels also the device time of the PyTorch ops each one
# replaces (its plain version, captured the same way)
DEVICE_KEYS = ("device_ms", "library_device_ms", "replaced_device_ms")
# the adversarial occupancy patterns' geometries: both matchers', a grid
# one row past a multiple of 32 with a single tap and with hk > 32 (where
# the smear's row pass walks words beyond its three), the bench grid with
# hk 900 (a block's row values past its shared memory: the scratch
# instantiation) and a grid narrower than its taps (hk clamped to G - 1)
PATTERN_GEOMETRIES = ((2051, 20), (561, 1), (257, 0), (257, 40),
                      (2051, 900), (257, 300))


def event_ms(fn, n: int, warm: int = 3) -> float:
    """Mean device time of `fn` over n calls, CUDA events, after warm-up."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def graph_ms(fn, n: int, replays: int = 20):
    """Mean device time of one `fn` call: n calls captured in one CUDA
    graph, replayed, timed with CUDA events. A replay has no host launch
    cost, so a kernel of tens of microseconds is timed by what the card
    does and not by the wrapper's host path. Returns (ms, the launches of
    `fn`'s kernel that the replays made), since the wrappers count no
    call made under capture."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (replays * n), n * (replays + 1)


def cells_read(G: int, d, cand_x0, cand_y0, ny: int, nx: int, finite):
    """(distinct in-grid raster cells, gathers) of a window-sum kernel:
    cell (cand_y0 + 2i + dy, cand_x0 + 2j + dx) for the (dx, dy) of every
    finite beam of d (na, B, 2) and every lattice cell (i, j). The first
    feeds the bound's bytes; the second, the (heading, beam, cell) triples
    whose cell is in the grid, is the loads and adds the kernel makes."""
    import torch

    dev = d.device
    seen = torch.zeros(G * G + 1, dtype=torch.bool, device=dev)
    cy = cand_y0.to(torch.int64) + 2 * torch.arange(ny, device=dev)
    cx = cand_x0.to(torch.int64) + 2 * torch.arange(nx, device=dev)
    gathers = 0
    for a in range(d.shape[0]):
        gy = d[a, finite, 1].to(torch.int64)[:, None] + cy[None, :]
        gx = d[a, finite, 0].to(torch.int64)[:, None] + cx[None, :]
        ok = (((gy >= 0) & (gy < G))[:, :, None]
              & ((gx >= 0) & (gx < G))[:, None, :])
        gathers += int(ok.sum())
        seen[torch.where(ok, gy[:, :, None] * G + gx[:, None, :],
                         G * G).reshape(-1)] = True
    return int(seen[:G * G].sum()), gathers


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def loop_chain(data, radius: float):
    """(chain, query) indices into `data` built as pose_graph builds a loop
    chain: a run of consecutive first-lap scans within `radius` of a
    second-lap query, taking the query whose run is longest (the largest
    base set the loop matcher gets on this workload)."""
    import numpy as np

    xy = np.array([tp[:2] for _, tp in data])
    half = len(xy) // 2
    best = (0, 0, half)
    for q in range(half, len(xy)):
        near = np.hypot(*(xy[:half] - xy[q]).T) < radius
        start = 0
        for i in range(half + 1):
            if i == half or not near[i]:
                if i - start > best[1] - best[0]:
                    best = (start, i, q)
                start = i + 1
    return list(range(best[0], best[1])), best[2]


def kernel_inputs(matcher, base, query, dev):
    """Main-path inputs of the three kernels for one matcher, formed as the
    streaming path forms them: the world points and device
    FindValidPoints of the base scans' packs at f32 poses, seen from the
    query's pose (P = scans x beams, no padding), the last 8 points made
    valid points at -1e9, NaN and far outside the grid; the coarse rotated
    tables of the query with every tenth beam marked non-finite."""
    import numpy as np
    import torch

    from slam_toolbox_tpu_torch.device import upload
    from slam_toolbox_tpu_torch.kernels.match import _f32, _scan_device_cache
    from slam_toolbox_tpu_torch.kernels.step_cuda import _rotated_tables
    from slam_toolbox_tpu_torch.mapper.streaming import _ring_points, scan_pack

    center = np.asarray(query.sensor_pose, np.float64)
    cen = upload(center.astype(np.float32), dev)
    packs = upload(np.stack([scan_pack(s) for s in base]), dev)
    poses = upload(np.stack([s.sensor_pose for s in base]).astype(np.float32),
                   dev)
    pts, valid = _ring_points(packs, poses, None, cen[:2])
    off = cen[:2] - _f32(0.5 * (matcher.G - 1) * matcher.resolution)
    pts, valid = pts.clone(), valid.clone()
    pts[-8:-6] = -1e9
    pts[-6:-4] = float("nan")
    pts[-4:-2] = 1e6
    pts[-2:] = cen[:2] + 2.0 * matcher.G * matcher.resolution
    valid[-8:] = True
    local, finite = _scan_device_cache(query, dev)
    finite = finite.clone()
    finite[::10] = False
    na = matcher._na_coarse
    ang = torch.tensor(
        center[2] - matcher.coarse_angle_offset
        + matcher.coarse_angle_resolution * np.arange(na), dtype=torch.float32,
        device=dev,
    )
    d = _rotated_tables(ang, local, np.float32(matcher.scale).item())
    return dict(pts=pts, valid=valid, off=off, d=d.contiguous(),
                finite=finite, ncand=len(matcher._xy_coarse))


def check_kernels(matcher, inp, tag: str):
    """Hold each kernel against its plain version on the card (bit-equal
    required) and time both. Returns {kernel: record}."""
    import torch

    from slam_toolbox_tpu_torch.kernels import match_cuda as mc
    from slam_toolbox_tpu_torch.kernels import rasterize as rz

    G, hk = matcher.G, matcher.half_kernel
    scale = float(torch.tensor(matcher.scale, dtype=torch.float32))
    pts, valid, off = inp["pts"], inp["valid"], inp["off"]
    d, finite, n = inp["d"], inp["finite"], inp["ncand"]
    w = matcher._w
    out = {}

    # K2: scatter into packed words
    P = pts.shape[0]
    words = mc.scatter_occupancy(pts, valid, off, scale, G)
    words_p = rz.scatter_occupancy_plain(pts, valid, off, scale, G)
    torch.cuda.synchronize()
    if not torch.equal(words, words_p):
        raise AssertionError(f"{tag} scatter_occupancy != plain")
    ix, iy, inb = rz.cell_coords(pts, valid, off, scale, G)
    idx = (iy[inb], ix[inb])
    ones = torch.ones(idx[0].shape[0], dtype=torch.uint8, device=pts.device)
    n_in = int(inb.sum())
    lib_fn = (lambda: torch.zeros((G, G), dtype=torch.uint8,
                                  device=pts.device).index_put_(idx, ones))
    out["scatter_occupancy"] = dict(
        err=int((words.long() - words_p.long()).abs().max()),
        ms=event_ms(lambda: mc.scatter_occupancy(pts, valid, off, scale, G),
                    50),
        device_ms=graph_ms(
            lambda: mc.scatter_occupancy(pts, valid, off, scale, G), 50)[0],
        plain_ms=event_ms(
            lambda: rz.scatter_occupancy_plain(pts, valid, off, scale, G),
            20),
        library_ms=event_ms(lib_fn, 50),
        library_device_ms=graph_ms(lib_fn, 50)[0],
        # the packed words written once; a cell test and an OR per point
        bound=bound(P * 9 + 8 + 4 * words.numel(), 12 * n_in),
        shape=f"P={P} G={G}",
    )

    # K3: smear + quantize from the packed words
    grid = mc.smear_quantize(words, w, G, hk)
    grid_p = rz.smear_quantize_plain(words, w, G, hk)
    torch.cuda.synchronize()
    if not torch.equal(grid, grid_p):
        raise AssertionError(f"{tag} smear_quantize != plain")
    K = 2 * hk + 1
    out["smear_quantize"] = dict(
        err=int((grid.int() - grid_p.int()).abs().max()),
        ms=event_ms(lambda: mc.smear_quantize(words, w, G, hk), 50),
        device_ms=graph_ms(lambda: mc.smear_quantize(words, w, G, hk),
                           50)[0],
        plain_ms=event_ms(lambda: rz.smear_quantize_plain(words, w, G, hk),
                          20),
        library_ms=None,
        # what this raster needs: every cell written once; the operations
        # of the cells with an occupied cell within reach (the others are
        # 0): 3 per column tap k = 0..hk (pair max, product, running max),
        # 2 for the row pass (nearer distance, tap select), 2 to quantize
        bound=bound(4 * words.numel() + 4 * K + G * G + 1,
                    int((grid_p[:-1] != 0).sum()) * (3 * (hk + 1) + 4)),
        shape=f"G={G} hk={hk}",
        empty_tile_rows=empty_tile_rows(words, G, hk),
    )

    # K1: window sums, at the main path's origin and straddling both edges
    na, B = d.shape[0], d.shape[1]
    cmid = (G - 1) // 2 - (n - 1)
    err = 0
    for cx0, cy0 in ((cmid, cmid), (-25, G - 30), (G - 30, -25)):
        cx = torch.tensor([cx0], dtype=torch.int32, device=d.device)
        cy = torch.tensor([cy0], dtype=torch.int32, device=d.device)
        s = mc.score_windows(grid, G, d, cx, cy, n, n, finite)
        s_p = mc.score_windows_plain(grid, G, d, cx, cy, n, n, finite)
        torch.cuda.synchronize()
        if not torch.equal(s, s_p):
            raise AssertionError(
                f"{tag} score_windows != plain at ({cx0}, {cy0})")
        err = max(err, int((s - s_p).abs().max()))
    n_cases = check_window_cases(grid, G, d, finite, n, tag)
    cx = torch.tensor([cmid], dtype=torch.int32, device=d.device)
    cells, gathers = cells_read(G, d, cx, cx, n, n, finite)
    out["score_windows"] = dict(
        err=err,
        ms=event_ms(
            lambda: mc.score_windows(grid, G, d, cx, cx, n, n, finite), 50),
        device_ms=graph_ms(
            lambda: mc.score_windows(grid, G, d, cx, cx, n, n, finite),
            50)[0],
        beam_classes=beam_classes(G, d, cx, cx, n, n, finite),
        cases_checked=n_cases,
        plain_ms=event_ms(
            lambda: mc.score_windows_plain(grid, G, d, cx, cx, n, n, finite),
            20),
        library_ms=None,
        bound=bound(cells + 8 + na * B * 8 + B + na * n * n * 4, gathers),
        shape=f"G={G} na={na} B={B} {n}x{n}",
    )
    for name, r in out.items():
        print_record(tag, name, r)
    return out, grid


def clone_state(state):
    import torch

    return {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in state.items()}


def step_inputs(matcher, base, query, dev):
    """Main-path inputs of the scan step's four kernels at one matcher's
    geometry, formed as the paths form them: the base scans' packs as a
    chain of bucket len(base) + 2 (poses a strided column slice of a chain
    record, the last two slots pads), and as a drain state whose ring
    holds all but one of them from slot 3 on (one slot empty), with the
    query at batch row 1 and the step pointing at it; the query's
    center_off, local points (every tenth beam marked non-finite, as
    kernel_inputs marks them) and pack."""
    import numpy as np
    import torch

    from slam_toolbox_tpu_torch.device import upload
    from slam_toolbox_tpu_torch.kernels.match import _f32, _scan_device_cache
    from slam_toolbox_tpu_torch.mapper import streaming as ts

    C, B = len(base), len(query.ranges)
    packs = np.stack([ts.scan_pack(s) for s in base])
    poses = np.stack([s.sensor_pose for s in base]).astype(np.float32)
    rec = np.zeros((C + 2, 5), np.float32)
    rec[:C, 1:4] = poses
    rec[:C, 4] = 1.0
    chain = np.zeros((C + 2, B, 8), np.float32)
    chain[:, :, 6] = -1.0
    chain[:C] = packs
    half = _f32(0.5 * (matcher.G - 1) * matcher.resolution)
    center = np.asarray(query.sensor_pose, np.float32)
    center_off = np.concatenate([center, center[:2] - np.float32(half)])

    st = ts._new_state(C, B, 16, 2, dev)
    for k in range(C - 1):
        slot = (3 + k) % C
        st["ring_pack"][slot] = upload(packs[k], dev)
        st["ring_pose"][slot] = upload(poses[k], dev)
        st["ring_slot_valid"][slot] = True
    st["head"].fill_(3)
    st["count"].fill_(C - 1)
    st["last_odom"].copy_(upload(base[C - 2].odom_pose.astype(np.float32),
                                 dev))
    st["last_corrected"].copy_(upload(
        base[C - 2].corrected_pose.astype(np.float32), dev))
    qpack = upload(ts.scan_pack(query), dev)
    st["batch_packs"][1] = qpack
    st["batch_odoms"][1] = upload(query.odom_pose.astype(np.float32), dev)
    st["step"].fill_(1)
    local, finite = _scan_device_cache(query, dev)
    finite = finite.clone()
    finite[::10] = False
    return dict(
        chain=upload(chain, dev), rec=upload(rec, dev),
        center_off=upload(center_off.astype(np.float32), dev), local=local,
        finite=finite, state=st, half=half, scan_pack=qpack,
        odom=upload(query.odom_pose.astype(np.float32), dev),
        offset_pose=upload(np.asarray(query.laser.offset_pose, np.float32),
                           dev))


def check_step_kernels(matcher, si, grid, tag, path, timing=True):
    """Hold the scan step's four kernels against their plain versions on
    the card at one matcher's geometry, on step_inputs and edge cases, and
    (with `timing`) time each on the path's inputs: the wrapper by CUDA
    events, the kernel and the PyTorch ops it replaces (its plain
    version) by CUDA graph replays. `path` is (penalize, refine, step
    mode) as the main path runs this geometry. Integer and elementwise
    outputs must be bit-equal; score_tail's coarse best and tie count
    too, its means within step_cuda.MEAN_ATOL, its covariances within
    COV_RTOL of their scale, and its fine and angular parts bit-equal to
    the plain version's at the kernel's means. Returns {kernel: record}."""
    import torch

    from slam_toolbox_tpu_torch.kernels import step_cuda as sc

    G, dev = matcher.G, grid.device
    kw = matcher._score_args
    penalize, refine, step_mode = path
    pens = (kw["dist_var_penalty"], kw["ang_var_penalty"],
            kw["min_dist_pen"], kw["min_ang_pen"])
    n = len(matcher._xy_coarse)
    na, naf = kw["na_coarse"], kw["na_fine"]
    st, offset, half = si["state"], si["offset_pose"], si["half"]
    K, B = st["ring_pack"].shape[0], st["ring_pack"].shape[1]
    err = collections.Counter()
    cases = collections.Counter()

    def equal(name, what, a, b):
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"{tag} {name} != plain: {what}")
        cases[name] += 1

    def same_state(name, what, a, b):
        for k, v in a.items():
            if isinstance(v, torch.Tensor):
                equal(name, f"{what}, state[{k!r}]", v, b[k])

    # K5, chain mode: the chain record (strided poses, pad slots masked),
    # no mask, and an edge chain (every 7th beam's flags cleared: NaN
    # beams; a run of beams with no delimiter)
    chain, rec, vp = si["chain"], si["rec"], si["center_off"][:2]
    edge = chain.clone()
    edge[:, ::7, 7] = 0.0
    edge[:, 100:140, 6] = -1.0
    C = chain.shape[0]
    for what, args in (
            ("chain", (chain, rec[:, 1:4], rec[:, 4] > 0)),
            ("no mask", (chain[:C - 2], rec[:C - 2, 1:4].contiguous(),
                         None)),
            ("edge chain", (edge, rec[:, 1:4], rec[:, 4] > 0))):
        a = sc.ring_points(*args, vp, G)
        b = sc.ring_points_plain(*args, vp)
        equal("ring_points", f"{what} points", a[0], b[0])
        equal("ring_points", f"{what} validity", a[1], b[1])
    # step mode on copies of the state, and with the ring empty
    empty = clone_state(st)
    empty["ring_slot_valid"].zero_()
    for what, base in (("step", st), ("empty ring", empty)):
        s1, s2 = clone_state(base), clone_state(base)
        a = sc.ring_points_step(s1, offset, half, G)
        b = sc.ring_points_step_plain(s2, offset, half)
        equal("ring_points", f"{what} points", a[0], b[0])
        equal("ring_points", f"{what} validity", a[1], b[1])
        same_state("ring_points", what, s1, s2)
    # a ring of WIDE_BEAMS beams (past one round of two beams a thread, so
    # the kernel reads the earlier rounds' rows again), both modes
    wide = wide_ring(dev)
    a = sc.ring_points(wide["ring_pack"], wide["ring_pose"],
                       wide["ring_slot_valid"], vp, G)
    b = sc.ring_points_plain(wide["ring_pack"], wide["ring_pose"],
                             wide["ring_slot_valid"], vp)
    equal("ring_points", "wide chain points", a[0], b[0])
    equal("ring_points", "wide chain validity", a[1], b[1])
    s1, s2 = clone_state(wide), clone_state(wide)
    a = sc.ring_points_step(s1, offset, half, G)
    b = sc.ring_points_step_plain(s2, offset, half)
    equal("ring_points", "wide step points", a[0], b[0])
    equal("ring_points", "wide step validity", a[1], b[1])
    same_state("ring_points", "wide step", s1, s2)

    # K1's head form against the plain head then the plain sums: the
    # path's local points (the step's are the pack's strided column), a
    # heading at pi, a center whose lattice leaves the grid, no finite
    # beam
    co = si["center_off"]
    co_pi = co.clone()
    co_pi[2] = 3.1415925
    co_far = co.clone()
    co_far[3] = co[0] - 0.1 * matcher.resolution
    co_far[4] = co[1] + G * matcher.resolution
    strided = si["scan_pack"][:, 0:2]
    fin = si["finite"]
    for what, c, loc, f in (
            ("center", co, si["local"], fin),
            ("strided local", co, strided, fin),
            ("heading pi", co_pi, si["local"], fin),
            ("off the grid", co_far, si["local"], fin),
            ("no finite beam", co, si["local"], torch.zeros_like(fin))):
        args = head_args(matcher, grid, c, loc, f)
        for x, y, part in zip(sc.score_windows_head(*args),
                              sc.score_windows_head_plain(*args),
                              ("sums", "headings")):
            equal("score_windows_head", f"{what} {part}", x, y)

    # K7 on K1's head-form sums: the path's flags and the other
    # three, no finite beam, an all-zero raster, a flat raster (every cell
    # ties; unpenalized), a lattice half outside the grid
    local, finite = si["local"], si["finite"]
    zeros = torch.zeros_like(grid)
    flat = torch.full_like(grid, 50)
    flat[-1] = 0
    co_edge = co.clone()
    co_edge[3] = co[0] - 0.1 * matcher.resolution

    def tail_args(g, c, fin, pz, rf):
        return score_tail_args(matcher, g, c, local, fin, pz, rf)

    tail_cases = [(f"penalize {pz} refine {rf}", grid, co, finite, pz, rf)
                  for pz, rf in ((penalize, refine), (not penalize, refine),
                                 (penalize, not refine),
                                 (not penalize, not refine))]
    tail_cases += [
        ("no finite beam", grid, co, torch.zeros_like(finite), True, True),
        ("all-zero raster", zeros, co, finite, True, True),
        ("ties", flat, co, finite, False, True),
        ("off the grid", grid, co_edge, finite, True, True)]
    for what, g, c, fin, pz, rf in tail_cases:
        args = tail_args(g, c, fin, pz, rf)
        ak = torch.zeros(sc.aux_len(naf), device=dev)
        ap = torch.zeros_like(ak)
        pk = sc.score_tail(*args, aux=ak)
        pp = sc.score_tail_plain(*args, aux=ap)
        torch.cuda.synchronize()
        equal("score_tail", f"{what}: coarse tie count and best", ak[:2],
              ap[:2])
        mean_err = float((ak[2:5] - ap[2:5]).abs().max())
        if mean_err > sc.MEAN_ATOL:
            raise AssertionError(f"{tag} score_tail {what}: coarse mean "
                                 f"{mean_err} from plain")
        if rf:
            fp = sc.fine_parts_plain(
                g, G, c, local, fin, ak[2:5], ak[7:10], kw["x_off_f"],
                kw["y_off_f"], kw["scale"], kw["fine_angle_offset"],
                kw["fine_angle_res"], pz, pens, naf)
            ref = ak.clone()
            sc.fill_aux_fine(ref, fp, ak[7:10])
            equal("score_tail", f"{what}: fine and angular parts at the "
                  "kernel's means", ak, ref)
        if torch.equal(ak[2:5], ap[2:5]):
            equal("score_tail", f"{what}: best", pk[0], pp[0])
        scale = float(pp[[4, 8, 12]].abs().max().clamp_min(1e-6))
        e_mean = float((pk[1:4] - pp[1:4]).abs().max())
        e_cov = float((pk[4:] - pp[4:]).abs().max()) / scale
        if e_mean > sc.MEAN_ATOL or e_cov > sc.COV_RTOL:
            raise AssertionError(f"{tag} score_tail {what}: mean {e_mean}, "
                                 f"covariance {e_cov} of its scale")
        err["score_tail"] = max(err["score_tail"],
                                float((pk - pp).abs().max()))
        err["score_tail_mean"] = max(err["score_tail_mean"], e_mean,
                                     mean_err)
        err["score_tail_cov_rel"] = max(err["score_tail_cov_rel"], e_cov)

    # K7 repeats bit for bit: TAIL_REPEATS launches on the path's inputs
    path_args = tail_args(grid, co, finite, penalize, refine)
    geometry = sc.score_tail_launch(na, n, n, B, naf)
    aux0 = torch.zeros(sc.aux_len(naf), device=dev)
    packed0 = sc.score_tail(*path_args, aux=aux0)
    repeats = []
    for _ in range(TAIL_REPEATS):
        repeats.append(torch.zeros_like(aux0))
        repeats.append(sc.score_tail(*path_args, aux=repeats[-1]))
    torch.cuda.synchronize()
    for k in range(0, len(repeats), 2):
        if not (torch.equal(repeats[k], aux0)
                and torch.equal(repeats[k + 1], packed0)):
            raise AssertionError(f"{tag} score_tail: launch {k // 2} of "
                                 f"{TAIL_REPEATS} differs from the first")

    # K7's streamed and wide modes, forced through the geometry tuple,
    # against the resident mode that score_tail_launch picks here: output
    # and aux bit-equal under every flag pair; the clusters the card holds
    # of each
    streamed = geometry[:2] + (
        sc.score_tail_smem(na, n, n, B, geometry[0], sc.TAIL_STREAMED),
        sc.TAIL_STREAMED)
    wide = geometry[:2] + (0, sc.TAIL_WIDE)
    for pz, rf in ((False, False), (False, True), (True, False),
                   (True, True)):
        args = tail_args(grid, co, finite, pz, rf)
        got = []
        for geom in (geometry, streamed, wide):
            aux = torch.zeros(sc.aux_len(naf), device=dev)
            got.append((sc._launch_score_tail(args, aux, geom), aux))
        for k, mode in ((1, "streamed"), (2, "wide")):
            what = f"{mode} = resident, penalize {pz} refine {rf}"
            equal("score_tail", f"{what}: output", got[k][0], got[0][0])
            equal("score_tail", f"{what}: aux", got[k][1], got[0][1])
    clusters = {sc.TAIL_MODES[g[3]]: sc.tail_clusters(g, dev)
                for g in (geometry, streamed, wide)}

    # K8 on copies of the state, after the path's match: the path (a
    # count eviction: the ring is above run_buffer_size), no eviction, a
    # distance eviction, the first scan, the result ring's last row
    packed = sc.score_tail(*path_args)
    eye9 = torch.eye(3, device=dev).reshape(-1)
    first = clone_state(st)
    first["count"].zero_()
    first["ring_slot_valid"].zero_()
    wrap = clone_state(st)
    wrap["ridx"].fill_(wrap["results"].shape[0] - 1)
    upd = (packed, co, si["scan_pack"], si["odom"], offset, eye9)
    for what, base, rbs, max_sq in (
            ("path", st, K - 3, 9.0), ("no eviction", st, 100, 1e6),
            ("distance", st, 100, 1e-4), ("first scan", first, K - 3, 9.0),
            ("ridx wrap", wrap, K - 3, 9.0)):
        s1, s2 = clone_state(base), clone_state(base)
        sc.stream_update(*upd, s1, rbs, max_sq, G)
        sc.stream_update_plain(*upd, s2, rbs, max_sq, G)
        same_state("stream_update", what, s1, s2)

    out = {name: dict(err=err[name], cases_checked=cases[name],
                      library_ms=None)
           for name in STEP_KERNELS + ("score_windows_head",)}
    out["score_tail"].update(
        mean_err=err["score_tail_mean"], cov_rel_err=err["score_tail_cov_rel"],
        repeats_equal=TAIL_REPEATS, mode=sc.TAIL_MODES[geometry[3]],
        cluster=dict(ctas=geometry[0], threads=geometry[1],
                     dynamic_smem_bytes=geometry[2],
                     active_clusters=clusters))
    if not timing:
        return out

    # the path's calls, timed: the wrapper, the kernel (graph replays)
    # and its plain version (event-timed, and replayed: the device time
    # of the PyTorch ops the kernel replaces)
    head_local = strided if step_mode else local
    path_head = head_args(matcher, grid, co, head_local, finite)
    ts_ = clone_state(st)
    tu = clone_state(st)
    mode = "step" if step_mode else "chain"
    calls = {
        "ring_points": (
            (lambda: sc.ring_points_step(ts_, offset, half, G),
             lambda: sc.ring_points_step_plain(ts_, offset, half))
            if step_mode else
            (lambda: sc.ring_points(chain, rec[:, 1:4], rec[:, 4] > 0, vp,
                                    G),
             lambda: sc.ring_points_plain(chain, rec[:, 1:4], rec[:, 4] > 0,
                                          vp))),
        "score_windows_head": tuple(
            (lambda f=f: f(*path_head))
            for f in (sc.score_windows_head, sc.score_windows_head_plain)),
        "score_tail": (lambda: sc.score_tail(*path_args),
                       lambda: sc.score_tail_plain(*path_args)),
        "stream_update": (
            lambda: sc.stream_update(*upd, tu, K - 3, 9.0, G),
            lambda: sc.stream_update_plain(*upd, tu, K - 3, 9.0, G)),
    }
    # bytes each function must move once and its operations on this run's
    # inputs: the chain's or ring's packs (32 B a beam) and poses, the
    # points and validity out (9 B a beam), about 16 operations a beam;
    # the distinct raster cells the window sums read, the query's beams
    # (9 B), the sums out (4 B each), an add a gather and 12 operations a
    # (heading, beam) rotation; the coarse sums (4 B each, about 10
    # operations each), the
    # distinct raster cells of the fine and angular gathers, the query's
    # beams (9 B), about 30 operations a (fine heading, beam) pair; the
    # pack pushed (read and written) and the K ring poses
    Cc = K if step_mode else C
    fine_cells = tail_cells(matcher, path_args, pens) if refine else 0
    _, d_path, cand0 = sc.score_head_plain(
        co, head_local, kw["x_off_c"], kw["y_off_c"], kw["scale"],
        kw["coarse_angle_offset"], kw["coarse_angle_res"], na)
    cells, gathers = cells_read(G, d_path, cand0[0:1], cand0[1:2], n, n,
                                finite)
    nbytes = {
        "ring_points": Cc * B * 41 + Cc * 13 + (B * 65 + 64 if step_mode
                                                else 8),
        "score_windows_head": (cells + 20 + 8 * n + 8 * n + B * 9
                               + na * n * n * 4 + na * 4),
        "score_tail": 4 * na * n * n + fine_cells + B * 9 + 20 + 52
                      + 4 * 6,
        "stream_update": 13 * 4 + 20 + 2 * B * 32 + K * 12 + 13 * 4 + 64,
    }
    ops = {"ring_points": 16 * Cc * B,
           "score_windows_head": gathers + 12 * na * B,
           "score_tail": 10 * na * n * n + (30 * naf * B if refine else 0),
           "stream_update": 6 * K + 60}
    shapes = {
        "ring_points": f"{mode} C={Cc} B={B}",
        "score_windows_head": f"G={G} na={na} B={B} {n}x{n} head form",
        "score_tail": f"na={na} {n}x{n} B={B} penalize={penalize} "
                      f"refine={refine}",
        "stream_update": f"K={K} B={B}",
    }
    for name, (kern, plain) in calls.items():
        out[name].update(
            ms=event_ms(kern, 50), device_ms=graph_ms(kern, 50)[0],
            plain_ms=event_ms(plain, 20),
            replaced_device_ms=graph_ms(plain, 20)[0],
            bound=bound(nbytes[name], ops[name]), shape=shapes[name])
        print_record(tag, name, out[name])
    tail = out["score_tail"]
    tail["streamed_device_ms"] = graph_ms(
        lambda: sc._launch_score_tail(path_args, None, streamed), 50)[0]
    if TAIL_PHASE_LIB is not None:
        tail["phase_ms"] = tail_phase_ms(
            TAIL_PHASE_LIB, lambda: sc._launch_score_tail(
                path_args, None, geometry, TAIL_PHASE_LIB))
        tail["geometries"] = tail_geometries(path_args, packed0, aux0, tag)
        print(f"# {tag} score_tail cluster {tail['cluster']} "
              f"{tail['mode']} mode: phases "
              f"{json.dumps(dict(zip(TAIL_PHASES, tail['phase_ms'])))} ms; "
              f"{TAIL_REPEATS} launches bit-identical; streamed mode "
              f"{tail['streamed_device_ms']} ms, bit-equal; other "
              f"geometries {json.dumps(tail['geometries'])}", flush=True)
    return out


# K5's wide ring: beams a scan, slots
WIDE_BEAMS = 2500
WIDE_SLOTS = 6


def wide_ring(dev, seed: int = 3, K: int = WIDE_SLOTS, B: int = WIDE_BEAMS):
    """A drain state whose ring holds K packs of B random beams (local,
    anchor and current points within 10 m, delimiter indices in [-1, B),
    every flag pair), one slot invalid, at random poses, with a random
    batch row 0 and the step at it."""
    import numpy as np
    import torch

    from slam_toolbox_tpu_torch.mapper import streaming as ts

    rng = np.random.default_rng(seed)
    st = ts._new_state(K, B, 4, 2, dev)

    def packs(n):
        p = rng.uniform(-10.0, 10.0, (n, B, 8)).astype(np.float32)
        p[:, :, 6] = rng.integers(-1, B, (n, B))
        p[:, :, 7] = rng.integers(0, 4, (n, B))
        return torch.from_numpy(p).to(dev)

    st["ring_pack"].copy_(packs(K))
    st["ring_pose"].copy_(torch.from_numpy(rng.uniform(
        -5.0, 5.0, (K, 3)).astype(np.float32)).to(dev))
    st["ring_slot_valid"].fill_(True)
    st["ring_slot_valid"][min(2, K - 1)] = False
    st["batch_packs"].copy_(packs(2))
    for key in ("batch_odoms", "last_odom", "last_corrected"):
        st[key].copy_(torch.from_numpy(rng.uniform(
            -3.0, 3.0, tuple(st[key].shape)).astype(np.float32)).to(dev))
    return st


# K8's edge cases: ring slots, and where the eviction's leading run ends
# (inside the first warp, at the warp boundaries 32 and 64, at K; 0 for
# none)
UPDATE_SLOTS = (12, 25, 100, 4096, 4097, 20000)
UPDATE_RUNS = (0, 5, 32, 64)


def update_edge_cases(dev, pack):
    """(what, state, run_buffer_size, max_sq, evictions) of K8's edge
    cases at each of UPDATE_SLOTS: the leading run ending at each of
    UPDATE_RUNS that fits and at K, by count (a ring of K - 1 scans, K
    for the run of K, with run_buffer_size set so that the first n slots
    are over it) and, where n <= K - 2, by distance (the first n slots
    10 m from the pushed pose, the rest 0.5 m, max_sq 1). The ring's head
    sits 7 slots before its end, so the run wraps."""
    import torch

    from slam_toolbox_tpu_torch.mapper import streaming as ts

    B = pack.shape[0]
    out = []
    for K in UPDATE_SLOTS:
        for n in sorted({r for r in UPDATE_RUNS if r < K} | {K}):
            for how in ("count", "distance"):
                if how == "distance" and n > K - 2:
                    continue
                count = K if n == K else K - 1
                st = ts._new_state(K, B, 8, 1, dev)
                head = (K - 7) % K
                st["head"].fill_(head)
                st["count"].fill_(count)
                st["ring_slot_valid"].fill_(True)
                e = torch.arange(K, device=dev)
                slots = (head + e) % K
                st["ring_pose"][slots, 0] = torch.where(
                    e < n, 10.0, 0.5) if how == "distance" else 0.5
                if how == "count":
                    rbs, max_sq = count + 1 - n, 1e30
                else:
                    rbs, max_sq = 10 * K, 1.0
                out.append((f"K {K} run {n} by {how}", st, rbs, max_sq, n))
    return out


def check_update_edges(dev, pack, packed):
    """K8 against its plain version on update_edge_cases: every state
    tensor bit-equal, and the evictions the case was built for. The
    pushed pose is packed[1:4] (packed (13,), its mean at the origin).
    Returns the cases checked."""
    import torch

    from slam_toolbox_tpu_torch.kernels import step_cuda as sc

    co = torch.zeros(5, device=dev)
    odom = torch.tensor([0.1, 0.2, 0.3], device=dev)
    offset = torch.tensor([0.05, -0.02, 0.01], device=dev)
    eye9 = torch.eye(3, device=dev).reshape(-1)
    n_cases = 0
    for what, st, rbs, max_sq, n in update_edge_cases(dev, pack):
        s1, s2 = clone_state(st), clone_state(st)
        sc.stream_update(packed, co, pack, odom, offset, eye9, s1, rbs,
                         max_sq)
        sc.stream_update_plain(packed, co, pack, odom, offset, eye9, s2,
                               rbs, max_sq)
        torch.cuda.synchronize()
        for k, v in s1.items():
            if isinstance(v, torch.Tensor) and not torch.equal(v, s2[k]):
                raise AssertionError(f"stream_update != plain: {what}, "
                                     f"state[{k!r}]")
        K = st["ring_pack"].shape[0]
        got = int(st["count"]) + 1 - int(s1["count"])
        if got != n or int(s1["head"]) != (int(st["head"]) + n) % K:
            raise AssertionError(f"stream_update {what}: {got} evictions")
        n_cases += 1
    return n_cases


# the geometries past each kernel's former limits (check_limits): K1's
# headings (past gridDim.y), lattice (past its 16-bit spans) and raster
# side (offsets past int32: a 2.15 GB raster); K7's fine headings (past
# kMaxFine) and beams (past a CTA's room at 8 bytes a beam); K5's beams
# (past 48 KB of flags, and past a CTA's 227 KB)
LIMIT_HEADINGS = 70000
LIMIT_LATTICE = (2, 70000)
LIMIT_G = 46400
LIMIT_FINE = (65, 200)
LIMIT_TAIL_BEAMS = (27009, 60000)
LIMIT_RING_BEAMS = (49153, 300000)


def window_limit_cases(grid, G, scale, si, dev):
    """(name, raster, G, table-form args after the raster and G, head-form
    args after them) of K1's limit geometries at cells of 1 / scale m:
    LIMIT_HEADINGS headings over the full turn on a 3 x 3 lattice at 16
    beams on `grid`; a LIMIT_LATTICE lattice whose grid lies at the far
    end of its columns (column spans start past 65,535) at 64 beams on
    `grid`; and a LIMIT_G raster of random values with a 26 x 26 lattice
    near its far corner at 8 beams. Tables are random within a few hundred
    cells; the head form takes the path's local points and finite
    mask."""
    import numpy as np
    import torch

    rng = np.random.default_rng(23)
    f32 = dict(dtype=torch.float32, device=dev)

    def table(na, B, reach):
        return torch.from_numpy(rng.integers(
            -reach, reach, (na, B, 2)).astype(np.int32)).to(dev)

    def i32(v):
        return torch.tensor([v], dtype=torch.int32, device=dev)

    local, finite = si["local"], si["finite"]
    step = 2.0 / scale          # a lattice step: two cells
    cases = []
    # headings: the full turn in LIMIT_HEADINGS steps around the center
    na, B = LIMIT_HEADINGS, 16
    c0 = (G - 1) // 2 - 2
    off3 = torch.tensor([-step, 0.0, step], **f32)
    cases.append(("headings", grid, G,
                  (table(na, B, 300), i32(c0), i32(c0), 3, 3, finite[:B]),
                  (si["center_off"], local[:B], finite[:B], off3, off3,
                   scale, 3.14159265, 2 * 3.14159265 / na, na)))
    # lattice: 2 x 70,000, the grid's columns at its far end
    ny, nx = LIMIT_LATTICE
    B = 64
    cx0, cy0 = G + 50 - 2 * (nx - 1), G // 2
    x_off = ((torch.arange(nx, **f32) - 0.5 * (nx - 1)) * step).contiguous()
    y_off = torch.tensor([0.0, step], **f32)
    co = torch.tensor([cx0 / scale + 0.5 * (nx - 1) * step, cy0 / scale,
                       0.1, 0.0, 0.0], **f32)
    cases.append(("lattice", grid, G,
                  (table(3, B, 100), i32(cx0), i32(cy0), ny, nx,
                   finite[:B]),
                  (co, local[:B], finite[:B], x_off, y_off, scale, 0.02,
                   0.02, 3)))
    # raster: LIMIT_G, the lattice's rows past 46,281 (offsets past int32)
    big = torch.randint(0, 101, (LIMIT_G * LIMIT_G + 1,), dtype=torch.int8,
                        device=dev)
    big[-1] = 0
    B = 8
    off26 = ((torch.arange(26, **f32) - 12.5) * step).contiguous()
    co = torch.tensor([(LIMIT_G - 475) / scale, (LIMIT_G - 55) / scale, 0.2,
                       0.0, 0.0], **f32)
    cases.append(("raster", big, LIMIT_G,
                  (table(3, B, 200), i32(LIMIT_G - 500), i32(LIMIT_G - 80),
                   26, 26, finite[:B]),
                  (co, local[:B], finite[:B], off26, off26, scale, 0.02,
                   0.02, 3)))
    return cases


def check_window_limits(grid, G, scale, si, dev, timing=True):
    """K1 in both forms past its narrow instantiation's limits
    (window_limit_cases), each held bit-equal to its plain version (the
    head form to the plain head then the plain sums); with `timing`, each
    form's ms (CUDA events, 3 calls) and its plain version's (1 call).
    Returns {case: record}."""
    import torch

    from slam_toolbox_tpu_torch.kernels import match_cuda as mc
    from slam_toolbox_tpu_torch.kernels import step_cuda as sc

    out = {}
    for name, raster, g, targs, hargs in window_limit_cases(grid, G, scale,
                                                            si, dev):
        d, cx, cy, ny, nx, fin = targs
        table = (raster, g, d, cx, cy, ny, nx, fin)
        head = (raster, g, *hargs)
        s = mc.score_windows(*table)
        s_p = mc.score_windows_plain(*table)
        raw, ang = sc.score_windows_head(*head)
        raw_p, ang_p = sc.score_windows_head_plain(*head)
        torch.cuda.synchronize()
        if not torch.equal(s, s_p):
            raise AssertionError(f"score_windows past its limits ({name}) "
                                 "!= plain")
        if not (torch.equal(raw, raw_p) and torch.equal(ang, ang_p)):
            raise AssertionError(f"score_windows_head past its limits "
                                 f"({name}) != plain")
        if int(s_p.abs().sum()) == 0 or int(raw_p.abs().sum()) == 0:
            raise AssertionError(f"K1 limit case {name}: no sum")
        rec = dict(shape=f"G={g} na={d.shape[0]}/{hargs[-1]} "
                         f"B={d.shape[1]} {ny}x{nx}", cases_checked=2)
        if timing:
            rec.update(
                ms=event_ms(lambda: mc.score_windows(*table), 3),
                plain_ms=event_ms(lambda: mc.score_windows_plain(*table), 1,
                                  warm=0),
                head_ms=event_ms(lambda: sc.score_windows_head(*head), 3),
                head_plain_ms=event_ms(
                    lambda: sc.score_windows_head_plain(*head), 1, warm=0))
        out[name] = rec
        print(f"# limits score_windows {name} [{rec['shape']}]: both forms "
              f"bit-equal to plain; {json.dumps(rec)}", flush=True)
    torch.cuda.empty_cache()
    return out


def hold_tail(what, args, pens, timing=True):
    """K7 on `args` (score_tail's) against its plain version: the coarse
    tie count and best bit-equal, the fine and angular parts bit-equal at
    the kernel's own means, the means within MEAN_ATOL and the covariances
    within COV_RTOL of their scale; a second launch bit-identical. Returns
    a record (mode, errors, ms by CUDA events)."""
    import torch

    from slam_toolbox_tpu_torch.kernels import step_cuda as sc

    (raw, grid, co, local, finite, _, _, _, x_off_f, y_off_f, scale,
     fao, far, _, penalize, *_, G, naf, refine) = args
    na, ny, nx = raw.shape
    geometry = sc.score_tail_launch(na, ny, nx, local.shape[0], naf)
    ak = torch.zeros(sc.aux_len(naf), device=raw.device)
    ap, again = torch.zeros_like(ak), torch.zeros_like(ak)
    pk = sc.score_tail(*args, aux=ak)
    pp = sc.score_tail_plain(*args, aux=ap)
    pk2 = sc.score_tail(*args, aux=again)
    torch.cuda.synchronize()
    if not torch.equal(ak[:2], ap[:2]):
        raise AssertionError(f"score_tail {what}: coarse tie count and best")
    if not (torch.equal(pk, pk2) and torch.equal(ak, again)):
        raise AssertionError(f"score_tail {what}: a second launch differs")
    if refine:
        fp = sc.fine_parts_plain(grid, G, co, local, finite, ak[2:5],
                                 ak[7:10], x_off_f, y_off_f, scale, fao, far,
                                 penalize, pens, naf)
        ref = ak.clone()
        sc.fill_aux_fine(ref, fp, ak[7:10])
        if not torch.equal(ak, ref):
            raise AssertionError(f"score_tail {what}: fine and angular "
                                 "parts")
    cov_scale = float(pp[[4, 8, 12]].abs().max().clamp_min(1e-6))
    e_mean = max(float((pk[1:4] - pp[1:4]).abs().max()),
                 float((ak[2:5] - ap[2:5]).abs().max()))
    e_cov = float((pk[4:] - pp[4:]).abs().max()) / cov_scale
    if e_mean > sc.MEAN_ATOL or e_cov > sc.COV_RTOL:
        raise AssertionError(f"score_tail {what}: mean {e_mean}, covariance "
                             f"{e_cov} of its scale")
    rec = dict(shape=f"na={na} {ny}x{nx} B={local.shape[0]} na_f={naf}",
               mode=sc.TAIL_MODES[geometry[3]], cases_checked=1,
               mean_err=e_mean, cov_rel_err=e_cov)
    if timing:
        rec.update(ms=event_ms(lambda: sc.score_tail(*args), 5),
                   plain_ms=event_ms(lambda: sc.score_tail_plain(*args), 2))
    return rec


def check_tail_limits(matcher, grid, si, dev, timing=True):
    """K7 past its streamed mode at `matcher`'s geometry on `grid`,
    penalized and refined: LIMIT_FINE fine headings over the matcher's
    fine span, and LIMIT_TAIL_BEAMS beams (the path's local points
    repeated with 5 cm of noise, its finite mask repeated), each through
    the wide mode and held to its plain version (hold_tail). Returns
    {case: record}."""
    import numpy as np
    import torch

    kw = matcher._score_args
    pens = (kw["dist_var_penalty"], kw["ang_var_penalty"],
            kw["min_dist_pen"], kw["min_ang_pen"])
    co, local, finite = si["center_off"], si["local"], si["finite"]
    out = {}
    for naf in LIMIT_FINE:
        args = list(score_tail_args(matcher, grid, co, local, finite, True,
                                    True))
        args[12] = 2.0 * kw["fine_angle_offset"] / (naf - 1)
        args[20] = naf
        out[f"fine headings {naf}"] = hold_tail(f"{naf} fine headings",
                                                tuple(args), pens, timing)
    rng = np.random.default_rng(17)
    for B in LIMIT_TAIL_BEAMS:
        reps = -(-B // local.shape[0])
        noise = torch.from_numpy(rng.normal(0.0, 0.05, (B, 2)).astype(
            np.float32)).to(dev)
        loc = (local.repeat(reps, 1)[:B] + noise).contiguous()
        fin = finite.repeat(reps)[:B].contiguous()
        args = score_tail_args(matcher, grid, co, loc, fin, True, True)
        out[f"beams {B}"] = hold_tail(f"{B} beams", args, pens, timing)
    for name, rec in out.items():
        if rec["mode"] != "wide":
            raise AssertionError(f"score_tail {name}: {rec['mode']} mode")
        print(f"# limits score_tail {name}: held to plain; "
              f"{json.dumps(rec)}", flush=True)
    return out


def check_ring_limits(dev, vp, offset, half, G, timing=True):
    """K5 past 48 KB of flags a block (its opt-in shared memory) and past
    a block's shared memory (its scratch flags): rings of 3 slots of
    LIMIT_RING_BEAMS random beams (wide_ring), chain and step mode, each
    bit-equal to its plain version. Returns {beams: record}."""
    import torch

    from slam_toolbox_tpu_torch.kernels import step_cuda as sc

    out = {}
    for B in LIMIT_RING_BEAMS:
        st = wide_ring(dev, seed=5, K=3, B=B)
        view = (st["ring_pack"], st["ring_pose"], st["ring_slot_valid"], vp)
        a = sc.ring_points(*view, G)
        b = sc.ring_points_plain(*view)
        s1, s2 = clone_state(st), clone_state(st)
        c = sc.ring_points_step(s1, offset, half, G)
        d = sc.ring_points_step_plain(s2, offset, half)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(a + c, b + d))
        same = same and all(torch.equal(v, s2[k]) for k, v in s1.items()
                            if isinstance(v, torch.Tensor))
        if not same:
            raise AssertionError(f"ring_points at {B} beams != plain")
        rec = dict(shape=f"C=3 B={B}", cases_checked=2,
                   flags="scratch" if sc.ring_scratch_bytes(3, B) else
                   "shared (opt-in)")
        if timing:
            rec.update(ms=event_ms(lambda: sc.ring_points(*view, G), 5),
                       plain_ms=event_ms(lambda: sc.ring_points_plain(*view),
                                         2))
        out[str(B)] = rec
        print(f"# limits ring_points {B} beams: chain and step mode "
              f"bit-equal to plain; {json.dumps(rec)}", flush=True)
    return out


def check_limits(matcher, grid, si, dev, timing=True):
    """Phase 2's geometries past the kernels' former limits, at the
    sequential matcher's geometry: K1 (check_window_limits), K7
    (check_tail_limits), K5 (check_ring_limits). Returns {kernel:
    {case: record}}."""
    return {
        "score_windows": check_window_limits(
            grid, matcher.G, float(matcher._score_args["scale"]), si, dev,
            timing),
        "score_tail": check_tail_limits(matcher, grid, si, dev, timing),
        "ring_points": check_ring_limits(
            dev, si["center_off"][:2], si["offset_pose"], si["half"],
            matcher.G, timing),
    }


# K7's streamed geometries (check_tail_wide): the loop matcher's config
# changes and the (coarse headings, lattice side) they give
TAIL_WIDE = {
    # a 20 m loop search at 0.05 m: 21 x 201 x 201 sums
    "lattice": (dict(loop_search_space_dimension=20.0), (21, 201)),
    # a search over +-2.995 rad at 0.01 rad on a 3 x 3 lattice: 600
    # headings, past kMaxHeadings, and 7 of the 16 CTAs with no cell
    "headings": (dict(loop_search_space_dimension=0.2,
                      coarse_search_angle_offset=2.995,
                      coarse_angle_resolution=0.01,
                      fine_search_angle_offset=0.001), (600, 3)),
}


def check_tail_wide(cfg, laser, data, dev, chain, q, what="lattice"):
    """K7's streamed mode where it must be taken: bench.py's loop matcher
    with TAIL_WIDE[what]'s changes (21 x 201 x 201 sums, or 600 x 3 x 3),
    on the loop chain's raster, at 1,081 beams and at the CLI's 271
    (every fourth), on the fused verify's flags and on align's
    (penalized, refined): the coarse tie count and best bit-equal to the
    plain version, the means within MEAN_ATOL, the covariances within
    COV_RTOL of their scale, the fine and angular parts bit-equal at the
    kernel's own means; device ms by graph replays on the verify's flags.
    Returns {beams: record}."""
    import torch

    from slam_toolbox_tpu_torch.core.scan import LocalizedScan
    from slam_toolbox_tpu_torch.kernels import step_cuda as sc
    from slam_toolbox_tpu_torch.mapper import Mapper

    changes, (na_want, n_want) = TAIL_WIDE[what]
    wide_cfg = dataclasses.replace(cfg, **changes)
    mapper = Mapper(wide_cfg, device=dev)
    mapper.initialize(laser.range_threshold)
    matcher = mapper.loop_matcher

    def scan_at(i):
        s = LocalizedScan(laser, data[i][0].ranges, data[i][0].odom_pose)
        s.set_corrected_pose(data[i][1])
        return s

    inp = kernel_inputs(matcher, [scan_at(i) for i in chain], scan_at(q),
                        dev)
    grid = matcher._raster(inp["pts"], inp["valid"], inp["off"])
    si = step_inputs(matcher, [scan_at(i) for i in chain], scan_at(q), dev)
    kw = matcher._score_args
    pens = (kw["dist_var_penalty"], kw["ang_var_penalty"],
            kw["min_dist_pen"], kw["min_ang_pen"])
    naf = kw["na_fine"]
    out = {}
    for step in (1, 4):
        local = si["local"][::step].contiguous()
        finite = si["finite"][::step].contiguous()
        B = local.shape[0]
        rec = dict(cases_checked=0, mean_err=0.0, cov_rel_err=0.0)
        for pz, rf in ((False, False), (True, True)):
            args = score_tail_args(matcher, grid, si["center_off"], local,
                                   finite, pz, rf)
            na, ny, nx = args[0].shape
            geometry = sc.score_tail_launch(na, ny, nx, B, naf)
            if (geometry[3] != sc.TAIL_STREAMED
                    or (na, ny, nx) != (na_want, n_want, n_want)):
                raise AssertionError(f"score_tail at {na} x {ny} x {nx}, "
                                     f"{B} beams: {geometry}")
            ak = torch.zeros(sc.aux_len(naf), device=dev)
            ap = torch.zeros_like(ak)
            pk = sc.score_tail(*args, aux=ak)
            pp = sc.score_tail_plain(*args, aux=ap)
            torch.cuda.synchronize()
            what = f"score_tail streamed {ny}x{nx} B={B} penalize {pz}"
            if not torch.equal(ak[:2], ap[:2]):
                raise AssertionError(f"{what}: coarse tie count and best "
                                     f"{ak[:2].tolist()} {ap[:2].tolist()}")
            if rf:
                fp = sc.fine_parts_plain(
                    grid, matcher.G, si["center_off"], local, finite,
                    ak[2:5], ak[7:10], kw["x_off_f"], kw["y_off_f"],
                    kw["scale"], kw["fine_angle_offset"],
                    kw["fine_angle_res"], pz, pens, naf)
                ref = ak.clone()
                sc.fill_aux_fine(ref, fp, ak[7:10])
                if not torch.equal(ak, ref):
                    raise AssertionError(f"{what}: fine and angular parts")
            scale = float(pp[[4, 8, 12]].abs().max().clamp_min(1e-6))
            e_mean = max(float((pk[1:4] - pp[1:4]).abs().max()),
                         float((ak[2:5] - ap[2:5]).abs().max()))
            e_cov = float((pk[4:] - pp[4:]).abs().max()) / scale
            if e_mean > sc.MEAN_ATOL or e_cov > sc.COV_RTOL:
                raise AssertionError(f"{what}: mean {e_mean}, covariance "
                                     f"{e_cov} of its scale")
            rec["cases_checked"] += 1
            rec["mean_err"] = max(rec["mean_err"], e_mean)
            rec["cov_rel_err"] = max(rec["cov_rel_err"], e_cov)
            if not pz:
                rec.update(
                    shape=f"na={na} {ny}x{nx} B={B}", G=matcher.G,
                    device_ms=graph_ms(lambda: sc._launch_score_tail(
                        args, None, geometry), 20)[0],
                    plain_ms=event_ms(lambda: sc.score_tail_plain(*args),
                                      5),
                    cluster=dict(ctas=geometry[0], threads=geometry[1],
                                 dynamic_smem_bytes=geometry[2],
                                 active_clusters=sc.tail_clusters(
                                     geometry, dev)))
        out[str(B)] = rec
        print(f"# score_tail streamed {rec['shape']} G={matcher.G}: "
              f"{rec['cases_checked']} cases held to plain (mean "
              f"{rec['mean_err']}, covariance {rec['cov_rel_err']} of its "
              f"scale), device {rec['device_ms']} ms, plain "
              f"{rec['plain_ms']} ms, cluster {rec['cluster']}", flush=True)
    return out


# K7's launches in the determinism check, and the other launch geometries
# (CTAs, threads a CTA) timed beside the one score_tail_launch picks
TAIL_REPEATS = 100
TAIL_SWEEP = ((4, 512), (8, 256), (8, 512), (16, 256))
# the SCORE_TAIL_PHASE_CLOCK build of score_tail.cu, which main() loads
TAIL_PHASE_LIB = None


def tail_geometries(args, ref, ref_aux, tag):
    """K7 on the same inputs at TAIL_SWEEP's launch geometries whose
    responses fit a CTA: device ms by graph replays, phase ms (the phase
    clock build) and the output's largest distance from `ref`, the
    chosen geometry's; the coarse tie count and best must equal
    `ref_aux`'s."""
    import torch

    from slam_toolbox_tpu_torch.kernels import step_cuda as sc

    raw = args[0]
    na, ny, nx = raw.shape
    out = {}
    for ctas, threads in TAIL_SWEEP:
        smem = sc.score_tail_smem(na, ny, nx, args[3].shape[0], ctas)
        if smem > sc.TAIL_ROOM:
            continue
        geom = (ctas, threads, smem, sc.TAIL_RESIDENT)
        aux = torch.zeros(sc.aux_len(args[-2]), device=raw.device)
        got = sc._launch_score_tail(args, aux, geom)
        torch.cuda.synchronize()
        if not torch.equal(aux[:2], ref_aux[:2]):
            raise AssertionError(f"{tag} score_tail at {geom}: coarse tie "
                                 f"count and best {aux[:2].tolist()} "
                                 f"against {ref_aux[:2].tolist()}")
        out[f"{ctas}x{threads}"] = dict(
            device_ms=graph_ms(
                lambda: sc._launch_score_tail(args, None, geom), 50)[0],
            phase_ms=tail_phase_ms(TAIL_PHASE_LIB, lambda: (
                sc._launch_score_tail(args, None, geom, TAIL_PHASE_LIB))),
            max_abs_diff=float((got - ref).abs().max()))
    return out


TAIL_PHASES = ("coarse responses and maximum", "tie sums",
               "covariance sums", "fine pass", "angular pass")


def start_phase_clock_build(src=None, name="score_tail_phases"):
    """Start nvcc on score_tail.cu (or `src`) with SCORE_TAIL_PHASE_CLOCK
    defined, into the build directory as lib<name>.so; the package never
    loads it. Returns (process, library path)."""
    from slam_toolbox_tpu_torch.kernels import match_cuda as mc

    os.makedirs(os.path.dirname(mc._lib_path(name)), exist_ok=True)
    path = mc._lib_path(name)
    proc = subprocess.Popen(
        [mc._nvcc(), *mc.NVCC_FLAGS, "-DSCORE_TAIL_PHASE_CLOCK", "-o", path,
         src or mc._source("score_tail")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, path


def load_phase_clock(proc, path):
    """Wait for start_phase_clock_build's nvcc and load its library with
    the kernel's, the cluster query's and the phase clock's argument
    types; raises if the build failed."""
    import ctypes

    from slam_toolbox_tpu_torch.kernels import match_cuda as mc

    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {path}:\n{log}")
    lib = ctypes.CDLL(path)
    lib.score_tail.restype = ctypes.c_int
    lib.score_tail.argtypes = mc._lib("score_tail").score_tail.argtypes
    mc.set_cluster_query(lib)
    lib.score_tail_phases.restype = ctypes.c_int
    lib.score_tail_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def tail_static_smem() -> int:
    """score_tail's static shared bytes as ptxas reports them in its
    build log; raises above step_cuda.TAIL_STATIC_SMEM, the part of a
    CTA's 227 KB that score_tail_launch leaves to them."""
    import re

    from slam_toolbox_tpu_torch.kernels import match_cuda as mc
    from slam_toolbox_tpu_torch.kernels import step_cuda as sc

    log = open(os.path.join(os.path.dirname(mc._lib_path("score_tail")),
                            "score_tail.log")).read()
    found = re.findall(r"(\d+) bytes smem", log)
    if not found:
        raise AssertionError(f"no shared memory line in score_tail's log:\n"
                             f"{log}")
    static = max(int(x) for x in found)
    if static > sc.TAIL_STATIC_SMEM:
        raise AssertionError(f"score_tail takes {static} static shared bytes,"
                             f" above TAIL_STATIC_SMEM {sc.TAIL_STATIC_SMEM}")
    return static


def tail_phase_ms(lib, launch, n: int = 200):
    """Mean ms of each of score_tail's five phases (TAIL_PHASES) over `n`
    launches of a SCORE_TAIL_PHASE_CLOCK build: `launch()` launches it
    once; the kernel's first thread adds %globaltimer differences at each
    phase's end. A phase the launch skips (no refine) reads 0."""
    import ctypes

    import torch

    stamps = (ctypes.c_ulonglong * (len(TAIL_PHASES) + 1))()
    torch.cuda.synchronize()
    if lib.score_tail_phases(stamps, 1):
        raise RuntimeError("score_tail_phases reset failed")
    for _ in range(n):
        launch()
    torch.cuda.synchronize()
    if lib.score_tail_phases(stamps, 0):
        raise RuntimeError("score_tail_phases read failed")
    runs = stamps[len(TAIL_PHASES)]
    if runs != n:
        raise AssertionError(f"phase clock counted {runs} of {n} launches")
    return [stamps[k] / n / 1e6 for k in range(len(TAIL_PHASES))]


def score_tail_args(matcher, grid, center_off, local, finite, penalize,
                    refine):
    """score_tail's arguments as a match forms them at `matcher`'s
    geometry: K1's head-form window sums on `grid` and headings around
    center_off, the matcher's offsets and penalties."""
    from slam_toolbox_tpu_torch.kernels import step_cuda as sc

    kw, G = matcher._score_args, matcher.G
    raw, ang = sc.score_windows_head(*head_args(matcher, grid, center_off,
                                                local, finite))
    return (raw, grid, center_off, local, finite, ang, kw["x_off_c"],
            kw["y_off_c"], kw["x_off_f"], kw["y_off_f"], kw["scale"],
            kw["fine_angle_offset"], kw["fine_angle_res"],
            kw["coarse_angle_res"], penalize, kw["dist_var_penalty"],
            kw["ang_var_penalty"], kw["min_dist_pen"], kw["min_ang_pen"], G,
            kw["na_fine"], refine)


def head_args(matcher, grid, center_off, local, finite):
    """score_windows_head's arguments as a match forms them at `matcher`'s
    geometry (its coarse offsets, scale and headings) on `grid`."""
    kw = matcher._score_args
    return (grid, matcher.G, center_off, local, finite, kw["x_off_c"],
            kw["y_off_c"], kw["scale"], kw["coarse_angle_offset"],
            kw["coarse_angle_res"], kw["na_coarse"])


def tail_cells(matcher, args, pens) -> int:
    """Distinct in-grid raster cells that score_tail's fine and angular
    gathers read on these inputs (the plain version's fine pass)."""
    import torch

    from slam_toolbox_tpu_torch.kernels import step_cuda as sc

    raw, g, c, local, fin, ang = args[:6]
    kw, G = matcher._score_args, matcher.G
    coarse = sc.score_tail_plain(*args[:-1], False)
    best_f, mean_f, _, p = sc._fine_pass(
        g, G, c[3:5], local, fin, coarse[1:4], kw["x_off_f"], kw["y_off_f"],
        kw["scale"], kw["fine_angle_offset"], kw["fine_angle_res"],
        args[14], pens, kw["na_fine"])
    d = p["d_f"].long()
    gx = d[:, :, 0, None] + p["cand_x"].long()[None, None, :]
    gy = d[:, :, 1, None] + p["cand_y"].long()[None, None, :]
    bx, by = sc._angular_cell(mean_f, c[3:5], kw["scale"])
    idx = []
    for x, y in ((gx[:, :, None, :], gy[:, :, :, None]),
                 (d[:, :, 0] + bx, d[:, :, 1] + by)):
        x, y = torch.broadcast_tensors(x, y)
        ok = (x >= 0) & (x < G) & (y >= 0) & (y < G)
        ok = ok & fin.view(1, -1, *([1] * (ok.dim() - 2)))
        idx.append((y * G + x)[ok])
    return int(torch.unique(torch.cat(idx)).numel())


def beam_classes(G: int, d, cand_x0, cand_y0, ny: int, nx: int, finite):
    """Shares of the (heading, beam) pairs of table d (na, B, 2) whose
    lattice window lies wholly inside the G x G grid ("full"), partly
    ("partial"), or not at all or on a non-finite beam ("empty"): the
    classes the window-score kernel sorts its beams into, counted here
    from the definition, row by row and column by column."""
    import torch

    dev = d.device

    def rows_in(o, n):   # lattice rows (or columns) with o + 2i in [0, G)
        v = o.to(torch.int64)[..., None] + 2 * torch.arange(n, device=dev)
        return ((v >= 0) & (v < G)).sum(dim=-1)

    ry = rows_in(d[..., 1].to(torch.int64) + cand_y0.to(torch.int64), ny)
    rx = rows_in(d[..., 0].to(torch.int64) + cand_x0.to(torch.int64), nx)
    empty = (ry == 0) | (rx == 0) | ~finite[None, :]
    full = ~empty & (ry == ny) & (rx == nx)
    total = empty.numel()
    return dict(full=int(full.sum()) / total,
                partial=int((~empty & ~full).sum()) / total,
                empty=int(empty.sum()) / total)


def check_window_cases(grid, G: int, d, finite, n: int, tag: str) -> int:
    """Hold K1 bit-equal to its plain version, at the main path's lattice
    origin and straddling both grid edges, on the cases the span
    arithmetic must survive: a table whose finite beams hold INT_MIN
    (torch's NaN to int32) and 1 << 28 (the f64 tables' NaN) in either
    coordinate, every beam non-finite, and lattices with ny != nx.
    Returns the number of (case, origin) pairs checked."""
    import torch

    from slam_toolbox_tpu_torch.kernels import match_cuda as mc

    dev = d.device
    extreme, fin = d.clone(), finite.clone()
    big = torch.iinfo(torch.int32).min
    for k, (axis, v) in enumerate(((0, big), (1, big), (0, 1 << 28),
                                   (1, 1 << 28), (0, -(1 << 28)))):
        extreme[:, 7 * k:7 * k + 5, axis] = v
        fin[7 * k:7 * k + 7] = True
    extreme[:, 40:45] = big
    cases = [("extreme table", extreme, fin, n, n),
             ("no finite beam", d, torch.zeros_like(finite), n, n),
             ("7 x 11 lattice", d, finite, 7, 11),
             ("11 x 7 lattice", d, finite, 11, 7)]
    cmid = (G - 1) // 2 - (n - 1)
    checked = 0
    for name, dd, ff, ny, nx in cases:
        for cx0, cy0 in ((cmid, cmid), (-25, G - 30), (G - 30, -25)):
            cx = torch.tensor([cx0], dtype=torch.int32, device=dev)
            cy = torch.tensor([cy0], dtype=torch.int32, device=dev)
            s = mc.score_windows(grid, G, dd, cx, cy, ny, nx, ff)
            s_p = mc.score_windows_plain(grid, G, dd, cx, cy, ny, nx, ff)
            torch.cuda.synchronize()
            if not torch.equal(s, s_p):
                raise AssertionError(
                    f"{tag} score_windows != plain on the {name} at "
                    f"({cx0}, {cy0})")
            checked += 1
    return checked


def empty_tile_rows(words, G: int, hk: int) -> float:
    """Share of the smear's tile rows (one output row across a tile of
    SMEAR_TILE columns) with no occupied cell within hk rows and hk
    columns: the sparsity the smear's column pass skips (its halo is a
    little wider than hk, so it skips at most this share)."""
    import torch

    from slam_toolbox_tpu_torch.kernels import match_cuda as mc
    from slam_toolbox_tpu_torch.kernels import rasterize as rz

    occ = rz.unpack_occupancy(words, G).float()
    # rows within hk of an occupied row, column by column
    near = torch.nn.functional.max_pool1d(
        occ.t()[None], 2 * hk + 1, 1, hk)[0].t() > 0
    tx = mc.SMEAR_TILE[1]
    empty = sum(int((~near[:, max(0, ox - hk):ox + tx + hk].any(dim=1)).sum())
                for ox in range(0, G, tx))
    return empty / (G * len(range(0, G, tx)))


def print_record(tag, name, r):
    device = "".join(f" {k} {r[k]} ms" for k in DEVICE_KEYS if k in r)
    if "empty_tile_rows" in r:
        device += f" empty tile rows {r['empty_tile_rows']}"
    if "beam_classes" in r:
        device += (f" (heading, beam) pairs {r['beam_classes']}; "
                   f"{r['cases_checked']} edge cases bit-equal")
    print(f"# {tag} {name} [{r['shape']}]: max_abs_err {r['err']} "
          f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms "
          f"library {r['library_ms']} ms bound {r['bound'][0]:.5f} ms "
          f"({r['bound'][1]});{device}", flush=True)


def occupancy_patterns(G: int, hk: int, seed: int = 0):
    """{name: (G, G) bool occupancy} of the patterns where the smear's bit
    scan and tile edges fail if they fail anywhere: empty, full and 50%
    random grids; a cell in each corner; cells hk and hk + 1 from a word
    boundary and from a tile boundary, on both axes; one full column and
    one full row, in the middle and on the last (at odd G, partly filled)
    word row and column."""
    import numpy as np

    from slam_toolbox_tpu_torch.kernels import match_cuda as mc

    rng = np.random.default_rng(seed)
    ty, tx = mc.SMEAR_TILE
    pats = {
        "empty": np.zeros((G, G), bool),
        "full": np.ones((G, G), bool),
        "random_50": rng.random((G, G)) < 0.5,
    }
    corners = np.zeros((G, G), bool)
    corners[[0, 0, G - 1, G - 1], [0, G - 1, 0, G - 1]] = True
    pats["corners"] = corners
    near = set()
    for b in (32, ty * max(1, G // ty // 2), G // 32 * 32,
              tx, tx * max(1, G // tx // 2)):
        near.update((b - hk - 1, b - hk, b + hk, b + hk + 1))
    near = sorted(v for v in near if 0 <= v < G)
    edges = np.zeros((G, G), bool)
    edges[near, G // 2] = True    # along axis 0
    edges[G // 3, near] = True    # along axis 1
    pats["word_and_tile_edges"] = edges
    lines = np.zeros((G, G), bool)
    lines[:, G // 2] = lines[G // 3, :] = True
    pats["middle_row_and_column"] = lines
    last = np.zeros((G, G), bool)
    last[:, G - 1] = last[G - 1, :] = True
    pats["last_row_and_column"] = last
    return pats


def check_patterns(G: int, hk: int, w, dev):
    """Hold K2 word for word and K3 bit for bit
    against their plain versions on every occupancy pattern, each given
    to the scatter as points at its cells' centres; on the full grid also
    K3 on words with stray bits above row G (the smear must ignore them).
    Returns the number of patterns checked and K3's device time on the
    50% random grid, where no row or strip is empty."""
    import numpy as np
    import torch

    from slam_toolbox_tpu_torch.kernels import match_cuda as mc
    from slam_toolbox_tpu_torch.kernels import rasterize as rz

    off = torch.zeros(2, dtype=torch.float32, device=dev)
    pats = occupancy_patterns(G, hk)
    for name, occ in pats.items():
        iy, ix = np.nonzero(occ)
        pts = torch.from_numpy(
            (np.stack([ix, iy], axis=1) * 0.01).astype(np.float32)).to(dev)
        valid = torch.ones(len(pts), dtype=torch.bool, device=dev)
        words = mc.scatter_occupancy(pts, valid, off, 100.0, G)
        words_p = rz.scatter_occupancy_plain(pts, valid, off, 100.0, G)
        if not torch.equal(words, words_p):
            raise AssertionError(f"pattern {name} G={G}: scatter != plain")
        if not torch.equal(rz.unpack_occupancy(words_p, G).cpu(),
                           torch.from_numpy(occ.astype(np.uint8))):
            raise AssertionError(f"pattern {name} G={G}: wrong cells")
        if name == "random_50":
            dense_ms = graph_ms(lambda: mc.smear_quantize(words, w, G, hk),
                                20)[0]
        tests = [words]
        if name == "full" and G % 32:
            stray = words.clone()
            stray[-1] |= ~((1 << (G % 32)) - 1)
            tests.append(stray)
        for ws in tests:
            grid = mc.smear_quantize(ws, w, G, hk)
            if not torch.equal(grid, rz.smear_quantize_plain(ws, w, G, hk)):
                raise AssertionError(
                    f"pattern {name} G={G} hk={hk}: smear != plain")
    torch.cuda.synchronize()
    print(f"# patterns G={G} hk={hk}: scatter and smear equal to their "
          f"plain versions on {len(pats)} patterns ({', '.join(pats)}); "
          f"smear device time on the 50% random grid {dense_ms} ms",
          flush=True)
    return len(pats), dense_ms


def partial_origin(G: int):
    """A lattice origin where the 26 x 26 lattice of the bench geometry
    (G 2051) finds the ceiling's offsets 0 and 2 partly inside the grid,
    offset 4 outside and the rest wholly inside."""
    return G - 621, G - 731


def offset_classes(G: int, cx0: int, cy0: int, ny: int, nx: int, dev):
    """How many of the ceiling's 8 offsets are full, partial and empty at
    lattice origin (cx0, cy0): beam_classes on a one-heading table of the
    offsets."""
    import torch

    from slam_toolbox_tpu_torch.kernels import match_cuda as mc

    offs = torch.tensor(mc.CEIL_OFFSETS, dtype=torch.int32, device=dev)
    every = torch.ones(len(offs), dtype=torch.bool, device=dev)
    c = [torch.tensor([v], dtype=torch.int32, device=dev) for v in (cx0, cy0)]
    shares = beam_classes(G, offs[None], c[0], c[1], ny, nx, every)
    return {k: round(v * len(offs)) for k, v in shares.items()}


def miss_grid(dev):
    """A random G 257 raster: from any lattice origin in [-25, 227]^2,
    every one of the ceiling's offsets puts a lattice of up to 26 x 26
    cells wholly outside it, so neither K4 nor K1 on the tiled table
    reads it."""
    import numpy as np
    import torch

    return torch.from_numpy(np.concatenate([
        np.random.default_rng(257).integers(0, 101, 257 * 257, np.int8),
        np.zeros(1, np.int8)])).to(dev)


def check_ceiling_cases(grid, G: int, na: int, B: int, n: int) -> int:
    """Hold K4 bit-equal to its plain version and to K1 on the table that
    tiles its offsets (every beam, summed over headings): with na headings
    of B beams on the n x n lattice and on 7 x 11 and 11 x 7 lattices, and
    with 5 headings of 13 beams (65 slots cycle the offsets unevenly), at
    the main path's lattice origin, straddling both grid edges and at the
    partial origin; then on a G 257 raster, where every offset falls
    outside and the sums must be 0. Returns the (case, origin) pairs
    checked."""
    import torch

    from slam_toolbox_tpu_torch.kernels import match_cuda as mc

    dev = grid.device
    cmid = (G - 1) // 2 - (n - 1)
    origins = ((cmid, cmid), (-25, G - 30), (G - 30, -25), partial_origin(G))
    small = miss_grid(dev)
    cases = [(grid, G, na, B, n, n, origins),
             (grid, G, na, B, 7, 11, origins),
             (grid, G, na, B, 11, 7, origins),
             (grid, G, 5, 13, n, n, origins),
             (small, 257, na, B, n, n, ((100, 100), (-25, 227)))]
    checked = 0
    for g, gs, a, b, ny, nx, where in cases:
        table = mc.ceiling_table(a, b, dev)
        every = torch.ones(b, dtype=torch.bool, device=dev)
        for cx0, cy0 in where:
            cx = torch.tensor([cx0], dtype=torch.int32, device=dev)
            cy = torch.tensor([cy0], dtype=torch.int32, device=dev)
            k4 = mc.score_ceiling(g, gs, cx, cy, a, b, ny, nx)
            plain = mc.score_ceiling_plain(g, gs, cx, cy, a, b, ny, nx)
            k1 = mc.score_windows(g, gs, table, cx, cy, ny, nx, every).sum(
                dim=0, dtype=torch.int32)
            torch.cuda.synchronize()
            what = f"G {gs}, {a} x {b} slots, {ny} x {nx} at ({cx0}, {cy0})"
            if not torch.equal(k4, plain):
                raise AssertionError(f"score_ceiling != plain: {what}")
            if not torch.equal(k4, k1):
                raise AssertionError(
                    f"score_ceiling != score_windows on the tiled table: "
                    f"{what}")
            if gs == 257 and k4.any():
                raise AssertionError(f"score_ceiling not 0: {what}")
            checked += 1
    return checked


def sass_byte_loads(sass: str, kernel: str):
    """(byte loads, byte loads inside a loop) of the kernel whose name
    contains `kernel` in `cuobjdump -sass` output: LDG.E.S8 and LDG.E.U8,
    constant-cache forms included. A loop is the span from a backward
    branch's target to the branch; the second count is None when the
    kernel has no backward branch."""
    import re

    body, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if inside and m:
            body.append((int(m.group(1), 16), m.group(2)))
    loads = [a for a, ins in body if re.search(r"\bLDG\.E\.[SU]8\b", ins)]
    loops = []
    for a, ins in body:
        m = re.search(r"\bBRA\b.*\b0x([0-9a-f]+)\b", ins)
        if m and int(m.group(1), 16) <= a:
            loops.append((int(m.group(1), 16), a))
    if not loops:
        return len(loads), None
    return len(loads), sum(any(lo <= a <= hi for lo, hi in loops)
                           for a in loads)


def check_ceiling_sass():
    """Count the byte loads in the built score_ceiling kernel with
    cuobjdump, where it stands beside nvcc: a load for each of the 8
    offsets x 4 cells must survive the compiler inside the slot loops (a
    load hoisted out of them would make the ceiling add one value per
    offset). Returns {"byte_loads", "in_loops"}, or None when cuobjdump is
    absent."""
    import os

    from slam_toolbox_tpu_torch.kernels import match_cuda as mc

    tool = os.path.join(os.path.dirname(mc._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        print(f"# ceiling SASS: no cuobjdump beside nvcc ({tool}); the "
              f"load count could not be checked", flush=True)
        return None
    sass = subprocess.run([tool, "-sass", mc._lib_path("score_ceiling")],
                          capture_output=True, text=True, check=True).stdout
    total, in_loops = sass_byte_loads(sass, "score_ceiling_kernel")
    need = 8 * 4
    print(f"# ceiling SASS: {total} byte loads in score_ceiling_kernel, "
          f"{in_loops} of them inside a loop (8 offsets x 4 cells need "
          f"{need})", flush=True)
    if total < need or (in_loops is not None and in_loops < need):
        raise AssertionError(
            f"score_ceiling: {total} byte loads ({in_loops} in a loop), "
            f"fewer than the body's {need}: the compiler merged or hoisted "
            f"them")
    return dict(byte_loads=total, in_loops=in_loops)


def in_turns(fa, fb, n: int = 50):
    """Device times of fa and fb by graph_ms in the order a, b, b, a:
    ((a1, a2), (b1, b2)), and the launches of fa's kernel the replays
    made."""
    a1, la = graph_ms(fa, n)
    b1, _ = graph_ms(fb, n)
    b2, _ = graph_ms(fb, n)
    a2, la2 = graph_ms(fa, n)
    return (a1, a2), (b1, b2), la + la2


def measure_ceiling(matcher, grid, d, n):
    """The roofline measurement, score_ceiling's entry point, on the main
    path's raster at the bench geometry. At equal work: the ceiling (K4)
    and the window score (K1) on the table that tiles K4's offsets, every
    beam counted, at the main path's lattice origin, timed by CUDA graph
    replays in turns; beside them K1 on the main path's rotated table,
    every beam counted, and K4 at an origin where some offsets are
    partial, each with its gathers; and the fixed cost of K4 and of K1 on
    the tiled table, the same calls on a raster that every offset misses.
    Then K4 is held bit-equal to its plain
    version and to K1 on the tiled table (check_ceiling_cases) and its
    loads are counted in the SASS. Returns the record; its "launches" are
    K4's launches in this measurement, graph replays included."""
    import torch

    from slam_toolbox_tpu_torch.kernels import match_cuda as mc

    G = matcher.G
    na, B = d.shape[0], d.shape[1]
    dev = grid.device
    every = torch.ones(B, dtype=torch.bool, device=dev)
    table = mc.ceiling_table(na, B, dev)
    cmid = (G - 1) // 2 - (n - 1)
    c = torch.tensor([cmid], dtype=torch.int32, device=dev)
    px0, py0 = partial_origin(G)
    px = torch.tensor([px0], dtype=torch.int32, device=dev)
    py = torch.tensor([py0], dtype=torch.int32, device=dev)
    mc.reset_launch_counts()
    k4_runs, k1t_runs, replayed = in_turns(
        lambda: mc.score_ceiling(grid, G, c, c, na, B, n, n),
        lambda: mc.score_windows(grid, G, table, c, c, n, n, every))
    k4p_dev, replayed_p = graph_ms(
        lambda: mc.score_ceiling(grid, G, px, py, na, B, n, n), 50)
    # the fixed cost of each call (fill, launch, set-up, K1's staging):
    # the same calls on a raster that every offset misses, no load issued
    miss = miss_grid(dev)
    c100 = torch.tensor([100], dtype=torch.int32, device=dev)
    k4f_runs, k1f_runs, replayed_f = in_turns(
        lambda: mc.score_ceiling(miss, 257, c100, c100, na, B, n, n),
        lambda: mc.score_windows(miss, 257, table, c100, c100, n, n, every))
    k4_floor, k1_floor = sum(k4f_runs) / 2, sum(k1f_runs) / 2
    k1_dev, _ = graph_ms(
        lambda: mc.score_windows(grid, G, d, c, c, n, n, every), 50)
    k4_dev, k1t_dev = sum(k4_runs) / 2, sum(k1t_runs) / 2
    k1_ms = event_ms(
        lambda: mc.score_windows(grid, G, d, c, c, n, n, every), 50)
    k4_ms = event_ms(
        lambda: mc.score_ceiling(grid, G, c, c, na, B, n, n), 50)
    plain_ms = event_ms(
        lambda: mc.score_ceiling_plain(grid, G, c, c, na, B, n, n), 20)
    err = 0
    for cx, cy in ((c, c), (px, py)):
        k4 = mc.score_ceiling(grid, G, cx, cy, na, B, n, n)
        plain = mc.score_ceiling_plain(grid, G, cx, cy, na, B, n, n)
        err = max(err, int((k4 - plain).abs().max()))
    n_cases = check_ceiling_cases(grid, G, na, B, n)
    sass = check_ceiling_sass()
    cells, gathers = cells_read(G, table, c, c, n, n, every)
    gathers = dict(
        tiled=gathers,
        tiled_partial=cells_read(G, table, px, py, n, n, every)[1],
        path_table=cells_read(G, d, c, c, n, n, every)[1])
    classes = {f"{cmid},{cmid}": offset_classes(G, cmid, cmid, n, n, dev),
               f"{px0},{py0}": offset_classes(G, px0, py0, n, n, dev)}
    rec = dict(
        err=err, ms=k4_ms, plain_ms=plain_ms, library_ms=None,
        bound=bound(cells + 8 + n * n * 4, gathers["tiled"]),
        launches=(mc.LAUNCHES["score_ceiling"] + replayed + replayed_p
                  + replayed_f),
        shape=f"G={G} na={na} B={B} {n}x{n}",
        device_ms=k4_dev, device_ms_runs=k4_runs, device_ms_partial=k4p_dev,
        k1_ms=k1_ms, k1_device_ms=k1_dev, k1_tiled_device_ms=k1t_dev,
        k1_tiled_device_ms_runs=k1t_runs,
        k1_pct_of_ceiling=100.0 * k4_dev / k1t_dev,
        fixed_device_ms=dict(score_ceiling=k4_floor, score_windows=k1_floor),
        gathers=gathers, offset_classes=classes, cases_checked=n_cases,
        sass=sass,
    )
    print_record("seq", "score_ceiling", rec)

    def rate(g, ms):   # gathers per ns
        return g / (ms * 1e6) if ms > 0 else float("nan")

    print(f"# ceiling: device time per launch (CUDA graph replays, in turns "
          f"K4, K1, K1, K4) at equal work, the lattice origin ({cmid}, "
          f"{cmid}), offsets {classes[f'{cmid},{cmid}']}, "
          f"{gathers['tiled']} gathers each: score_ceiling {k4_dev} ms "
          f"{k4_runs} ({rate(gathers['tiled'], k4_dev)} gathers/ns), "
          f"score_windows on the tiled table {k1t_dev} ms {k1t_runs} "
          f"({rate(gathers['tiled'], k1t_dev)} gathers/ns): score_windows "
          f"at {rec['k1_pct_of_ceiling']}% of its ceiling; score_windows on "
          f"the path's table, every beam: {k1_dev} ms, "
          f"{gathers['path_table']} gathers "
          f"({rate(gathers['path_table'], k1_dev)} gathers/ns); "
          f"score_ceiling at ({px0}, {py0}), offsets "
          f"{classes[f'{px0},{py0}']}: {k4p_dev} ms, "
          f"{gathers['tiled_partial']} gathers "
          f"({rate(gathers['tiled_partial'], k4p_dev)} gathers/ns); "
          f"fixed cost (the same calls on a G 257 raster every offset "
          f"misses): score_ceiling {k4_floor} ms {k4f_runs}, score_windows "
          f"{k1_floor} ms {k1f_runs}, so at equal work the rest takes "
          f"{k4_dev - k4_floor} and {k1t_dev - k1_floor} ms "
          f"({rate(gathers['tiled'], k4_dev - k4_floor)} and "
          f"{rate(gathers['tiled'], k1t_dev - k1_floor)} gathers/ns); not "
          f"timed at the loop geometry (G 561: offsets of up to 890 cells "
          f"leave almost every offset outside the grid); wrapper times "
          f"{k1_ms} and {k4_ms} ms; bound {rec['bound'][0]} ms "
          f"({rec['bound'][1]}, {cells} raster cells read); "
          f"{rec['launches']} launches of the ceiling; {n_cases} "
          f"(case, origin) pairs bit-equal", flush=True)
    return rec


def spec_pairs_for(batch, committed, n_pairs: int = 16, half: int = 5):
    """(query, ring row offset, chain) triples: the first n_pairs scans of
    `batch`, each with the run of committed scans around the one nearest
    it by odometry (up to 2 * half + 1 scans), as near chains look."""
    import numpy as np

    xy = np.array([s.odom_pose[:2] for s in committed])
    out = []
    for i, q in enumerate(batch[:n_pairs]):
        j = int(np.argmin(np.hypot(*(xy - q.odom_pose[:2]).T)))
        out.append((q, i, committed[max(0, j - half):j + half + 1]))
    return out


def second_drain(cfg, laser, data, dev):
    """A streaming session (drains of 256) that has committed the bench
    workload's first drain, with its second drain's 256 scans taken out
    of `pending`, not dispatched: (session, pipeline, those scans, the
    committed scans). The pipeline's step graph was captured at the first
    drain."""
    from slam_toolbox_tpu_torch.api import SlamSession

    sess = SlamSession(cfg, laser, device=dev, streaming=True,
                       drain_every=256)
    sess.stats.enabled = True
    pipe = sess._ensure_pipe()
    it = iter(enumerate(data))
    for i, (scan, _) in it:   # up to the first drain
        sess.process_scan(scan.ranges, scan.odom_pose, time=i * 0.1)
        if sess.stats.counts["batch_dispatch"]:
            break
    # commit it as the next drain would: settle() would also make its
    # terminal loop attempt and restart the cadence
    pipe._commit()
    if pipe._needs_resync:
        pipe.refresh_state()
        pipe._needs_resync = False
    committed = sess.mapper.all_processed_scans()
    pipe.drain_every = 1 << 30   # accumulate the second batch only
    for i, (scan, _) in it:
        sess.process_scan(scan.ranges, scan.odom_pose, time=i * 0.1)
        if len(pipe.pending) == 256:
            break
    scans, pipe.pending = pipe.pending, []
    if pipe._graph is None:
        raise AssertionError("the first drain captured no step graph")
    return sess, pipe, scans, committed


def check_no_sync(cfg, laser, data, dev):
    """Phase 5. A streaming session commits the bench workload's first
    drain (second_drain); its second drain's batch (256 scans, replays of
    the step graph that the first drain captured) is then launched with
    its speculative launches under sync_debug_mode("error"), so any host
    synchronization between the batch's first replay and the last
    speculative launch raises: the pipeline's own _dispatch_spec (with
    EARLY_VERIFY off, so the newest scan's predicted loop candidates are
    verified too) and a near-chain speculation of 16 pairs of batch scans
    with committed chains. Then the speculative near-chain rows are held
    bit-equal to the non-speculative dispatch at the ring's centers, the
    batch is committed, and the speculative route's kernel launches and
    the commit's speculation counts are returned."""
    import numpy as np
    import torch

    from slam_toolbox_tpu_torch.kernels import loop_verify as lv
    from slam_toolbox_tpu_torch.kernels import match_cuda as mc
    from slam_toolbox_tpu_torch.mapper import streaming as ts

    sess, pipe, scans, committed = second_drain(cfg, laser, data, dev)
    graph = pipe._graph
    n = len(scans)
    pairs = spec_pairs_for(scans, committed)
    # the verify's and near-chain matches' programs at every fixed chain
    # bucket, on the pool (whose storage the batch's 256 rows leave as it
    # is): the speculative launches below are replays
    pool0 = lv._pool_storage(pipe.pack_pool)
    lv.warm_programs(sess.mapper.loop_matcher, pipe.matcher, cfg,
                     pipe.pack_pool, lv.CHAIN_BUCKETS)
    replays0 = program_replays(pipe.matcher)
    early = ts.EARLY_VERIFY
    ts.EARLY_VERIFY = False
    torch.cuda.synchronize()
    mc.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        packs, odoms = pipe._dispatch_batch(scans)
        batch_launches = dict(mc.LAUNCHES)
        pd = ts._PendingDrain(scans, packs, odoms,
                              start=pipe.state["n_results"] - n,
                              results=pipe.state["results"])
        pipe._dispatch_spec(pd)
        echo, _ = lv.dispatch_chain_matches_spec(
            pipe.matcher, [(q, (pd.start + k) % pipe.result_cap, c)
                           for q, k, c in pairs],
            pipe.pack_pool, pd.results)
        pd.prefetch()
    finally:
        torch.cuda.set_sync_debug_mode("default")
        ts.EARLY_VERIFY = early
    spec_launches = {k: v - batch_launches[k] for k, v in mc.LAUNCHES.items()}
    replays = program_replays(pipe.matcher) - replays0
    n_spec = 0 if pd.spec is None else pd.spec.shape[0] - pipe.result_cap
    n_loop_rows = len(pd.spec_loop[0]) if pd.spec_loop is not None else 0
    if (lv._pool_storage(pipe.pack_pool) != pool0
            or replays != n_spec + len(pairs) + n_loop_rows):
        raise AssertionError(
            f"no-sync: {replays} program replays for {n_spec} + "
            f"{len(pairs)} near-chain pairs and {n_loop_rows} verified "
            "chains (the pool's storage moved, or a route ran eagerly)")
    if pipe._graph is not graph or any(
            batch_launches[k] != n for k in PATH_KERNELS + STREAM_KERNELS):
        raise AssertionError(f"the batch did not run as {n} replays of the "
                             f"first drain's step graph: {batch_launches}")
    rows = pd.results.cpu().numpy()
    if not np.all(np.isfinite(rows[:n])):
        raise AssertionError("no-sync batch gave non-finite results")
    cap = pipe.result_cap
    if not torch.equal(echo[:cap], pd.results):
        raise AssertionError("the echo's ring differs from the result ring")
    # the non-speculative path with each query at its ring row's pose
    saved = [q.corrected_pose.copy() for q, _, _ in pairs]
    for q, k, _ in pairs:
        q.set_sensor_pose(rows[(pd.start + k) % cap, 1:4].astype(np.float64))
        if not np.array_equal(np.asarray(q.sensor_pose, np.float32),
                              rows[(pd.start + k) % cap, 1:4]):
            raise AssertionError("a ring pose does not round-trip")
    ref = lv.dispatch_chain_matches(pipe.matcher,
                                    [(q, c) for q, _, c in pairs],
                                    pipe.pack_pool)
    for (q, _, _), pose in zip(pairs, saved):
        q.set_corrected_pose(pose)
    if not torch.equal(echo[cap:], ref):
        raise AssertionError(
            "speculative near-chain rows differ from the dispatch's: max "
            f"{float((echo[cap:] - ref).abs().max())}")
    n_loop = len(pd.spec_loop[0]) if pd.spec_loop is not None else 0
    pipe._pending_drain = pd
    pipe._last_gate_scan = scans[-1]
    pipe.drain_every = 256
    sess.flush()
    counts = {k: sess.stats.counts[k] for k in SPEC_COUNTS}
    print(f"# no sync: a {n}-scan drain batch (step graph replays), its "
          f"speculative launches "
          f"(the loop verify of {n_loop} predicted candidates) and "
          f"{len(pairs)} speculative near-chain matches ran "
          f"with no host synchronization, the speculation as {replays} "
          f"program replays; launches of the batch "
          f"{batch_launches}, of the speculation {spec_launches}; the "
          f"speculative near-chain rows bit-equal to the dispatch's; the "
          f"commit's speculation counts {json.dumps(counts)}", flush=True)
    if not n_loop:
        raise AssertionError("no-sync: the loop verify was not speculated")
    return dict(spec_launches=spec_launches, counts=counts)


# phase 5b times a graph of this many steps beside the pipeline's
# one-step graph
UNROLL = 16


def check_graph(cfg, laser, data, dev):
    """Phase 5b. The second drain's 256-scan batch (second_drain) run from
    one saved copy of the pipeline's state, in turns: eagerly (the Python
    loop, the CPU route), as replays of the pipeline's step graph
    (_StepGraph, one step per replay, captured here on its own state),
    and as replays of a graph of UNROLL steps. Every state tensor after
    each graphed run bit-equal to the eager run's, and the launches
    counted by the graphs' tallies equal to the eager loop's. Timed in
    this call: each capture (the step graph's eager step on a scratch
    state included), the host time of each route's launch of the batch
    (what batch_dispatch holds: the batch's two copies and the replays,
    or the Python loop), the host time per replay, and the device time
    per step (CUDA events over the batch). Prints `# graph:`."""
    import numpy as np
    import torch

    from slam_toolbox_tpu_torch.device import upload
    from slam_toolbox_tpu_torch.kernels import match_cuda as mc
    from slam_toolbox_tpu_torch.mapper import streaming as ts

    _, pipe, scans, _ = second_drain(cfg, laser, data, dev)
    n = len(scans)
    packs = upload(np.stack([ts.scan_pack(s) for s in scans]), dev)
    odoms = upload(np.stack([s.odom_pose for s in scans]).astype(
        np.float32), dev)
    state = pipe.state
    saved = clone_state(state)

    def restore():
        for k, v in saved.items():
            if isinstance(v, torch.Tensor):
                state[k].copy_(v)
            else:
                state[k] = v

    capture_ms = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step_graph = ts._StepGraph(state, pipe._step)
    torch.cuda.synchronize()
    capture_ms["graph"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    unrolled, tally, _ = mc.capture_graph(lambda: pipe._step(state), dev,
                                          steps=UNROLL)
    torch.cuda.synchronize()
    capture_ms["unrolled"] = 1e3 * (time.perf_counter() - t0)

    def replay_unrolled():
        ts._load_batch(state, packs, odoms)
        for _ in range(n // UNROLL):
            unrolled.replay()
        mc.count_replay(tally, n // UNROLL)
        state["n_results"] += n

    launch = {
        "eager": lambda: pipe._run_eager(state, packs, odoms),
        "graph": lambda: pipe._run_batch(state, packs, odoms),
        "unrolled": replay_unrolled,
    }

    def run(route):
        """One batch from the saved state: (host ms of the launch, device
        ms, launches, the state after)."""
        restore()
        torch.cuda.synchronize()
        mc.reset_launch_counts()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        t0 = time.perf_counter()
        launch[route]()
        host_ms = 1e3 * (time.perf_counter() - t0)
        e1.record()
        torch.cuda.synchronize()
        return host_ms, e0.elapsed_time(e1), dict(mc.LAUNCHES), clone_state(
            state)

    if n % UNROLL:
        raise AssertionError(f"a {n}-scan batch is no multiple of {UNROLL}")
    pipe._graph = step_graph
    order = ["eager", "graph", "unrolled", "unrolled", "graph", "eager"]
    times = {route: [] for route in order}
    ref = None
    for route in order:
        host_ms, dev_ms, launches, out = run(route)
        times[route].append((host_ms, dev_ms))
        if ref is None:
            ref = (launches, out)
            continue
        if launches != ref[0]:
            raise AssertionError(f"{route}: launches {launches} against "
                                 f"the eager loop's {ref[0]}")
        for k, v in out.items():
            same = (torch.equal(v, ref[1][k]) if isinstance(v, torch.Tensor)
                    else v == ref[1][k])
            if not same:
                raise AssertionError(f"{route}: state[{k!r}] differs from "
                                     "the eager loop's")
    # the replays alone on the host clock
    host_us = {}
    for route, g, replays in (("graph", step_graph.graph, n),
                              ("unrolled", unrolled, n // UNROLL)):
        restore()
        ts._load_batch(state, packs, odoms)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(replays):
            g.replay()
        host_us[route] = 1e6 * (time.perf_counter() - t0) / replays
        torch.cuda.synchronize()
    # one replayed step: its launches by the tally, and the device kernels
    # a profiler trace of STEP_TRACE replays records
    restore()
    ts._load_batch(state, packs, odoms)
    per_step, by_name = device_kernels_per_replay(step_graph.graph,
                                                 STEP_TRACE)
    tally = {name: n for (name, _), n in sorted(step_graph.tally.items())}
    if sorted(tally) != sorted(STEP_PATH) or any(
            n != 1 for n in tally.values()):
        raise AssertionError(f"a replayed step launched {tally}, not one "
                             f"each of {STEP_PATH}")
    if per_step >= 20:
        raise AssertionError(f"a replayed step ran {per_step} device "
                             f"kernels: {by_name}")
    restore()
    out = {route: {
        "capture_ms": capture_ms.get(route),
        "replays": {"eager": 0, "graph": n, "unrolled": n // UNROLL}[route],
        "host_us_per_replay": host_us.get(route),
        "batch_dispatch_ms": [t[0] for t in times[route]],
        "device_ms_per_step": [t[1] / n for t in times[route]],
    } for route in times}
    print(f"# graph: a {n}-scan drain batch at G {pipe.matcher.G} from one "
          f"saved state, eager, step graph and {UNROLL}-step graph "
          f"bit-equal in every state tensor, launches {ref[0]} by the "
          f"tallies as by the eager loop; {json.dumps(out)} (device ms per "
          f"step: CUDA events over the batch, for the eager loop the "
          f"host-bound span)", flush=True)
    step_ms = out["graph"]["device_ms_per_step"]
    print(f"# graph step: launches per replay by the tally {tally} "
          f"({sum(tally.values())} launches); device kernels per replay "
          f"{per_step} ({json.dumps(by_name)}, a profiler trace of "
          f"{STEP_TRACE} replays); device ms per step {step_ms} (PR 13: "
          f"0.775 for about 487 device kernels)", flush=True)
    out["step"] = dict(tally=tally, device_kernels=per_step,
                       kernels_by_name=by_name)
    return out


# the launches of one drain step, in order, and the replays phase 5b
# traces to count its device kernels
STEP_PATH = ("ring_points", "scatter_occupancy", "smear_quantize",
             "score_windows", "score_tail", "stream_update")
STEP_TRACE = 16


def device_kernels_per_replay(graph, n: int):
    """(device kernels per replay, {kernel name: count per replay}) of n
    replays of `graph` under torch.profiler. Copies are not kernels; a
    graph's memset nodes (the launchers' cudaMemsetAsync) run as kernels
    named memset32 and are counted."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            graph.replay()
        torch.cuda.synchronize()
    names = collections.Counter(
        e.name[:80] for e in prof.events()
        if e.device_type == DeviceType.CUDA
        and not e.name.startswith(("Memcpy", "Memset")))
    if not names:
        raise AssertionError("the profiler recorded no device kernel")
    return (sum(names.values()) / n,
            {k: v / n for k, v in sorted(names.items())})


def classic_run(cfg, laser, data, dev, tag, eager=False):
    """run_mapping of a classic session; `eager` patches both matchers'
    eager route (Matcher._dispatch_eager, fresh tensors) in place of the
    program replays."""
    from slam_toolbox_tpu_torch.api import SlamSession

    sess = SlamSession(cfg, laser, device=dev)
    if eager:
        sess.mapper.initialize(laser.range_threshold)
        for m in (sess.mapper.sequential_matcher, sess.mapper.loop_matcher):
            m._dispatch = m._dispatch_eager
    return run_mapping(sess, data, tag)


def classic_path(cfg, laser, data, dev):
    """Phase 4. The classic session with its matches as program replays,
    then with the eager route: the same closures and trajectory (bit for
    bit, unless a repeat of the eager run shows the card's path
    nondeterministic) and the same K1-K3 launches by grid. Prints `#
    classic graphed vs eager:` with the rates and `sequential_match` host
    ms per scan; returns both records."""
    graphed = classic_run(cfg, laser, data, dev, "classic")
    eager = classic_run(cfg, laser, data, dev, "classic eager", eager=True)
    same_run("classic graphed vs eager", eager, graphed,
             lambda: classic_run(cfg, laser, data, dev,
                                 "classic eager again", eager=True))
    if (eager["launches"], eager["by_grid"]) != (graphed["launches"],
                                                 graphed["by_grid"]):
        raise AssertionError(
            f"classic: graphed launches {graphed['by_grid']} against the "
            f"eager run's {eager['by_grid']}")
    seq_ms = {tag: stage_times(r["sess"])["sequential_match"]["ms"]
              / r["scans"] for tag, r in (("graphed", graphed),
                                          ("eager", eager))}
    progs = graphed["sess"].mapper.sequential_matcher._programs
    print(f"# classic graphed vs eager: {graphed['rate']} and "
          f"{eager['rate']} scans/s, ATE {graphed['ate']} and "
          f"{eager['ate']} m, sequential_match {json.dumps(seq_ms)} host ms "
          f"per scan, K1-K3 launches equal by grid, {len(progs)} sequential "
          f"programs ({sum(p.replays for p in progs.values())} replays)",
          flush=True)
    return graphed, eager


def program_replays(matcher, kinds=("verify", "chain")) -> int:
    """Replays of a matcher's programs of the given kinds."""
    return sum(p.replays for k, p in matcher._programs.items()
               if k[0] in kinds)


def measure_program(tag, prog, n: int = 50) -> dict:
    """One program on the inputs its last run left: a replay bit-equal to
    its function run eagerly on the same inputs; the capture's ms; host
    us per replay (the replays alone, on the host clock); device ms per
    replay (CUDA events over n replays); the eager function's host ms
    (its launches, no wait) and its ms with the card synchronized. Prints
    `# programs: <tag>`."""
    import torch

    from slam_toolbox_tpu_torch.kernels import match_cuda as mc

    with mc.uncounted():
        torch.cuda.synchronize()
        ref = prog.fn(**prog.inputs)
        got = prog.run()
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"programs {tag}: the replay differs from "
                                 "the eager function")
        t0 = time.perf_counter()
        for _ in range(n):
            prog.graph.replay()
        host_us = 1e6 * (time.perf_counter() - t0) / n
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n):
            prog.graph.replay()
        e1.record()
        torch.cuda.synchronize()
        device_ms = e0.elapsed_time(e1) / n
        eager_host, eager_wall = [], []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prog.fn(**prog.inputs)
            eager_host.append(1e3 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
            eager_wall.append(1e3 * (time.perf_counter() - t0))
    rec = {"capture_ms": 1e3 * prog.capture_s, "host_us_per_replay": host_us,
           "device_ms_per_replay": device_ms,
           "eager_host_ms": min(eager_host), "eager_ms": min(eager_wall),
           "tally": {f"{k}@{G}": v for (k, G), v in sorted(prog.tally.items())}}
    print(f"# programs: {tag}: {json.dumps(rec)}, replay bit-equal to the "
          f"eager function", flush=True)
    return rec


def check_programs(cfg, laser, data, dev):
    """Phase 5c. The per-event programs of a fresh mapper on the card at
    the buckets phase 4's workload meets: the sequential match of a full
    running buffer (10 scans), penalized and not; the loop coarse match of
    the longest loop chain (loop_chain); the fused verify of that chain
    and of a 10-scan chain (chain buckets by length), and the near-chain
    match of a 10-scan chain, both from a pack pool of the run's scans.
    Each measured by measure_program; the device memory the card reserved
    before the first capture and after the last, and the part of it in
    graph pools. Prints `# programs:`."""
    import numpy as np
    import torch

    from slam_toolbox_tpu_torch.core.scan import LocalizedScan
    from slam_toolbox_tpu_torch.kernels import loop_verify as lv
    from slam_toolbox_tpu_torch.mapper import Mapper
    from slam_toolbox_tpu_torch.mapper import streaming as ts

    mapper = Mapper(cfg, device=dev)
    mapper.initialize(laser.range_threshold)
    seq, loop = mapper.sequential_matcher, mapper.loop_matcher
    scans = []
    for scan, tp in data:
        s = LocalizedScan(laser, scan.ranges, scan.odom_pose)
        s.set_corrected_pose(tp)
        scans.append(s)
    chain_i, qi = loop_chain(data, cfg.loop_search_maximum_distance)
    chain, q = [scans[i] for i in chain_i], scans[qi]
    near = scans[qi - 11:qi - 1]
    pool = ts.PackPool(laser.n_beams, dev)
    pool.add_scans(scans)
    torch.cuda.synchronize()
    reserved0 = torch.cuda.memory_reserved(dev)
    pools0 = graph_pool_bytes()
    center = np.asarray(q.sensor_pose, np.float64)
    out = {}
    for tag, m, base, pen, ref in (
            ("sequential match, penalized", seq, near, True, True),
            ("sequential match, unpenalized", seq, near, False, True),
            ("loop coarse match", loop, chain, False, False)):
        m._dispatch(q, base, center, pen, ref)
        P = len(m._base_points(base, center[:2])[0])
        key = ("match", P, laser.n_beams, pen, ref)
        out[f"{tag} G {m.G} P {P}"] = (m._programs[key], tag)
    for c in (chain, near):
        lv.dispatch_loop_verify(loop, seq, q, [c], cfg, pool=pool).numpy()
        Cb = lv.chain_bucket(len(c))
        key = ("verify", loop, lv._gates(cfg), Cb, pool.B, True)
        out[f"fused verify Cb {Cb} ({len(c)} scans)"] = (seq._programs[key],
                                                          None)
    lv.dispatch_chain_matches(seq, [(q, near)], pool)
    out["near-chain match Cb 16"] = (seq._programs[("chain", 16, pool.B)],
                                     None)
    torch.cuda.synchronize()
    reserved1 = torch.cuda.memory_reserved(dev)
    pools1 = graph_pool_bytes()
    recs = {tag: measure_program(tag, prog) for tag, (prog, _) in out.items()}
    in_pools = ("not measured" if pools0 is None or pools1 is None
                else f"+{pools1 - pools0} bytes")
    print(f"# programs memory: {len(out)} graphs, device memory reserved "
          f"{reserved0} bytes before the captures and {reserved1} after "
          f"(+{reserved1 - reserved0}; in graph pools {in_pools})",
          flush=True)
    return recs


def check_exact(cfg, laser, data, dev):
    """Phase 5c, the exact two-call match. A mapper at the bench geometry
    with the response expansion that the default ONLINE_SYNC
    configuration turns on; on each matcher a query on the map through
    match_scan(exact=True), and the same query moved 40 m off the map,
    whose fused response is 0, so match_scan takes the exact path through
    the coarse pass, its three expansions and the fine pass. Run once to
    capture the programs, then as replays and by the fresh-tensor route
    (Matcher.build_grid_eager and _run_pass_eager) in turns: the results
    bit for bit, K1-K3 launches equal by grid, and no K1-K3 launch of the
    replayed runs made outside a graph (wrapper launches counted apart
    from replays). Prints `# exact:`; returns {"by_grid", "direct"} of
    the replayed runs."""
    import numpy as np
    import torch

    from slam_toolbox_tpu_torch.core.scan import LocalizedScan
    from slam_toolbox_tpu_torch.kernels import match_cuda as mc
    from slam_toolbox_tpu_torch.kernels.match import Matcher
    from slam_toolbox_tpu_torch.mapper import Mapper

    mapper = Mapper(dataclasses.replace(cfg, use_response_expansion=True),
                    device=dev)
    mapper.initialize(laser.range_threshold)

    def scan_at(i, shift=0.0):
        s = LocalizedScan(laser, data[i][0].ranges, data[i][0].odom_pose)
        s.set_corrected_pose(np.asarray(data[i][1]) + [shift, 0.0, 0.0])
        return s

    ring = cfg.scan_buffer_size
    base = [scan_at(i) for i in range(ring)]
    q, far = scan_at(ring + 1), scan_at(ring + 1, 40.0)
    direct = collections.Counter()
    count = mc._count

    def counting(name, G):
        if not (torch.cuda.is_current_stream_capturing()
                or getattr(mc._uncounted, "on", False)):
            direct[name] += 1
        count(name, G)

    def pack(r):
        return np.concatenate([[r.response], r.sensor_pose,
                               r.covariance.ravel()])

    def run(m, eager):
        saved = Matcher.build_grid, Matcher._run_pass
        if eager:
            Matcher.build_grid = Matcher.build_grid_eager
            Matcher._run_pass = Matcher._run_pass_eager
        try:
            direct.clear()
            torch.cuda.synchronize()
            mc.reset_launch_counts()
            t0 = time.perf_counter()
            out = [pack(m.match_scan(q, base, exact=True)),
                   pack(m.match_scan(far, base))]
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / 2
        finally:
            Matcher.build_grid, Matcher._run_pass = saved
        return out, ms, launches_by_grid(), dict(direct)

    mc._count = counting
    recs, by_grid, replay_direct = {}, {}, {}
    try:
        for m in (mapper.sequential_matcher, mapper.loop_matcher):
            first, _, _, _ = run(m, False)   # captures the programs
            turns = [run(m, e) for e in (False, True, True, False)]
            for out, _, grid, _ in turns:
                if not all(np.array_equal(a, b) for a, b in zip(out, first)):
                    raise AssertionError(f"exact G {m.G}: replays and the "
                                         "eager route differ")
                if grid != turns[0][2]:
                    raise AssertionError(f"exact G {m.G}: launches {grid} "
                                         f"against {turns[0][2]}")
            replayed = [t for t, e in zip(turns, (0, 1, 1, 0)) if not e]
            if any(t[3] for t in replayed):
                raise AssertionError(f"exact G {m.G}: K1-K3 launched "
                                     f"outside a graph: {replayed[0][3]}")
            if first[1][0] != 0.0:
                raise AssertionError(f"exact G {m.G}: the off-map query "
                                     f"responded {first[1][0]}")
            passes = {k: p for k, p in m._programs.items() if k[0] == "pass"}
            na = sorted({k[1] for k in passes})
            if len(na) < 5:
                raise AssertionError(f"exact G {m.G}: pass programs {na}, "
                                     "not the coarse, 3 expansions and fine")
            recs[f"G {m.G}"] = {
                "ms_per_match_replays": [turns[0][1], turns[3][1]],
                "ms_per_match_eager": [turns[1][1], turns[2][1]],
                "pass_headings": na,
                "capture_ms": {f"{k[0]} {k[1]}": 1e3 * p.capture_s
                               for k, p in m._programs.items()
                               if k[0] in ("pass", "raster")},
                "eager_direct_launches": turns[1][3],
                "replay_direct_launches": turns[0][3],
                "response": [first[0][0], first[1][0]]}
            for name, counts in turns[0][2].items():
                for G, n in counts.items():
                    by_grid.setdefault(name, {})[G] = n
            for name in PATH_KERNELS:
                replay_direct[name] = replay_direct.get(name, 0) + sum(
                    t[3].get(name, 0) for t in replayed)
    finally:
        mc._count = count
    print(f"# exact: {json.dumps(recs)}; results bit-equal to the eager "
          f"route, launches equal by grid, none outside a graph on the "
          f"replayed runs", flush=True)
    return {"by_grid": by_grid, "direct": replay_direct}


def same_run(tag, a, b, rerun):
    """Hold run b to run a: the same closures and trajectory bit for bit.
    Where they differ, `rerun()` repeats a's configuration: if that pair
    differs too the card's path is not deterministic, and b is held to
    PARITY.md's 4 cm envelope instead; if not, the difference is b's own
    and fails. Returns the largest position difference."""
    import numpy as np

    if a["closures"] != b["closures"]:
        raise AssertionError(f"{tag}: {b['closures']} closures against "
                             f"{a['closures']}")
    gap = float(np.max(np.hypot(*(a["traj"][:, :2] - b["traj"][:, :2]).T)))
    if np.array_equal(a["traj"], b["traj"]):
        print(f"# {tag}: the same trajectory bit for bit", flush=True)
        return gap
    again = rerun()
    det_gap = float(np.max(np.hypot(
        *(a["traj"][:, :2] - again["traj"][:, :2]).T)))
    print(f"# {tag}: trajectories differ by up to {gap} m; a repeat of the "
          f"reference differs from it by up to {det_gap} m", flush=True)
    if det_gap == 0.0:
        raise AssertionError(f"{tag}: the card is deterministic here, yet "
                             f"the trajectories differ by {gap} m")
    if gap > 0.04:
        raise AssertionError(f"{tag}: {gap} m outside the 4 cm envelope")
    return gap


def timed(fn):
    """(fn(), host seconds with the card synchronized on both sides)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def continued(data, n_laps: int, seed: int, margin: float = 0.5):
    """n_laps more laps of the bench world after data's last scan: a new
    simulation from LAP[0], its odometry carried on from data's last
    odometry pose (rebased at data's last true pose), noise-free, with
    every beam that ends within `margin` of the outer walls dropped (NaN).
    The walls set the map's extent, so these scans stay inside it while
    their pose errors stay below the margin."""
    import numpy as np

    from slam_toolbox_tpu_torch.core import geometry
    from slam_toolbox_tpu_torch.core.scan import LocalizedScan
    from slam_toolbox_tpu_torch.io.dataset import LidarSimulator, SegmentWorld

    last_scan, last_true = data[-1]
    w, h = 16.0, 10.0
    sim = LidarSimulator(
        SegmentWorld.rooms(w, h), last_scan.laser, range_noise=0.0,
        odom_noise=(0.015, 0.006), seed=seed,
    )
    extra = sim.simulate(np.array(LAP * n_laps + [LAP[0]]), step=0.3)
    out = []
    for scan, tp in extra[1:]:
        ends = LocalizedScan(scan.laser, scan.ranges, tp).points_world()
        with np.errstate(invalid="ignore"):
            near = ((np.abs(ends[:, 0]) > w / 2 - margin)
                    | (np.abs(ends[:, 1]) > h / 2 - margin))
        ranges = np.where(near, np.nan, scan.ranges)
        odom = geometry.compose(
            last_scan.odom_pose,
            geometry.relative_pose(last_true, scan.odom_pose))
        out.append((LocalizedScan(scan.laser, ranges, odom), tp))
    return out


def cli_cases(fixture: str, dev):
    """The CLI's geometries on the CARMEN fixture: [(matcher, base scans,
    query scan)] for ONLINE_SYNC's sequential matcher (the running ring)
    and loop matcher (a loop chain) for the log's laser (G 2403 and G 633
    at 271 beams), on the log's scans at their true poses, thinned as the
    mapper's travel gate thins them."""
    import numpy as np

    from slam_toolbox_tpu_torch.core.params import ONLINE_SYNC
    from slam_toolbox_tpu_torch.core.scan import LocalizedScan
    from slam_toolbox_tpu_torch.io.carmen import read_carmen
    from slam_toolbox_tpu_torch.mapper import Mapper

    log = read_carmen(fixture)
    cfg = ONLINE_SYNC.replace(minimum_time_interval=3600.0)
    mapper = Mapper(cfg, device=dev)
    mapper.initialize(log.laser.range_threshold)
    kept, last = [], None
    for rec, tp in zip(log.records, log.ground_truth()):
        if last is None or (
                np.hypot(*(tp[:2] - last[:2])) >= cfg.minimum_travel_distance
                or abs(tp[2] - last[2]) >= cfg.minimum_travel_heading):
            scan = LocalizedScan(log.laser, rec.ranges, rec.odom_pose)
            scan.set_corrected_pose(tp)
            kept.append((scan, tp))
            last = tp
    chain, q = loop_chain(kept, cfg.loop_search_maximum_distance)
    ring = cfg.scan_buffer_size + 2
    print(f"# cli: {len(kept)} scans past the travel gate", flush=True)
    return [(mapper.sequential_matcher, [kept[i][0] for i in range(ring)],
             kept[ring + 1][0]),
            (mapper.loop_matcher, [kept[i][0] for i in chain], kept[q][0])]


def check_cli_kernels(fixture: str, dev):
    """K1-K3 and the step kernels at the CLI's geometries (cli_cases),
    their inputs formed as phase 2 forms them, each kernel held to its
    plain version as phase 2 holds it; K2 and K3 also on the adversarial
    patterns at both (G, hk). Returns ({G: {kernel: record}}, patterns
    checked)."""
    out, n_patterns = {}, 0
    for k, (matcher, base, query) in enumerate(cli_cases(fixture, dev)):
        tag = f"cli G={matcher.G}"
        print(f"# {tag}: {len(base)} base scans", flush=True)
        inp = kernel_inputs(matcher, base, query, dev)
        out[str(matcher.G)], grid = check_kernels(matcher, inp, tag)
        si = step_inputs(matcher, base, query, dev)
        seq = k == 0
        out[str(matcher.G)].update(check_step_kernels(
            matcher, si, grid, tag, (seq, seq, seq)))
        n_patterns += check_patterns(matcher.G, matcher.half_kernel,
                                     matcher._w, dev)[0]
    return out, n_patterns


def map_path(main_run, cfg, laser, data, dev, workdir):
    """Phase 10, the map outputs on the card: the main path's map on both
    occupancy routes and its incremental publish, the snapshot of the
    2,017-scan session, resume from the 8-lap snapshot, the multi-session
    merge with auto_align, and the CLI on the CARMEN fixture. Returns the
    K1-K3 launches of the align and CLI paths by grid, and the card tensor
    route's grids of the main path and the merge with their scans."""
    import dataclasses
    import os

    import numpy as np
    import torch

    from slam_toolbox_tpu_torch.api import SlamSession, cli
    from slam_toolbox_tpu_torch.api.merge import MapMerger
    from slam_toolbox_tpu_torch.io.dataset import ate_rmse
    from slam_toolbox_tpu_torch.kernels import match_cuda as mc
    from slam_toolbox_tpu_torch.kernels import occupancy as occ

    t_phase = time.perf_counter()
    # 1. the main path's map, on both routes, then an incremental publish
    sess = main_run["sess"]
    with occupancy_route(True):
        native, native_s = timed(sess.get_occupancy_grid)
    sess._grid_cache = None   # the tensor route renders anew
    with occupancy_route(False):
        tensor, tensor_s = timed(sess.get_occupancy_grid)
    main_scans = sess.mapper.all_processed_scans()
    same_grid("main-path map, native vs card tensor route", native, tensor)
    print(f"# map: {len(sess.trajectory)} scans at {native.resolution} m, "
          f"{json.dumps(grid_summary(native))}, native route {native_s} s, "
          f"card tensor route {tensor_s} s, bit-equal", flush=True)
    snap = os.path.join(workdir, "main.npz")
    _, save_s = timed(lambda: sess.serialize(snap))
    print(f"# snapshot: {len(sess.trajectory)} scans in {save_s} s, "
          f"{os.path.getsize(snap)} bytes", flush=True)
    # two more laps with loop closing off, so no closure moves a pose, and
    # inside the extent, so the publish folds them into the cached grid
    cache = sess._grid_cache
    n_old = cache["n"]
    sess.mapper.config = sess.config = dataclasses.replace(
        cfg, do_loop_closing=False)
    run_session(sess, continued(data, 2, seed=43), t0=0.1 * len(data))
    scans = sess.mapper.all_processed_scans()
    new = scans[n_old:]
    lo = np.min([s.bounding_box[0] for s in new], axis=0)
    hi = np.max([s.bounding_box[1] for s in new], axis=0)
    past = float(max(np.max(cache["mins"] - lo), np.max(hi - cache["maxs"])))
    if past > 0.0 or sess.mapper.graph.pose_revision != cache["rev"]:
        raise AssertionError(f"map: the 2 more laps reach {past} m past the "
                             f"extent or moved a pose")
    full = occ.create_from_scans(scans, cfg.map_resolution,
                                 cfg.min_pass_through,
                                 cfg.occupancy_threshold, device=dev,
                                 native=True)
    fold_s = {}
    for native in (True, False):
        folds = []
        fold = occ.add_scans_incremental

        def counted_fold(*a, **kw):
            folds.append(1)
            return fold(*a, **kw)

        sess._grid_cache = cache
        occ.add_scans_incremental = counted_fold
        try:
            with occupancy_route(native):
                inc, fold_s["native" if native else "tensor"] = timed(
                    sess.get_occupancy_grid)
        finally:
            occ.add_scans_incremental = fold
        route = "native" if native else "card tensor"
        if len(folds) != 1:
            raise AssertionError(f"map: the {route} publish after 2 more "
                                 f"laps ran {len(folds)} folds, not 1")
        same_grid(f"{route} publish after 2 more laps vs full rebuild",
                  inc, full)
    print(f"# map: 2 more laps to {len(scans)} scans ({len(new)} new, "
          f"{-past} m inside the extent at the nearest); the publish folded "
          f"them once on each route, native {fold_s['native']} s, card "
          f"tensor {fold_s['tensor']} s, equal to the full rebuild",
          flush=True)
    sess.mapper.config = sess.config = cfg

    # 2. resume: 8 laps, serialize, deserialize into a new streaming
    # session, laps 9-16
    k = len(data) // 2
    first = SlamSession(cfg, laser, device=dev, streaming=True,
                        drain_every=256)
    est1, gt1, odo1, _, _ = run_session(first, data[:k])
    half = os.path.join(workdir, "half.npz")
    _, save_s = timed(lambda: first.serialize(half))
    second = SlamSession(cfg, laser, device=dev, streaming=True,
                         drain_every=256)
    _, load_s = timed(lambda: second.deserialize(half))
    closures = []
    second.mapper.listeners.append(closures.append)
    est2, gt2, odo2, _, _ = run_session(second, data[k:], t0=0.1 * k)
    traj = second.trajectory
    gt_all, odo_all = np.concatenate([gt1, gt2]), np.concatenate([odo1, odo2])
    if traj.shape != (len(gt_all), 3) or not np.all(np.isfinite(traj)):
        raise AssertionError("resume: misshapen or non-finite trajectory")
    ate, ate_odom = ate_rmse(traj, gt_all), ate_rmse(odo_all, gt_all)
    print(f"# resume: {len(est1)} scans, snapshot {os.path.getsize(half)} "
          f"bytes saved in {save_s} s, loaded in {load_s} s, then "
          f"{len(est2)} scans: ATE {ate} m vs odometry {ate_odom} m, "
          f"{len(closures)} loop closures after the load", flush=True)
    if not ate < 0.5 * ate_odom or not closures:
        raise AssertionError("resume: ATE or closures off the bar")

    # 3. merge at a multi-session size: 8 submaps 20 m apart, submap 0
    # perturbed and aligned back against submap 1 (the same map, so the
    # right correction is the identity)
    n_sub = 8
    merger = MapMerger(device=dev)
    _, load_s = timed(lambda: [merger.add_submap(snap)
                               for _ in range(n_sub)])
    for i in range(n_sub):
        merger.set_correction(i, (20.0 * i, 0.0, 0.0))
    perturbed = np.array([0.3, -0.2, np.deg2rad(3.0)])
    merger.set_correction(0, perturbed)
    mc.reset_launch_counts()
    response, align_s = timed(lambda: merger.auto_align(1, 0))
    align_launches = launches_by_grid()
    corr = merger.corrections[0].copy()
    cpu = MapMerger(device="cpu")
    for i in (0, 1):
        cpu.add_scans(merger.submaps[i])
    cpu.set_correction(0, perturbed)
    with mc.uncounted():
        cpu_response = cpu.auto_align(1, 0)
    print(f"# align: {n_sub} submaps of {len(merger.submaps[0])} scans "
          f"loaded in {load_s} s; auto_align {align_s} s, response "
          f"{response}, correction {corr.tolist()} (card) vs "
          f"{cpu.corrections[0].tolist()} (CPU, response {cpu_response}); "
          f"launches {json.dumps(align_launches)}", flush=True)
    if response is None or np.hypot(*corr[:2]) > 0.1 or abs(
            corr[2]) > np.deg2rad(1.0):
        raise AssertionError("align: the perturbation was not recovered")
    if cpu_response is None or np.max(np.abs(
            cpu.corrections[0] - corr)) > 1e-5 or abs(
            cpu_response - response) > 1e-5:
        raise AssertionError("align: the card and the CPU disagree")
    if any(not align_launches[k] for k in PATH_KERNELS):
        raise AssertionError("align: a path kernel was not launched")
    with occupancy_route(True):
        m_native, m_native_s = timed(merger.merge)
    with occupancy_route(False):
        m_tensor, m_tensor_s = timed(merger.merge)
    same_grid("merge, native vs card tensor route", m_native, m_tensor)
    n_scans = sum(len(s) for s in merger.submaps)
    n_beams = sum(len(s.ranges) for sub in merger.submaps for s in sub)
    print(f"# merge: {n_sub} submaps, {n_scans} scans, {n_beams} beams, "
          f"{json.dumps(grid_summary(m_native))}, native route "
          f"{m_native_s} s, card tensor route {m_tensor_s} s, bit-equal",
          flush=True)

    # 4. the CLI on the CARMEN fixture, classic and streaming, then merge
    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "data", "loop_rooms.clf.gz")
    cli_checks, cli_patterns = check_cli_kernels(fixture, dev)
    cli_launches, outs = {}, []
    for extra in ([], ["--streaming"]):
        tag = "streaming" if extra else "classic"
        out = os.path.join(workdir, f"clf_{tag}")
        outs.append(out)
        mc.reset_launch_counts()
        rc, cli_s = timed(lambda: cli.main(
            ["run", "--dataset", fixture, "--out", out, "--device",
             str(dev)] + extra))
        cli_launches[tag] = launches_by_grid()
        with open(out + "_metrics.json") as f:
            m = json.load(f)
        check = SlamSession(cfg, laser, device=dev)
        check.deserialize(out + ".posegraph.npz")
        span = max(abs(e.source.state_id - e.target.state_id)
                   for e in check.mapper.graph.edges)
        print(f"# cli run ({tag}): rc {rc}, {cli_s} s, {json.dumps(m)}, "
              f"longest edge span {span} state ids, launches "
              f"{json.dumps(cli_launches[tag])}", flush=True)
        if not (rc == 0 and m["nodes"] > 100 and m["ate_rmse_m"] < 0.30
                and m["ate_rmse_m"] < m["ate_odom_m"] and span > 20):
            raise AssertionError(f"cli run ({tag}): off its bars")
        if not all(os.path.exists(out + ext) for ext in (".pgm", ".yaml",
                                                          "_trajectory.txt")):
            raise AssertionError(f"cli run ({tag}): an output is missing")
    merged = os.path.join(workdir, "clf_merged")
    rc = cli.main(["merge", outs[0] + ".posegraph.npz",
                   outs[1] + ".posegraph.npz", "--out", merged,
                   "--device", str(dev)])
    if rc != 0 or not os.path.exists(merged + ".pgm"):
        raise AssertionError("cli merge failed")
    torch.cuda.synchronize()
    print(f"# map path phase: {time.perf_counter() - t_phase} s", flush=True)
    return dict(align=align_launches, cli=cli_launches, checks=cli_checks,
                patterns=cli_patterns, grids={
                    "main": (main_scans, tensor.resolution, tensor),
                    "merge": (merger.merged_scans(), m_tensor.resolution,
                              m_tensor)})


# -- phase 11: the modes ------------------------------------------------------
# scripts/bench_suite.py's config-3 and config-4 worlds, laser,
# configuration and prior snapshot come from workloads_torch.py, cut here
# for the time limit (configs_torch.py runs them whole)

MODES_LIFELONG_SCANS = 6400    # config 3's first 6,400 of 19,241 raw scans
MODES_SWITCH_SCANS = 200       # per mode in the switch check
MODES_PRIOR_NODES = 10000      # config 4's prior, cut from 100,010 nodes
MODES_LOOP_ROWS = LOOP_ROWS    # config 4's circuit: 4 rows out and back


def mode_switches(ll, data, laser, dev, workdir):
    """The mode switches on the lifelong session's map: 200 scans in
    localization (the buffer bounds the graph), 200 back in mapping (the
    buffer's nodes stay); set_initial_pose 0.15 m and 0.03 rad off a
    fresh scan's pose next to a surviving node, which relocalizes within
    0.1 m of where the map puts it; manual_loop_closure moving one node
    0.5 m, on the card and on the CPU from the same snapshot (poses equal
    to 1e-6 m)."""
    import numpy as np

    from slam_toolbox_tpu_torch.api import SlamSession
    from slam_toolbox_tpu_torch.core import geometry
    from slam_toolbox_tpu_torch.io.dataset import LidarSimulator

    sess, n0, start = ll["sess"], len(ll["gts"]), ll["raw_scans"]
    if len(data) < start + 2 * MODES_SWITCH_SCANS:
        raise AssertionError("switch: the simulation is too short")
    t_phase = time.perf_counter()
    nodes = [sess.mapper.solver.n_nodes]
    sess.toggle_mode("localization")
    chunk = data[start:start + MODES_SWITCH_SCANS]
    run_session(sess, chunk, t0=0.1 * start)
    buffered = len(sess.localization_buffer_uids())
    nodes.append(sess.mapper.solver.n_nodes)
    sess.toggle_mode("mapping")
    if sess.localization_buffer_uids():
        raise AssertionError("switch: the buffer did not empty")
    nodes.append(sess.mapper.solver.n_nodes)
    chunk = data[start + MODES_SWITCH_SCANS:start + 2 * MODES_SWITCH_SCANS]
    est, _, _, _, _ = run_session(sess, chunk,
                                  t0=0.1 * (start + MODES_SWITCH_SCANS))
    nodes.append(sess.mapper.solver.n_nodes)
    if not (nodes[1] <= nodes[0] + sess.config.scan_buffer_size + 1
            and nodes[2] == nodes[1] and nodes[3] > nodes[2]):
        raise AssertionError(f"switch: node counts {nodes}")
    # set_initial_pose next to a surviving node of the first lap's middle
    surv = {s.unique_id: s for s in sess.mapper.all_processed_scans()}
    uid = min(surv, key=lambda u: abs(u - n0 // 20))
    node_true, node_map = ll["gts"][uid], np.array(surv[uid].corrected_pose)
    true_pose = node_true + np.array([0.12, 0.06, 0.02])
    sim = LidarSimulator(warehouse()[0], laser, range_noise=0.01, seed=97)
    expect = np.asarray(geometry.compose(
        node_map, geometry.relative_pose(node_true, true_pose)))
    guess = expect + np.array([0.15, -0.1, 0.03])
    sess.set_initial_pose(guess)
    pose, _ = sess.process_scan(sim.scan_at(true_pose), guess,
                                time=0.1 * (start + 2 * MODES_SWITCH_SCANS))
    reloc = float(np.hypot(*(pose[:2] - expect[:2])))
    print(f"# switch: nodes {nodes[0]}, after {MODES_SWITCH_SCANS} scans in "
          f"localization {nodes[1]} ({buffered} buffered), back in mapping "
          f"{nodes[2]}, after {len(est)} more {nodes[3]}; set_initial_pose "
          f"0.18 m off next to node {uid}: relocalized {reloc} m from the "
          f"map's pose", flush=True)
    if not reloc < 0.1:
        raise AssertionError(f"switch: relocalized {reloc} m off")
    # manual_loop_closure: the same call on the card and on the CPU, both
    # from the snapshot of this map
    snap = os.path.join(workdir, "switched.npz")
    sess.serialize(snap)
    out, moved = {}, {}
    scans = sess.mapper.all_processed_scans()
    mid = scans[len(scans) // 2].unique_id
    for where in ((dev, "cpu") if dev.type == "cuda" else ("cpu",)):
        s2 = SlamSession(sess.config, laser, device=where)
        s2.deserialize(snap)
        before = {s.unique_id: np.array(s.corrected_pose)
                  for s in s2.mapper.all_processed_scans()}
        target = [before[mid][0] + 0.5, before[mid][1], 0.0]
        s2.manual_loop_closure([(mid, target)])
        after = {s.unique_id: np.array(s.corrected_pose)
                 for s in s2.mapper.all_processed_scans()}
        d = {u: float(np.hypot(*(after[u][:2] - before[u][:2])))
             for u in after}
        out[str(where)] = after
        moved[str(where)] = (d[mid], max(d.values()),
                             sum(v > 1e-3 for v in d.values()))
    gap = 0.0
    if len(out) == 2:
        a, b = out.values()
        gap = max(float(np.hypot(*(a[u][:2] - b[u][:2]))) for u in a)
    print(f"# switch: manual_loop_closure moving node {mid} 0.5 m: after the "
          f"solve it sits {moved[str(dev)][0]} m from its pose before the "
          f"move (its edges pull it back), the largest move "
          f"{moved[str(dev)][1]} m, {moved[str(dev)][2]} nodes moved over "
          f"1 mm; card vs CPU max position difference {gap} m; phase part "
          f"{time.perf_counter() - t_phase} s", flush=True)
    if gap > 1e-6:
        raise AssertionError(f"switch: card and CPU differ by {gap} m")


def modes_path(dev, workdir, checked_grids,
               lifelong_scans=MODES_LIFELONG_SCANS,
               prior_nodes=MODES_PRIOR_NODES, loop_rows=MODES_LOOP_ROWS,
               resolution=0.01, beam_deg=1.0 / 3, laps=15):
    """Phase 11, the modes: config 3's lifelong deployment (cut in
    length), config 4's localization (a smaller prior) with SPEC_LOOP on
    and off, and the mode switches on the lifelong map. `checked_grids`
    are the grid sides phase 2 held K1-K3 at; a run at another fails.
    Returns the K1-K3 launches by grid of the lifelong and localization
    runs."""
    import numpy as np

    t_phase = time.perf_counter()
    check_grids = grid_check(checked_grids)
    (laser, data), sim_s = timed_host(
        lambda: warehouse_workload(laps, beam_deg))
    print(f"# modes: the warehouse's {laps} laps, {len(data)} raw scans "
          f"simulated in {sim_s} s", flush=True)
    ll = lifelong_run(
        dev, data, lifelong_cfg(
            True, correlation_search_space_resolution=resolution),
        laser, lifelong_scans, check_grids=check_grids)
    lifelong_bars("lifelong", ll)
    mode_switches(ll, data, laser, dev, workdir)

    snap = os.path.join(workdir, "prior.npz")
    (world4, build_s, save_s), _ = timed_host(
        lambda: build_prior_snapshot(snap, prior_nodes, laser, dev=dev))
    circuit, circ_s = timed_host(lambda: loc_circuit(world4, laser, loop_rows))
    print(f"# localization prior: {prior_nodes} nodes built in {build_s} s, "
          f"saved in {save_s} s, {os.path.getsize(snap)} bytes; circuit "
          f"{len(circuit)} scans ({loop_rows} rows out and back) simulated "
          f"in {circ_s} s", flush=True)
    cfg4 = loc_cfg(correlation_search_space_resolution=resolution)
    loc = localization_run("localization", dev, snap, circuit, laser, cfg4,
                           prior_nodes, check_grids)
    off = localization_run("localization spec_loop off", dev, snap, circuit,
                           laser, cfg4, prior_nodes, check_grids,
                           SPEC_LOOP=False)
    same = (np.array_equal(loc["traj"], off["traj"])
            and np.array_equal(loc["poses"], off["poses"]))
    print(f"# localization spec_loop on vs off: "
          f"{'the same trajectory bit for bit' if same else 'DIFFERENT'}; "
          f"{loc['rate']} and {off['rate']} scans/s, rmse {loc['rmse']} and "
          f"{off['rmse']} m", flush=True)
    if not same:
        raise AssertionError("localization: SPEC_LOOP changed the result")
    print(f"# modes phase: {time.perf_counter() - t_phase} s", flush=True)
    return dict(lifelong=ll["by_grid"], loc=loc["by_grid"],
                loc_spec=loc["spec"])


# -- phase 11b: config 2 whole ------------------------------------------------

def config2_path(dev, checked_grids):
    """Phase 11b: BASELINE config 2 whole (configs_torch.config2: the
    apartment's 40 laps, 5,080 raw scans, drains of 96, a warm pass and a
    timed pass, ATE below 0.15 m and a closure), K1-K3 at the grids phase
    2 checked. Prints `# config2:`; returns the timed pass's launches by
    grid."""
    from configs_torch import config2

    t_phase = time.perf_counter()
    rec = config2(dev, check_grids=grid_check(checked_grids))
    warm, timed_pass = rec["passes"]
    # each pass's peak over what was allocated when it started (the
    # earlier phases' sessions are still alive; each pass closes its own)
    peak = max(p["resources"]["peak_over_start_bytes"]
               for p in rec["passes"])
    start = timed_pass["resources"]["allocated_at_start_bytes"]
    print(f"# config2: {rec['raw_scans']} raw scans ({rec['laps']} laps), "
          f"{timed_pass['accepted']} accepted, {timed_pass['nodes']} nodes, "
          f"{timed_pass['closures']} closures, ATE {timed_pass['ate']} m "
          f"(warm pass {warm['ate']} m); {warm['rate']} and "
          f"{timed_pass['rate']} scans/s (warm, timed); launches by grid "
          f"{json.dumps(timed_pass['launches_by_grid'])}; peak allocated "
          f"{peak} bytes over a pass's start (the timed pass started at "
          f"{start} bytes, the earlier phases' sessions); pool "
          f"{json.dumps(timed_pass['resources']['pool'])}"
          f"; phase {time.perf_counter() - t_phase} s", flush=True)
    return timed_pass["launches_by_grid"]


# -- phase 11c: config 5 at a cut ---------------------------------------------
# configs_torch.config5 (scripts/bench_merge500k.py's 8 sessions), each
# session cut from 62,500 nodes to this many (20,000 nodes, 32,768 padded)
CONFIG5_NODES_PER = 2500


def align_kernels(dev, paths):
    """K1-K3 and the step kernels at config 5's align geometry (a 2 m
    search at 0.05 m, 61 beams: G 441, hk 1), on the inputs auto_align
    gives its match of session 1 against session 0 (MapMerger.align_problem
    on the sessions' snapshots), each held to its plain version as phase 2
    holds it (K7 in the match's mode: unpenalized, refined) and timed; K2
    and K3 also on the adversarial patterns. Returns ({kernel: record},
    patterns checked, G)."""
    from slam_toolbox_tpu_torch.api.merge import MapMerger

    merger = MapMerger(device=dev)
    for path in paths[:2]:
        merger.add_submap(path)
    matcher, probe, near = merger.align_problem(0, 1, search_size=2.0,
                                                resolution=0.05)
    tag = f"config5 align G={matcher.G}"
    print(f"# {tag}: {len(near)} base scans of {len(probe.ranges)} beams",
          flush=True)
    out, grid = check_kernels(matcher, kernel_inputs(matcher, near, probe,
                                                     dev), tag)
    si = step_inputs(matcher, near, probe, dev)
    out.update(check_step_kernels(matcher, si, grid, tag,
                                  (False, True, False)))
    n_patterns = check_patterns(matcher.G, matcher.half_kernel, matcher._w,
                                dev)[0]
    return out, n_patterns, matcher.G


def config5_path(dev, checked_grids, workdir):
    """Phase 11c: BASELINE config 5 at a cut (configs_torch.config5: 8
    sessions of CONFIG5_NODES_PER nodes at 61 beams built and saved,
    loaded, each aligned against the one before, merged at 0.1 m on both
    routes, bit-equal, the joint graph solved by distributed_lm_solve on
    a mesh of one, its programs replayed bit-equal, and by host_sparse_lm);
    bars: 7 of 7 aligned, every pose finite, chi2 below its start, within
    1 cm of the host solve of the same LM steps; then K1-K3 and the step
    kernels held to their plain versions at the align geometry
    (align_kernels), the grid the alignment's launches ran at. Prints `#
    config5:`; returns the alignment's launches by grid and the kernels'
    records."""
    from configs_torch import config5, merge_paths

    t_phase = time.perf_counter()
    sessions = 8
    rec = config5(dev, sessions, CONFIG5_NODES_PER, bars=False,
                  cache=workdir)
    checks, n_patterns, G = align_kernels(
        dev, merge_paths(sessions, CONFIG5_NODES_PER, merge_laser(), workdir))
    grid_check(tuple(checked_grids) + (G,))("config5", rec["launches_by_grid"])
    st = rec["stages"]
    print(f"# config5: {rec['nodes']} nodes ({sessions} sessions of "
          f"{CONFIG5_NODES_PER}), {rec['edges']} edges ({rec['cross_edges']} "
          f"across sessions); {rec['aligned']} of {sessions - 1} aligned, "
          f"responses {rec['responses']}; grid {json.dumps(rec['grid'])} "
          f"bit-equal on both routes; chi2 {rec['chi2_initial']} -> "
          f"{rec['chi2']}, CG iterations {rec['cg_iters']}, "
          f"{rec['host_dxy']} m {rec['host_dth']} rad from host_sparse_lm "
          f"of the same LM steps ({rec['default_host_dxy']} m from its "
          f"solve of up to 50 LM steps); launches by grid "
          f"{json.dumps(rec['launches_by_grid'])}; K1-K3, K5, K7, K8 "
          f"bit-equal at G {G}; seconds {json.dumps(st['seconds'])}; peak "
          f"allocated {json.dumps(st['peak_allocated_bytes'])}; phase "
          f"{time.perf_counter() - t_phase} s", flush=True)
    if rec["aligned"] != sessions - 1:
        raise AssertionError(f"config5: {rec['aligned']} of {sessions - 1} "
                             f"sessions aligned")
    if not rec["host_dxy"] < 0.01:
        raise AssertionError(f"config5: {rec['host_dxy']} m from "
                             f"host_sparse_lm")
    return rec["launches_by_grid"], checks, n_patterns, G


# -- phase 12: dist/ and the PCG tier -----------------------------------------
# chip_smoke's own copies of scripts/bench_dist.py's snake graph and
# tests/test_chain_precond.py's random chain (both import jax)
DIST_NODES = 12288
# the CPU meshes' CG iterations per LM step on this graph (DIST_SCALING.json
# mesh 1, DIST_SCALING_F64.json mesh 2), printed beside the card's
DIST_CPU_CG = {"f32": [11, 18, 21, 23, 23, 24, 26],
               "f64": [22, 27, 29, 30, 30, 30, 30]}
# the PCG tier's bar against the host solve on the snake graph: its CG stops
# at the 200 cap on most LM steps (the chain preconditioner leaves the
# aisles' loop coupling to CG), so it ends 0.16 m from the host optimum, as
# the JAX package's tier does on the CPU
# (test_torch_chain_precond.py::test_pcr_tier_snake_12k_matches_jax); its
# chi2 ends within 0.06% of the host solution's
PCG_TIER_MAX_DXY = 0.2
PCG_TIER_MAX_CHI2_REL = 0.002


def build_snake_graph(n_nodes, aisle_len=60, spacing=0.5, seed=0,
                      drift=0.01):
    """Snake path through warehouse aisles: odometry chain + loop edges
    between spatially adjacent nodes of neighboring aisles (every 4th
    node), with odometry drift (scripts/bench_dist.py)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    gt = np.zeros((n_nodes, 3))
    for i in range(1, n_nodes):
        aisle, k = divmod(i, aisle_len)
        x = k * spacing if aisle % 2 == 0 else (aisle_len - 1 - k) * spacing
        gt[i, :2] = (x, aisle * 1.0)
    edges = []
    cov_odom = np.diag([1e-3, 1e-3, 1e-4])
    cov_loop = np.diag([4e-3, 4e-3, 4e-4])

    def rel_pose(a, b):
        c, s = np.cos(a[2]), np.sin(a[2])
        d = b[:2] - a[:2]
        return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1],
                         np.arctan2(np.sin(b[2] - a[2]),
                                    np.cos(b[2] - a[2]))])

    init = gt.copy()
    for i in range(n_nodes - 1):
        rp = rel_pose(gt[i], gt[i + 1])
        rp[:2] += rng.normal(0, drift, 2)
        edges.append((i, i + 1, rp, cov_odom))
        c, s = np.cos(init[i, 2]), np.sin(init[i, 2])
        init[i + 1, :2] = init[i, :2] + np.array(
            [c * rp[0] - s * rp[1], s * rp[0] + c * rp[1]])
        init[i + 1, 2] = init[i, 2] + rp[2]
    for aisle in range(1, n_nodes // aisle_len):
        for k in range(0, aisle_len, 4):
            i = aisle * aisle_len + k
            if aisle % 2 == 1:
                j = (aisle - 1) * aisle_len + (aisle_len - 1 - k)
            else:
                j = (aisle - 1) * aisle_len + k
            if i < n_nodes and j < n_nodes:
                rp = rel_pose(gt[i], gt[j])
                rp[:2] += rng.normal(0, 0.002, 2)
                edges.append((i, j, rp, cov_loop))
    return gt, init, edges


def pack_graph(init, edges, n_pad, e_pad):
    """Padded arrays of a graph as the port's solvers take them: poses
    (n_pad, 3) f32, src/dst at the last node for padding edges, whitened
    by the solver's own sqrt-information, emask, free (node 0 the gauge,
    padding nodes not free)."""
    import numpy as np

    from slam_toolbox_tpu_torch.solver.se2_solver import _sqrt_info_3x3

    n = len(init)
    poses = np.zeros((n_pad, 3), np.float32)
    poses[:n] = init
    src = np.full(e_pad, n_pad - 1, np.int64)
    dst = np.full(e_pad, n_pad - 1, np.int64)
    rel = np.zeros((e_pad, 3), np.float32)
    si = np.zeros((e_pad, 3, 3), np.float32)
    em = np.zeros(e_pad, bool)
    for k, (i, j, rp, cov) in enumerate(edges):
        src[k], dst[k], rel[k] = i, j, rp
        si[k] = _sqrt_info_3x3(np.asarray(cov, np.float64))
        em[k] = True
    free = np.ones(n_pad, np.float32)
    free[n:] = 0.0
    free[0] = 0.0
    return poses, src, dst, rel, si, em, free


def random_spd_chain(n, seed=0):
    """(D (n,3,3), U (n-1,3,3)) of a random SPD block-tridiagonal system
    (tests/test_chain_precond.py)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    U = rng.normal(0, 0.3, (n - 1, 3, 3))
    D = np.zeros((n, 3, 3))
    for i in range(n):
        a = rng.normal(0, 1, (3, 3))
        D[i] = a @ a.T + 4.0 * np.eye(3)
    return D, U


def thomas_case(n, dtype, dev, seed=8):
    """K9's inputs at n nodes as `dtype` tensors on `dev`: (D, U, r, free)
    of a random SPD block-tridiagonal chain (random_spd_chain's
    distribution) with node 0 and every 97th node fixed and their
    couplings dropped, as the PCG tier builds U."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    a = rng.normal(0, 1, (n, 3, 3))
    D = a @ a.transpose(0, 2, 1) + 4.0 * np.eye(3)
    U = rng.normal(0, 0.3, (n - 1, 3, 3))
    free = np.ones(n)
    free[::97] = 0.0
    U = U * (free[:-1] * free[1:])[:, None, None]
    r = rng.normal(0, 1, (n, 3))
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)
                 for x in (D, U, r, free))


# the Thomas and dense tiers' snake graphs in phase 12; K9's sizes timed
# there (the Thomas tier's own, whole tiles of 128 rows; the Thomas tier
# ends at 4,095 nodes; 100,000 a long chain), and those held to the plain
# sweeps
THOMAS_TIER_NODES = 3072
DENSE_TIER_NODES = 1500
THOMAS_SIZES = (2100, THOMAS_TIER_NODES, 4095, 100000)
THOMAS_CHECKED = (2100, THOMAS_TIER_NODES)


def thomas_bound(n, dtype):
    """The bound of K9's factorization then one apply at n nodes: 80n - 45
    values read or written once (factorize D, U, f in and Sinv, T, W out;
    apply Sinv, T, W, r, f in and z out), and 287 operations a node (230
    to factorize, 57 to apply). The real floor is n dependent 3x3 steps,
    which no bytes or rate bound sees."""
    import torch

    f64 = dtype == torch.float64
    return bound((80 * n - 45) * (8 if f64 else 4),
                 287 * n * (SCALAR_OPS_PER_S / F64_OPS_PER_S if f64 else 1))


def check_thomas(dev):
    """K9 (cp.chain_factorize, cp.chain_apply) at THOMAS_SIZES in f32 and
    f64: device ms of the factorization and of one apply (graph replays),
    the wrappers' ms for the pair (CUDA events), the bound; at
    THOMAS_CHECKED (2,100 and the Thomas tier's THOMAS_TIER_NODES) also
    the plain pair (cp.factorize, cp.apply) on the card, timed, and K9
    held to it within 1e-5 (f32) / 1e-12 (f64) of each output's largest
    magnitude."""
    import torch

    from slam_toolbox_tpu_torch.solver import chain_precond as cp

    out = {}
    for dtype in (torch.float32, torch.float64):
        for n in THOMAS_SIZES:
            D, U, r, f = thomas_case(n, dtype, dev)
            fac = cp.chain_factorize(D, U, f)
            rec = {
                "factorize_device_ms": graph_ms(
                    lambda: cp.chain_factorize(D, U, f), 1, 10)[0],
                "apply_device_ms": graph_ms(
                    lambda: cp.chain_apply(*fac, r, f), 1, 10)[0],
                "ms": event_ms(lambda: cp.chain_apply(
                    *cp.chain_factorize(D, U, f), r, f), 5, 1)}
            rec["bound_ms"], rec["bound_by"] = thomas_bound(n, dtype)
            if n in THOMAS_CHECKED:
                def plain():
                    ref = cp.factorize(D, U, f)
                    return ref, cp.apply(*ref, r, f)

                (ref, z_ref), plain_s = timed(plain)
                z = cp.chain_apply(*fac, r, f)
                tol = 1e-5 if dtype == torch.float32 else 1e-12
                errs = [float((a - b).abs().max())
                        for a, b in zip((*fac, z), (*ref, z_ref))]
                scale = [float(b.abs().max()) for b in (*ref, z_ref)]
                rec.update(plain_ms=1e3 * plain_s, max_abs_err=max(errs),
                           rel_err=max(e / s for e, s in zip(errs, scale)))
                if any(e > tol * s for e, s in zip(errs, scale)):
                    raise AssertionError(f"chain_thomas n {n} {dtype}: "
                                         f"{errs} against {scale}")
            out[f"n={n} {str(dtype)[6:]}"] = rec
    return out


@contextlib.contextmanager
def lm_watch(eager: bool):
    """Inside the block lm_solve runs by the host's Python loop
    (LMLoop.run_eager) if `eager`, every WhileProgram launch sits in a
    profiler range of that name, and the host reads are counted: yields
    {"reads": reads in the block}."""
    import torch

    from slam_toolbox_tpu_torch.kernels import match_cuda as mc
    from slam_toolbox_tpu_torch.solver import se2_solver as ts

    log = {"reads": 0}
    run, read, launch = ts.LMLoop.run, ts._host_read, mc.WhileProgram.launch

    def counted(t):
        log["reads"] += 1
        return read(t)

    def ranged(self):
        with torch.profiler.record_function("WhileProgram.launch"):
            launch(self)

    ts._host_read, mc.WhileProgram.launch = counted, ranged
    if eager:
        ts.LMLoop.run = ts.LMLoop.run_eager
    try:
        yield log
    finally:
        ts.LMLoop.run, ts._host_read, mc.WhileProgram.launch = (
            run, read, launch)


def tier_runs(tier, args, cfg):
    """lm_solve on `args` (poses, src, dst, rel, sqrt_info, free on the
    card) with `cfg`'s settings: as one device loop (its capture
    included), by the host's loop, and as the device loop again, each
    held to the first bit for bit (poses, chi2, LM and CG iterations);
    then one LM step of each route traced. The device loop must read the
    host once a solve and call no cudaLaunchKernel inside its launch."""
    import numpy as np

    from slam_toolbox_tpu_torch.solver import se2_solver as ts

    f32 = np.float32

    def solve(max_iterations=cfg.max_iterations):
        return ts.lm_solve(
            *args, float(f32(cfg.initial_lm_lambda)),
            float(f32(cfg.function_tolerance)),
            float(f32(cfg.gradient_tolerance)),
            float(f32(cfg.parameter_tolerance)), max_iterations,
            cg_tol=float(f32(cfg.cg_tolerance)),
            cg_iters=cfg.cg_max_iterations)

    def run(eager):
        with lm_watch(eager) as log:
            (p, chi2, it), s = timed(solve)
        st = ts.lm_solve.last_stats
        if st["tier"] != tier or st["host_reads"] != log["reads"]:
            raise AssertionError(f"{tier} tier: stats {st}, {log}")
        return {"poses": p.numpy(), "chi2": float(chi2), "lm": it, "s": s,
                "cg": st["cg_iters"], "chunks": st["cg_chunks"],
                "reads": log["reads"], "route": st["route"]}

    graphed = run(False)
    eager = run(True)
    same_solve(f"{tier} tier device loop vs host loop", eager, graphed)
    graphed["max_abs_err"] = max(
        float(np.max(np.abs(eager["poses"] - graphed["poses"]))),
        abs(eager["chi2"] - graphed["chi2"]))
    again = run(False)
    same_solve(f"{tier} tier device loop again", graphed, again)
    for r in (eager, again):
        if (r["chi2"], r["lm"], r["chunks"]) != (
                graphed["chi2"], graphed["lm"], graphed["chunks"]):
            raise AssertionError(f"{tier} tier: {r['chi2']} {r['lm']} "
                                 f"{r['chunks']} against the first run's")
    if (graphed["reads"], again["reads"]) != (1, 1):
        raise AssertionError(f"{tier} tier: host reads {graphed['reads']}, "
                             f"{again['reads']} a solve")
    solve(1)   # the one-step bucket's capture, outside the traces
    prof = {}
    for tag, on_host in (("device loop", False), ("host loop", True)):
        with lm_watch(on_host) as log:
            _, prof[tag] = launch_profile(lambda: solve(1),
                                          span="WhileProgram.launch")
        prof[tag]["host_reads"] = log["reads"]
        prof[tag]["cg_iterations"] = ts.lm_solve.last_stats["cg_iters"]
    if prof["device loop"]["kernel_launch_calls_in_WhileProgram.launch"]:
        raise AssertionError(f"{tier} tier: the device loop launched "
                             f"kernels from the host: {prof}")
    return graphed, eager, again, prof


def tier_summary(graphed, eager, again, prof) -> dict:
    return {"lm": graphed["lm"], "cg": graphed["cg"],
            "cg_chunks": graphed["chunks"], "host_reads": graphed["reads"],
            "max_abs_err": graphed["max_abs_err"],
            "host_loop_reads": eager["reads"], "s": graphed["s"],
            "again_s": again["s"], "host_loop_s": eager["s"],
            "one_step_traced": prof}


def condition_tests(tier) -> int:
    """The WHILE tests of a solve that tier_summary describes: one before
    each loop and one after each pass, the LM loop's and each step's CG
    loop's."""
    return tier["lm"] + 1 + sum(c + 1 for c in tier["cg_chunks"])


def while_test_ms(dev, tests: int, short: int = 100, long: int = 1100):
    """K10's own cost on the card, which a trace cannot give (the
    profiler's kernel records inside conditional bodies came out
    incomplete): a WhileProgram whose body is three one-element kernels
    (a counter's decrement, its flag, a pass count) launched for `short`
    and for `long` passes, CUDA events, gives the ms of a pass; the same
    body captured `long - short` deep in one graph and replayed gives the
    ms of the body alone. The difference is what a condition test adds
    (the set_while kernel and the node's relaunch of its body). Beside
    it, `tests` host reads of the flag on an idle card (`_host_read`,
    wall clock): the host loop's way of making as many tests."""
    import torch

    from slam_toolbox_tpu_torch.kernels import match_cuda as mc
    from slam_toolbox_tpu_torch.solver import se2_solver as ts

    i64 = dict(dtype=torch.int64, device=dev)
    limit, cnt, flag, passes = (torch.zeros(1, **i64) for _ in range(4))

    def init():
        cnt.copy_(limit)
        passes.zero_()
        flag.copy_(cnt > 0)

    def body():
        cnt.sub_(1)
        flag.copy_(cnt > 0)
        passes.add_(1)

    out = {}
    with mc.uncounted():
        prog = mc.WhileProgram([init, ("while", flag, [body])], dev)
        try:
            for k in (short, long):
                limit.fill_(k)
                out[f"launch_ms_{k}"] = event_ms(prog.launch, 10, 2)
                if int(passes) != k:
                    raise AssertionError(f"device_loop: {int(passes)} "
                                         f"passes for {k}")
        finally:
            prog.close()
        out["body_ms"], _ = graph_ms(body, long - short, 5)
    out["pass_ms"] = (out[f"launch_ms_{long}"] - out[f"launch_ms_{short}"]
                      ) / (long - short)
    out["test_ms"] = out["pass_ms"] - out["body_ms"]
    torch.cuda.synchronize()
    _, read_s = timed(lambda: [ts._host_read(flag) for _ in range(tests)])
    out.update(tests=tests, host_reads_ms=1e3 * read_s)
    return out


def loop_chains(data, radius: float):
    """(chains, query) indices into `data` built as loop_chain builds a
    loop chain, every run kept: the second-lap query whose first-lap scans
    within `radius` form the most runs of consecutive scans (the longest
    runs at a tie)."""
    import numpy as np

    xy = np.array([tp[:2] for _, tp in data])
    half = len(xy) // 2
    best, best_q = [], half
    for q in range(half, len(xy)):
        near = np.hypot(*(xy[:half] - xy[q]).T) < radius
        runs, start = [], 0
        for i in range(half + 1):
            if i == half or not near[i]:
                if i > start:
                    runs.append(list(range(start, i)))
                start = i + 1
        key = (len(runs), sum(map(len, runs)))
        if key > (len(best), sum(map(len, best))):
            best, best_q = runs, q
    return best, best_q


def launch_profile(fn, span: str = "CGLoop.run"):
    """(fn(), its trace's counts) under torch.profiler, the card
    synchronized on both sides: host kernel launch calls (in all, and
    inside the record_function ranges named `span`), graph launch calls
    and synchronize calls, device kernels (copies and memsets apart),
    seconds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from slam_toolbox_tpu_torch.utils.metrics import GRAPH_CALLS, LAUNCH_CALLS

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
    host = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    spans = [(e.time_range.start, e.time_range.end) for e in host
             if e.name == span]
    launches = [e.time_range.start for e in host if e.name in LAUNCH_CALLS]
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    return out, {
        "kernel_launch_calls": len(launches),
        f"kernel_launch_calls_in_{span}": sum(
            any(a <= t <= b for a, b in spans) for t in launches),
        "graph_launch_calls": sum(e.name in GRAPH_CALLS for e in host),
        "sync_calls": sum("Synchronize" in e.name for e in host),
        "device_kernels": len(kernels), "s": s}


def per_iteration(prof, log):
    """A one-LM-step trace's counts per CG iteration of that step."""
    (iters,) = log["cg"]
    out = dict(prof, cg_iterations=iters, host_reads=log["reads"][0])
    for k in ("kernel_launch_calls", "kernel_launch_calls_in_CGLoop.run",
              "graph_launch_calls", "device_kernels"):
        out[f"{k}_per_cg_iteration"] = prof[k] / max(iters, 1)
    return out


@contextlib.contextmanager
def cg_watch(eager: bool):
    """Inside the block every CGLoop run (the distributed solve's CG) is
    logged, and every host read of the CG and LM loops counted: yields
    {"cg": iterations per LM step, "reads": reads per LM step}, a step's
    reads being its CG chunks and the LM loop's one. With `eager`, the
    loops launch their chunks eagerly (CGLoop.run_eager) in place of the
    graphs."""
    import torch

    from slam_toolbox_tpu_torch.solver import se2_solver as ts

    log = {"cg": [], "reads": [], "all_reads": 0}
    run, read = ts.CGLoop.run, ts._host_read
    base = ts.CGLoop.run_eager if eager else run

    def logged(self, inputs):
        with torch.profiler.record_function("CGLoop.run"):
            x, i = base(self, inputs)
        log["cg"].append(i)
        log["reads"].append(self.chunks + 1)
        return x, i

    def counted(t):
        log["all_reads"] += 1
        return read(t)

    ts.CGLoop.run, ts._host_read = logged, counted
    try:
        yield log
    finally:
        ts.CGLoop.run, ts._host_read = run, read
    if log["all_reads"] != sum(log["reads"]):
        raise AssertionError(f"host reads {log['all_reads']} against "
                             f"{log['reads']} per LM step")


def check_reads(tag, run):
    """At most ceil(CG / CG_CHUNK) + 1 host reads per LM step."""
    from slam_toolbox_tpu_torch.solver.se2_solver import CG_CHUNK

    bound = [max(1, -(-c // CG_CHUNK)) + 1 for c in run["cg"]]
    if any(r > b for r, b in zip(run["reads"], bound)):
        raise AssertionError(f"{tag}: host reads {run['reads']} per LM step "
                             f"above {bound}")


def same_solve(tag, a, b):
    """Hold solve b to solve a: the same CG iterations per LM step and
    poses bit for bit."""
    import numpy as np

    if a["cg"] != b["cg"] or not np.array_equal(a["poses"], b["poses"]):
        gap = float(np.max(np.abs(a["poses"][:, :2] - b["poses"][:, :2])))
        raise AssertionError(f"{tag}: CG {b['cg']} against {a['cg']}, "
                             f"poses differ by up to {gap} m")
    print(f"# {tag}: the same CG iterations and poses bit for bit",
          flush=True)


def dist_path(mapper, scan_at, data, loop_radius, grids):
    """Phase 12: dist/ and the PCG tier on the card under a world-size-1
    NCCL group (see dist_checks). Returns the K1-K3 launches of the sharded
    chain match by grid."""
    import socket

    import torch
    import torch.distributed as tdist

    from slam_toolbox_tpu_torch.dist import multihost

    t_phase = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(multihost.rank_device(0, "nccl"))
    tdist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                             rank=0, world_size=1)
    try:
        mesh = multihost.global_mesh()
        if (mesh.size, mesh.device.type, tdist.get_backend()) != (
                1, "cuda", "nccl"):
            raise AssertionError(f"dist: unexpected mesh {mesh}")
        out = dist_checks(mesh, mapper, scan_at, data, loop_radius, grids)
    finally:
        tdist.destroy_process_group()
    print(f"# dist phase: {time.perf_counter() - t_phase} s", flush=True)
    return out


def dist_checks(mesh, mapper, scan_at, data, loop_radius, grids):
    """The PCG tier (lm_solve past the ceiling) against host_sparse_lm on
    the 12,288-node snake graph, and the Thomas sweeps against PCR; the
    distributed solve on that graph in f32, f64 and with schwarz=False;
    each solve's CG chunks as graph replays against the eager chunks (bit
    for bit), its host reads and one LM step's launch calls;
    the sharded chain match on loop chains of the bench workload, bit-equal
    to match_scans_batch; the sharded raster of `grids` ({tag: (scans,
    resolution, create_from_scans' grid on the card)}), bit-equal, and the
    halo refresh's windows."""
    import numpy as np
    import torch

    from slam_toolbox_tpu_torch.core.params import SolverConfig
    from slam_toolbox_tpu_torch.dist import submap
    from slam_toolbox_tpu_torch.dist.match_dist import match_chains_sharded
    from slam_toolbox_tpu_torch.dist.solver_dist import distributed_lm_solve
    from slam_toolbox_tpu_torch.kernels import match_cuda as mc
    from slam_toolbox_tpu_torch.solver import chain_precond as cp
    from slam_toolbox_tpu_torch.solver import se2_solver as ts

    cfg = SolverConfig()
    dev = mesh.device
    _, init, edges = build_snake_graph(DIST_NODES)
    n, e = len(init), len(edges)

    def host_solve(init, edges):
        """The host reference: host_sparse_lm in f64 on the same edges,
        unpadded. ((poses, chi2, iterations), seconds)"""
        h_free = np.ones(len(init))
        h_free[0] = 0.0
        return timed(lambda: ts.host_sparse_lm(
            init.copy(), np.array([ed[0] for ed in edges]),
            np.array([ed[1] for ed in edges]),
            np.stack([ed[2] for ed in edges]),
            np.stack([ts._sqrt_info_3x3(ed[3]) for ed in edges]), h_free,
            cfg))

    def gap(poses, host):
        d = poses[:len(host)] - host
        dh = np.arctan2(np.sin(d[:, 2]), np.cos(d[:, 2]))
        return (float(np.max(np.hypot(d[:, 0], d[:, 1]))),
                float(np.max(np.abs(dh))))

    def hold_to_host(tag, run, host, t_args):
        """A tier's solve (tier_runs' first run) held to the host solve:
        finite poses, chi2 below the start's and within
        PCG_TIER_MAX_CHI2_REL of the host solution's chi2 taken in the
        tier's own f32 arithmetic on the same padded arrays (the f32
        problem's rel and weights are rounded), positions within
        PCG_TIER_MAX_DXY. Returns {chi2_0, host_chi2_f32, dxy, dth}."""
        poses, src, dst, rel, si, em, _ = t_args
        host_pad = np.zeros(tuple(poses.shape), np.float32)
        host_pad[:len(host)] = host
        host_chi2_f32 = float(ts.chi2_only(
            torch.from_numpy(host_pad).to(dev), src, dst, rel, si, em))
        chi2_0 = float(ts.chi2_only(poses, src, dst, rel, si, em))
        dxy, dth = gap(run["poses"], host)
        chi2 = run["chi2"]
        if not (np.all(np.isfinite(run["poses"])) and chi2 < chi2_0):
            raise AssertionError(f"{tag}: no progress or non-finite poses")
        if abs(chi2 - host_chi2_f32) > PCG_TIER_MAX_CHI2_REL * host_chi2_f32:
            raise AssertionError(f"{tag}: chi2 {chi2} not within "
                                 f"{PCG_TIER_MAX_CHI2_REL:.1%} of "
                                 f"{host_chi2_f32}")
        if dxy > PCG_TIER_MAX_DXY:
            raise AssertionError(f"{tag}: {dxy} m from the host solve")
        return {"chi2_0": chi2_0, "host_chi2_f32": host_chi2_f32,
                "dxy": dxy, "dth": dth}

    (host, host_chi2, host_iters), host_s = host_solve(init, edges)

    def parity(poses):
        return gap(poses, host)

    # 1. lm_solve's device tiers, each one program (LMLoop: the LM loop a
    # WHILE node, the CG loop one nested in it) against its eager route
    # (the same functions from the host's Python loop), and each held to
    # the host solve: the PCG tier with PCR on the snake padded as
    # compute() pads it (16,384 nodes); the Thomas tier at
    # THOMAS_TIER_NODES nodes; the dense tier at DENSE_TIER_NODES nodes
    # padded to 2,048. The counts are set to 0 before the solves and read
    # after: K9 and K10 must launch
    mc.reset_launch_counts()
    n_pad, e_pad = ts._pad_pow2(n, 256), ts._pad_pow2(e, 512)
    args = tuple(torch.from_numpy(a).to(dev)
                 for a in pack_graph(init, edges, n_pad, e_pad))
    graphed, eager, again, step_prof = tier_runs(
        "pcr", args[:5] + args[6:], cfg)
    near = hold_to_host("pcg tier", graphed, host, args)
    print(f"# pcg tier: {n} nodes, {e} edges padded to ({n_pad}, {e_pad}), "
          f"f32 on the card: {graphed['lm']} LM iterations, CG iterations "
          f"per step {graphed['cg']}, chi2 {near['chi2_0']} -> "
          f"{graphed['chi2']} (the host solve's {host_chi2} in f64, "
          f"{near['host_chi2_f32']} on the tier's f32 arrays), largest "
          f"difference to the host solve {near['dxy']} m {near['dth']} rad, "
          f"{graphed['s']} s as one device loop with its capture, "
          f"{again['s']} s launching it again ({eager['s']} s by the host's "
          f"loop; host sparse {host_s} s, {host_iters} LM iterations)",
          flush=True)
    tiers = {"pcr": dict(tier_summary(graphed, eager, again, step_prof),
                         host_solve=near)}
    for tier, nodes in (("thomas", THOMAS_TIER_NODES),
                        ("dense", DENSE_TIER_NODES)):
        _, t_init, t_edges = build_snake_graph(nodes)
        (t_host, t_host_chi2, t_host_iters), t_host_s = host_solve(t_init,
                                                                   t_edges)
        np_ = nodes if tier == "thomas" else ts._pad_pow2(nodes, 256)
        t_args = tuple(torch.from_numpy(a).to(dev) for a in pack_graph(
            t_init, t_edges, np_, ts._pad_pow2(len(t_edges), 512)))
        g, e_, a_, prof = tier_runs(tier, t_args[:5] + t_args[6:], cfg)
        t_near = hold_to_host(f"{tier} tier", g, t_host, t_args)
        tiers[tier] = dict(tier_summary(g, e_, a_, prof), host_solve=t_near)
        print(f"# {tier} tier: {nodes} nodes padded to {np_}: {g['lm']} LM "
              f"iterations, CG iterations per step {g['cg']}, chi2 "
              f"{t_near['chi2_0']} -> {g['chi2']} (the host solve's "
              f"{t_host_chi2} in f64, {t_near['host_chi2_f32']} on the "
              f"tier's f32 arrays), largest difference to the host solve "
              f"{t_near['dxy']} m {t_near['dth']} rad, {g['s']} s as one "
              f"device loop with its capture, {a_['s']} s launching it "
              f"again ({e_['s']} s by the host's loop; host sparse "
              f"{t_host_s} s, {t_host_iters} LM iterations)", flush=True)
    solver_launches = dict(mc.LAUNCHES)
    print(f"# pcg tier loops: {json.dumps(tiers)}; launches "
          f"{json.dumps(solver_launches)}", flush=True)
    for name in SOLVER_KERNELS:
        if not solver_launches[name]:
            raise AssertionError(f"solver tiers: {name} never launched")
    k10 = while_test_ms(dev, condition_tests(tiers["thomas"]))
    print(f"# device loop: {json.dumps(k10)}", flush=True)

    # K9 against the plain sweeps at THOMAS_CHECKED, timed there and at
    # THOMAS_SIZES, f32 and f64; the sweeps against PCR at n = 2,100
    thomas = check_thomas(dev)
    Dt, Ut, rt, ft = thomas_case(2100, torch.float32, dev)
    z_thomas = cp.chain_apply(*cp.chain_factorize(Dt, Ut, ft), rt, ft)
    z_pcr = cp.pcr_solve(Dt, Ut, rt, ft, 13)
    z_thomas, z_pcr = z_thomas.cpu().numpy(), z_pcr.cpu().numpy()
    np.testing.assert_allclose(z_pcr, z_thomas, rtol=1e-4, atol=1e-5)
    print(f"# pcg thomas: {json.dumps(thomas)}; against PCR at n 2100 f32 "
          f"largest difference {float(np.max(np.abs(z_thomas - z_pcr)))}",
          flush=True)

    # 2. the distributed solve on the same graph: f32, f64, and the chain
    # preconditioner (schwarz=False) in f32; its CG chunks as graphs with
    # NCCL's all_reduces inside, then launched eagerly
    packed = pack_graph(init, edges, ts._pad_pow2(n, 1), e)
    for tag, dtype, schwarz in (("f32", np.float32, True),
                                ("f64", np.float64, True),
                                ("f32 schwarz=False", np.float32, False)):
        def solve(eager, max_iterations=50):
            with cg_watch(eager) as log:
                (d_out, d_chi2), d_s = timed(lambda: distributed_lm_solve(
                    mesh, *packed, cg_iters=200, dtype=dtype,
                    schwarz=schwarz, max_iterations=max_iterations))
            if log["cg"] != distributed_lm_solve.last_cg_iters:
                raise AssertionError(f"dist solve ({tag}): CG loops "
                                     f"{log['cg']}, LM steps "
                                     f"{distributed_lm_solve.last_cg_iters}")
            return {"poses": d_out, "chi2": d_chi2, "s": d_s, **log}

        graphed = solve(False)
        loop = distributed_lm_solve.last_cg_loop
        capture_ms = {k: 1e3 * p.capture_s for k, p in loop.programs.items()}
        eager = solve(True)
        same_solve(f"dist solve ({tag}) graphed vs eager", eager, graphed)
        again = solve(False)
        same_solve(f"dist solve ({tag}) replayed again", graphed, again)
        cg = graphed["cg"]
        step_prof = {}
        for ptag, run_eager in (("graphed", False), ("eager", True)):
            with cg_watch(run_eager) as log:
                _, prof = launch_profile(lambda: distributed_lm_solve(
                    mesh, *packed, cg_iters=200, dtype=dtype,
                    schwarz=schwarz, max_iterations=1))
            step_prof[ptag] = per_iteration(prof, log)
        dxy, dth = parity(graphed["poses"])
        print(f"# dist solve ({tag}): CG iterations per LM step {cg} (CPU "
              f"mesh {DIST_CPU_CG.get(tag)}), chi2 {graphed['chi2']}, "
              f"largest difference to the host solve {dxy} m {dth} rad, "
              f"{graphed['s']} s as CUDA graph chunks with their capture, "
              f"{again['s']} s replaying them ({eager['s']} s eager); host "
              f"reads per LM step {graphed['reads']}; capture ms "
              f"{json.dumps(capture_ms)}; one LM step traced "
              f"{json.dumps(step_prof)}", flush=True)
        check_reads(f"dist solve ({tag})", graphed)
        if not np.all(np.isfinite(graphed["poses"])):
            raise AssertionError(f"dist solve ({tag}): non-finite poses")
        if schwarz and (dxy >= 0.01 or max(cg) >= 200):
            raise AssertionError(f"dist solve ({tag}): parity {dxy} m or a "
                                 f"step at the CG cap {cg}")
        if step_prof["graphed"]["kernel_launch_calls_in_CGLoop.run"]:
            raise AssertionError(f"dist solve ({tag}): the CG loop "
                                 f"launched kernels from the host: "
                                 f"{step_prof['graphed']}")

    # 3. the sharded chain match on loop chains of the bench workload (G 561)
    chain_ids, q = loop_chains(data, loop_radius)
    if len(chain_ids) < 2:
        raise AssertionError("dist match: fewer than 2 loop chains")
    query = scan_at(q)
    chains = [[scan_at(i) for i in c] for c in chain_ids]
    matcher = mapper.loop_matcher
    torch.cuda.synchronize()
    mc.reset_launch_counts()
    got, match_s = timed(lambda: match_chains_sharded(matcher, query, chains,
                                                      mesh))
    by_grid = launches_by_grid()
    with mc.uncounted():
        ref = matcher.match_scans_batch(query, chains, penalize=False,
                                        refine=False)

    def rows(res):
        return np.array([[x.response, *x.sensor_pose, *x.covariance.ravel()]
                         for x in res])

    same = np.array_equal(rows(got), rows(ref))
    print(f"# dist match: {len(chains)} chains of {[len(c) for c in chains]} "
          f"scans for query scan {q}, {match_s} s, rows bit-equal to "
          f"match_scans_batch: {same}, launches {json.dumps(by_grid)}",
          flush=True)
    if not same:
        raise AssertionError("dist match: rows differ from match_scans_batch")
    if any(by_grid[k].get(str(matcher.G), 0) < len(chains)
           for k in PATH_KERNELS):
        raise AssertionError("dist match: a path kernel missed a chain")

    # 4. the sharded raster against create_from_scans on the card
    for tag, (scans, res, ref_grid) in grids.items():
        grid, raster_s = timed(lambda: submap.sharded_occupancy(
            mesh, scans, res))
        same_grid(f"dist raster ({tag})", grid, ref_grid)
        print(f"# dist raster ({tag}): {len(scans)} scans at {res} m, "
              f"{json.dumps(grid_summary(grid))}, {raster_s} s, bit-equal to "
              f"create_from_scans on the card", flush=True)
    scans, res, ref_grid = grids["main"]
    height, width = ref_grid.pass_cnt.shape
    halo = int(np.ceil(max(s.laser.range_threshold for s in scans) / res)) + 2
    band, _ = submap._band_geometry(height, mesh.size, halo)
    padded = np.zeros((band * mesh.size, width), np.int32)
    padded[:height] = ref_grid.pass_cnt
    owned = torch.from_numpy(padded[:band]).to(dev)
    view = submap.make_halo_refresh(mesh, band, halo, width)(owned)
    view = view.cpu().numpy()
    rows_checked = []
    for s in scans[::500]:
        mid = int(occ_row(s, ref_grid))
        lo, hi = max(mid - 80, 0), min(mid + 80, height)
        win, _ = submap.local_window(view, view, band, halo, 0, lo, hi)
        if not np.array_equal(win, padded[lo:hi]):
            raise AssertionError(f"dist halo: window [{lo}, {hi}) differs")
        rows_checked.append(mid)
    print(f"# dist halo: band {band}, halo {halo}, windows of 160 rows at "
          f"rows {rows_checked} equal to the full counters", flush=True)
    return by_grid, {"launches": solver_launches, "tiers": tiers,
                     "thomas": thomas, "device_loop": k10}


def solver_row(name, solver) -> dict:
    """The kernels line's row of K9 or K10 from phase 12: launches from
    its solver tiers' run; K9 timed at the Thomas tier's n =
    THOMAS_TIER_NODES in f32 (factorization then one apply) with its other
    sizes beside; K10 as what its condition tests add on the card
    (while_test_ms) times the tests of the Thomas tier's solve, against as
    many host reads of a flag (plain_ms, the host loop's way), its bound
    the flag reads of those tests, its error the largest difference
    between the tiers' device and host loops; the whole solves' times
    beside."""
    launches = solver["launches"][name]
    row = {"name": name, "route": "cuda",
           "source": f"slam_toolbox_tpu_torch/csrc/{name}.cu",
           "replaces": REPLACES[name], "replaces_pallas_kernel": None,
           "launches": launches, "library_ms": None,
           "launched_by": "phase 12's lm_solve tiers (dense, Thomas, PCR)"}
    if name == "chain_thomas":
        rec = solver["thomas"][f"n={THOMAS_TIER_NODES} float32"]
        row.update(max_abs_err=rec["max_abs_err"], ms=rec["ms"],
                   plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
                   bound_by=rec["bound_by"],
                   shape=f"n={THOMAS_TIER_NODES} f32, factorize then one "
                   f"apply", sizes=solver["thomas"])
        return row
    tiers, k10 = solver["tiers"], solver["device_loop"]
    tests = k10["tests"]
    t_bytes, by = bound(8 * tests, 0)
    row.update(max_abs_err=max(t["max_abs_err"] for t in tiers.values()),
               ms=k10["test_ms"] * tests, plain_ms=k10["host_reads_ms"],
               bound_ms=t_bytes, bound_by=by,
               shape=f"Thomas tier, {THOMAS_TIER_NODES} nodes, "
               f"{tiers['thomas']['lm']} LM steps: {tests} condition tests",
               test_measure=k10, solve_ms=1e3 * tiers["thomas"]["again_s"],
               host_loop_solve_ms=1e3 * tiers["thomas"]["host_loop_s"],
               tiers=tiers)
    return row


def occ_row(scan, grid):
    """The grid row of a scan's sensor."""
    return grid.world_to_grid(scan.sensor_pose[:2])[1]


def main() -> int:
    global TAIL_PHASE_LIB
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2

    from slam_toolbox_tpu_torch.api import SlamSession
    from slam_toolbox_tpu_torch.core.scan import LocalizedScan
    from slam_toolbox_tpu_torch.kernels import match_cuda as mc
    from slam_toolbox_tpu_torch.kernels import rasterize as rz
    from slam_toolbox_tpu_torch.kernels import step_cuda as sc
    from slam_toolbox_tpu_torch.mapper import Mapper

    dev = torch.device("cuda")
    card = card_line()
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
          f"card {card}", flush=True)

    # 1. build
    t0 = time.perf_counter()
    clock = start_phase_clock_build()
    build_s = mc.build_kernels(force=True)
    TAIL_PHASE_LIB = load_phase_clock(*clock)
    static = tail_static_smem()
    nvcc = subprocess.run([mc._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(f"# toolchain: {nvcc[-1]}; device_loop's runtime and driver "
          f"{json.dumps(mc.device_loop_versions())} (conditional nodes "
          f"need 12030 or later)", flush=True)
    print(f"# build: {len(mc.KERNELS)} kernels in {build_s:.2f} s, with "
          f"score_tail's phase clock build {time.perf_counter() - t0:.2f} "
          f"s; score_tail's static "
          f"shared memory {static} bytes (at most {sc.TAIL_STATIC_SMEM})",
          flush=True)

    # 2. kernels at both matcher geometries: the sequential matcher on the
    # running ring of scan_buffer_size scans, the loop matcher on a loop chain
    cfg, laser, data = bench_workload(n_laps=2)
    mapper = Mapper(cfg, device=dev)
    mapper.initialize(laser.range_threshold)

    def scan_at(i):
        s = LocalizedScan(laser, data[i][0].ranges, data[i][0].odom_pose)
        s.set_corrected_pose(data[i][1])
        return s

    chain, q = loop_chain(data, cfg.loop_search_maximum_distance)
    ring = cfg.scan_buffer_size + 2   # the streaming ring's slots
    bases = {
        "seq": (mapper.sequential_matcher, list(range(ring)), ring + 1),
        "loop": (mapper.loop_matcher, chain, q),
    }
    # the step kernels as each geometry's main path runs them: (penalize,
    # refine, step mode): the drain step at the sequential geometry, the
    # fused verify's coarse chain match at the loop geometry
    step_paths = {"seq": (True, True, True), "loop": (False, False, False)}
    checks, grids, steps, sis = {}, {}, {}, {}
    for tag, (matcher, base, qi) in bases.items():
        print(f"# {tag}: {len(base)} base scans, query scan {qi}",
              flush=True)
        inp = kernel_inputs(matcher, [scan_at(i) for i in base],
                            scan_at(qi), dev)
        checks[tag], grids[tag] = check_kernels(matcher, inp, tag)
        si = sis[tag] = step_inputs(matcher, [scan_at(i) for i in base],
                                    scan_at(qi), dev)
        steps[tag] = check_step_kernels(matcher, si, grids[tag], tag,
                                        step_paths[tag])
        if tag == "seq":
            ceiling = measure_ceiling(
                matcher, grids[tag], inp["d"], inp["ncand"])
    # K7's streamed mode on a 201 x 201 lattice and at 600 headings; K8's
    # eviction edge cases (the pushed mean at the origin)
    wide_tail = {what: check_tail_wide(cfg, laser, data, dev, chain, q,
                                       what) for what in TAIL_WIDE}
    edge_packed = torch.tensor(
        [0.7, 0.0, 0.0, 0.1, 1e-3, 0.0, 0.0, 0.0, 1e-3, 0.0, 0.0, 0.0,
         1e-3], device=dev)
    n_update_edges = check_update_edges(dev, sis["seq"]["scan_pack"],
                                        edge_packed)
    print(f"# stream_update edge cases: {n_update_edges} bit-equal (K "
          f"{UPDATE_SLOTS}, leading runs ending at {UPDATE_RUNS} and K, by "
          f"count and by distance)", flush=True)
    # K1, K7 and K5 past their former limits
    limits = check_limits(mapper.sequential_matcher, grids["seq"],
                          sis["seq"], dev)
    taps = {(m.G, m.half_kernel): m._w
            for m in (mapper.sequential_matcher, mapper.loop_matcher)}
    n_patterns, dense_ms = 0, {}
    for G, hk in PATTERN_GEOMETRIES:
        w = taps.get((G, hk))
        if w is None:
            w = torch.from_numpy(
                rz.smear_weights(max(hk, 1) / 2.0, hk)).to(dev)
        n, dense_ms[f"G={G} hk={hk}"] = check_patterns(G, hk, w, dev)
        n_patterns += n

    # 3. the card against the CPU on a short session at a coarser grid,
    # on both paths
    pcfg, plaser, pdata = bench_workload(n_laps=1, resolution=0.05,
                                         beam_deg=1.0, seed=7)
    for streaming in (False, True):
        trajs = []
        for where in ("cuda", "cpu"):
            sess = SlamSession(pcfg, plaser, device=where,
                               streaming=streaming, drain_every=16)
            run_session(sess, pdata[:40])
            trajs.append(sess.trajectory)
        if trajs[0].shape != trajs[1].shape:
            raise AssertionError("card and CPU accepted different scans")
        gap = float(np.max(np.hypot(*(trajs[0][:, :2] - trajs[1][:, :2]).T)))
        print(f"# parity (streaming={streaming}): {len(trajs[0])} scans, "
              f"card vs CPU max position difference {gap} m", flush=True)
        if gap > 0.04:
            raise AssertionError(f"card vs CPU trajectories differ: {gap}")

    # 4. the classic path at the bench geometry, cut to 2 laps: the
    # matches as program replays, then by the matchers' eager route
    classic, classic_eager = classic_path(cfg, laser, data, dev)

    # 5. no host synchronization in a drain's batch loop and its
    # speculative launches
    cfg16, laser16, data16 = bench_workload(n_laps=16)
    no_sync = check_no_sync(cfg16, laser16, data16, dev)

    # 5b. the drain's batch as step graph replays against the eager loop
    check_graph(cfg16, laser16, data16, dev)

    # 5c. the per-event programs: capture, replay and eager costs, memory;
    # the exact two-call match's programs against its eager route
    check_programs(cfg, laser, data, dev)
    exact = check_exact(cfg, laser, data, dev)

    # 6. the main path: the streaming pipeline on bench.py's full workload,
    # the defaults (speculation on)
    from slam_toolbox_tpu_torch.mapper import streaming as ts

    def streaming_run(tag, data_=data16, cfg_=cfg16, drain_every=256,
                      need_closure=True, eager=False, **switches):
        old = {k: getattr(ts, k) for k in switches}
        for k, v in switches.items():
            setattr(ts, k, v)
        try:
            sess = SlamSession(cfg_, laser16, device=dev, streaming=True,
                               drain_every=drain_every)
            if eager:   # the Python loop in place of the step graph
                pipe = sess._ensure_pipe()
                pipe._run_batch = pipe._run_eager
            return run_mapping(sess, data_, tag, need_closure=need_closure)
        finally:
            for k, v in old.items():
                setattr(ts, k, v)

    main_run = streaming_run("streaming")
    if main_run["verifies"] < 1:
        raise AssertionError("streaming: no fused loop verify ran")
    if main_run["spec"]["spec_chain_hit"] < 1:
        raise AssertionError("streaming: no speculative near-chain row used")
    # the graphed main path against the eager one: the same trajectory,
    # closures and launches (the replays' tallies against the wrappers')
    eager_run = streaming_run("streaming eager", eager=True)
    same_run("graphed vs eager", eager_run, main_run,
             lambda: streaming_run("streaming eager again", eager=True))
    if (eager_run["launches"], eager_run["by_grid"]) != (
            main_run["launches"], main_run["by_grid"]):
        raise AssertionError(
            f"graphed launches {main_run['by_grid']} against the eager "
            f"run's {eager_run['by_grid']}")
    dispatch = {tag: stage_times(r["sess"])["batch_dispatch"]
                for tag, r in (("graphed", main_run), ("eager", eager_run))}
    print(f"# graphed vs eager main path: {main_run['rate']} and "
          f"{eager_run['rate']} scans/s, ATE {main_run['ate']} and "
          f"{eager_run['ate']} m, batch_dispatch {json.dumps(dispatch)} "
          f"(ms), {main_run['sess'].stats.counts['batch_steps']} steps, "
          f"graph_capture "
          f"{json.dumps(stage_times(main_run['sess']).get('graph_capture'))}",
          flush=True)

    # 7. the same workload with the speculation off
    off_run = streaming_run("streaming spec off", SPECULATE=False)
    same_run("spec on vs off", off_run, main_run,
             lambda: streaming_run("streaming spec off again",
                                   SPECULATE=False))
    print(f"# spec on vs off: {main_run['rate']} and {off_run['rate']} "
          f"scans/s, ATE {main_run['ate']} and {off_run['ate']} m, "
          f"{main_run['closures']} closures", flush=True)

    # 8. the serial A/B drain against the pipelined one, 2 laps, drains of
    # 32, a loop attempt every drain (the reference's terminal attempt
    # in settle() would add one per serial drain at a cadence above 0)
    cfg0 = dataclasses.replace(cfg16, loop_attempt_interval_scans=0)
    two = data   # bench_workload(n_laps=2): the same configuration
    piped = streaming_run("pipelined 2 laps", two, cfg0, 32)
    serial = streaming_run("serial 2 laps", two, cfg0, 32, PIPELINED=False)
    same_run("serial vs pipelined", piped, serial,
             lambda: streaming_run("pipelined 2 laps again", two, cfg0, 32))
    print(f"# serial vs pipelined: {serial['rate']} and {piped['rate']} "
          f"scans/s", flush=True)

    # 9. warm_all, then 2 laps through the warmed session
    sess = SlamSession(cfg16, laser16, device=dev, streaming=True,
                       drain_every=256)
    mc.reset_launch_counts()
    t0 = time.perf_counter()
    sess.warm_all()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    if any(mc.LAUNCHES.values()):
        raise AssertionError(f"warming was counted: {mc.LAUNCHES}")
    warm_run = run_mapping(sess, two, "warmed 2 laps", need_closure=False)
    print(f"# warm_all: {warm_s} s, no launch counted; then "
          f"{warm_run['rate']} scans/s", flush=True)

    # 10. the map outputs: grids on both routes, snapshots and resume,
    # the multi-session merge with auto_align, the CLI
    with tempfile.TemporaryDirectory() as workdir:
        map_launches = map_path(main_run, cfg16, laser16, data16, dev,
                                workdir)

    # 11. the modes: config 3's lifelong deployment, config 4's
    # localization, the mode switches; K1-K3 at the grids phase 2 checked
    with tempfile.TemporaryDirectory() as workdir:
        modes = modes_path(dev, workdir, (mapper.sequential_matcher.G,
                                          mapper.loop_matcher.G))

    # 11b. config 2 whole: the apartment's 40 laps, two passes
    c2 = config2_path(dev, (mapper.sequential_matcher.G,
                            mapper.loop_matcher.G))

    # 11c. config 5 at a cut: 8 sessions of 2,500 nodes merged and solved;
    # K1-K3 and the step kernels at its align geometry (G 441)
    with tempfile.TemporaryDirectory() as workdir:
        c5, c5_checks, c5_patterns, c5_G = config5_path(
            dev, (mapper.sequential_matcher.G, mapper.loop_matcher.G),
            workdir)

    # 12. dist/ and the PCG tier under a world-size-1 NCCL group: the
    # solver tiers on the snake graph, the sharded chain match (K1-K3 at
    # G 561), the sharded raster of phase 10's grids
    dist_launches, solver = dist_path(mapper, scan_at, data,
                                      cfg.loop_search_maximum_distance,
                                      map_launches["grids"])

    # 13. kernels line, card line, result line
    def summary(r):
        return {"shape": r["shape"], "ms": r["ms"],
                "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                "library_ms": r["library_ms"]}

    rows = []
    for name in mc.KERNELS:
        if name in SOLVER_KERNELS:
            rows.append(solver_row(name, solver))
            continue
        if name == "score_ceiling":
            rec, loop = ceiling, None
        elif name == "score_windows":
            # the form every match launches (the head form) on top; the
            # table form (the exact match's, K4's comparison) beside it
            rec = steps["seq"]["score_windows_head"]
            loop = steps["loop"]["score_windows_head"]
        elif name in STEP_KERNELS:
            rec, loop = steps["seq"][name], steps["loop"][name]
        else:
            rec, loop = checks["seq"][name], checks["loop"][name]
        row = {
            "name": name, "route": "cuda",
            "source": f"slam_toolbox_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": main_run["launches"][name],
            "launches_by_grid": main_run["by_grid"].get(name, {}),
            "max_abs_err": max(rec["err"], loop["err"] if loop else 0),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound"][0], "bound_by": rec["bound"][1],
            "library_ms": rec["library_ms"],
            "shape": rec["shape"],
        }
        if name in STEP_KERNELS:
            row["cases_checked"] = rec["cases_checked"] + loop[
                "cases_checked"]
            row["replaces_pallas_kernel"] = None
        if name == "score_tail":
            row["mean_err"] = max(rec["mean_err"], loop["mean_err"])
            row["cov_rel_err"] = max(rec["cov_rel_err"], loop["cov_rel_err"])
        if name in STREAM_KERNELS:
            row["config5_align"] = dict(summary(c5_checks[name]), G=c5_G)
            row["max_abs_err"] = max(row["max_abs_err"],
                                     c5_checks[name]["err"])
            row["main_path_route"] = "step graph replays"
            row["eager_main_path_launches"] = eager_run["launches"][name]
            row["spec_off_launches"] = off_run["launches"][name]
            row["lifelong_launches_by_grid"] = modes["lifelong"][name]
            row["loc_launches_by_grid"] = modes["loc"][name]
            row["config2_launches_by_grid"] = c2[name]
            row["no_sync_spec_route_launches"] = no_sync["spec_launches"][name]
            row["cli"] = {G: {k: recs[name][k] for k in (
                "shape", "ms", "device_ms", "plain_ms", "replaced_device_ms")}
                for G, recs in map_launches["checks"].items()}
        if name in PATH_KERNELS:
            row["align_launches_by_grid"] = map_launches["align"][name]
            row["cli_launches_by_grid"] = {
                tag: counts[name]
                for tag, counts in map_launches["cli"].items()}
            row["cli"] = {}
            for G, recs in map_launches["checks"].items():
                head = name == "score_windows"
                r = recs["score_windows_head" if head else name]
                row["max_abs_err"] = max(row["max_abs_err"], r["err"])
                row["cli"][G] = summary(r)
                if name in STEP_KERNELS or head:
                    row["cli"][G]["replaced_device_ms"] = r[
                        "replaced_device_ms"]
                if head:
                    row["cli"][G]["table_form"] = summary(recs[name])
            row["dist_launches_by_grid"] = dist_launches[name]
            row["lifelong_launches_by_grid"] = modes["lifelong"][name]
            row["loc_launches_by_grid"] = modes["loc"][name]
            row["config2_launches_by_grid"] = c2[name]
            row["config5_align_launches_by_grid"] = c5[name]
            head = name == "score_windows"
            r = c5_checks["score_windows_head" if head else name]
            row["max_abs_err"] = max(row["max_abs_err"], r["err"])
            row["config5_align"] = dict(summary(r), G=c5_G)
            if name in STEP_KERNELS or head:
                row["config5_align"]["replaced_device_ms"] = r[
                    "replaced_device_ms"]
            if head:
                row["config5_align"]["table_form"] = summary(c5_checks[name])
            row["loc_spec"] = modes["loc_spec"]
            row["main_path_spec"] = main_run["spec"]
            row["spec_off_launches"] = off_run["launches"][name]
            row["main_path_route"] = "step graph replays"
            row["classic_route"] = "program replays (CUDA graphs)"
            row["exact_route"] = "program replays (CUDA graphs)"
            row["exact_launches_by_grid"] = exact["by_grid"].get(name, {})
            row["exact_launches_outside_graphs"] = exact["direct"][name]
            row["classic_launches_by_grid"] = classic["by_grid"][name]
            row["eager_classic_launches"] = classic_eager["launches"][name]
            row["eager_main_path_launches"] = eager_run["launches"][name]
            row["no_sync_spec_route_launches"] = no_sync["spec_launches"][name]
        if loop:
            row["loop"] = {
                "shape": loop["shape"], "ms": loop["ms"],
                "plain_ms": loop["plain_ms"], "bound_ms": loop["bound"][0],
                "bound_by": loop["bound"][1],
                "library_ms": loop["library_ms"],
            }
            for key in DEVICE_KEYS:
                if key in rec:
                    row[key] = rec[key]
                    row["loop"][key] = loop[key]
            if name in ("scatter_occupancy", "smear_quantize"):
                row["patterns_checked"] = (n_patterns
                                           + map_launches["patterns"]
                                           + c5_patterns)
            if name == "smear_quantize":
                row["dense_device_ms"] = dense_ms
                row["empty_tile_rows"] = rec["empty_tile_rows"]
                row["loop"]["empty_tile_rows"] = loop["empty_tile_rows"]
            if name == "score_windows":
                table, table_loop = checks["seq"][name], checks["loop"][name]
                row["form"] = ("head (step_cuda.score_windows_head: the "
                               "match's headings, tables and origin formed "
                               "in the kernel)")
                row["also_replaces"] = (
                    "slam_toolbox_tpu/kernels/match.py:749-760 _score_impl's "
                    "coarse headings, tables (:612 _rotated_tables), origin")
                row["table_form"] = summary(table)
                row["table_form"]["loop"] = summary(table_loop)
                row["table_form"]["max_abs_err"] = max(table["err"],
                                                       table_loop["err"])
                row["beam_classes"] = table["beam_classes"]
                row["loop"]["beam_classes"] = table_loop["beam_classes"]
                row["cases_checked"] = (
                    rec["cases_checked"] + loop["cases_checked"]
                    + table["cases_checked"] + table_loop["cases_checked"])
        else:
            row["launched_by"] = "the ceiling measurement of phase 2"
            row["measurement_launches"] = rec["launches"]
            row["device_ms"] = rec["device_ms"]
            row["device_ms_partial"] = rec["device_ms_partial"]
            row["score_windows_tiled_device_ms"] = rec["k1_tiled_device_ms"]
            row["score_windows_pct_of_ceiling"] = rec["k1_pct_of_ceiling"]
            row["score_windows_ms"] = rec["k1_ms"]
            row["score_windows_device_ms"] = rec["k1_device_ms"]
            row["fixed_device_ms"] = rec["fixed_device_ms"]
            row["gathers"] = rec["gathers"]
            row["offset_classes"] = rec["offset_classes"]
            row["cases_checked"] = rec["cases_checked"]
            row["sass"] = rec["sass"]
        if name == "score_tail":
            for r, dst in ((rec, row), (loop, row["loop"])):
                dst["mode"] = r["mode"]
                dst["cluster"] = r["cluster"]
                dst["streamed_device_ms"] = r["streamed_device_ms"]
                dst["phase_ms"] = dict(zip(TAIL_PHASES, r["phase_ms"]))
                dst["other_geometries"] = r["geometries"]
            row["repeats_equal"] = (rec["repeats_equal"]
                                    + loop["repeats_equal"])
            row["streamed"] = wide_tail
        if name == "stream_update":
            row["edge_cases_checked"] = n_update_edges
            row["edge_case_slots"] = list(UPDATE_SLOTS)
        if name in limits:
            row["over_limit"] = limits[name]
        if name == "smear_quantize":
            row["over_limit"] = {
                f"G={G} hk={hk}": {"patterns_checked": True,
                                   "dense_device_ms": dense_ms[
                                       f"G={G} hk={hk}"],
                                   "scratch_bytes": mc.smear_scratch_bytes(
                                       G, hk)}
                for G, hk in PATTERN_GEOMETRIES
                if mc.smear_scratch_bytes(G, hk) or hk >= G}
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
