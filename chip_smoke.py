#!/usr/bin/env python3
"""Smoke run of the PyTorch port (slam_toolbox_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is caught:
  1. build    — compile the four CUDA kernels from csrc/ with nvcc for
                sm_90a (one process per source, in parallel);
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
  5. no sync  — on a pipeline that has committed the bench workload's
                first drain, the second drain's batch loop (256 scans) and
                its speculative launches (the near-chain matches of its
                predicted chains, here 16 pairs of its scans with chains
                of committed scans, and the fused verify of its newest
                scan's predicted loop candidates, with EARLY_VERIFY off as
                in localization) under
                torch.cuda.set_sync_debug_mode("error"); the speculative
                rows bit-equal to the non-speculative path's, and the
                commit then uses the speculative rows;
  6. streaming — bench.py's full workload (16 laps, about 2,030 scans)
                through SlamSession(streaming=True, drain_every=256,
                device="cuda") with the defaults (speculation on), the main
                path: ATE below half of odometry's, at least one loop
                closure and one fused verify, speculative near-chain rows
                used, every path kernel launched;
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
                drain_every=96) with LifelongMapper.stream_hook and
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
 12. dist     — under a world-size-1 NCCL group on the card: the PCG tier
                (lm_solve past the dense ceiling, f32, padded to 16,384
                nodes: the PCR chain preconditioner) on scripts/
                bench_dist.py's 12,288-node snake graph against
                host_sparse_lm (chi2 within 0.2% of the host solution's on
                the same f32 arrays; positions within PCG_TIER_MAX_DXY), the
                Thomas sweeps against PCR at n = 2,100 (rtol 1e-4, atol
                1e-5); distributed_lm_solve on that graph in f32 and f64
                (within 1 cm of the host solve, no LM step at the CG cap)
                and with schwarz=False; match_chains_sharded on the bench
                workload's loop chains (rows bit-equal to
                match_scans_batch, K1-K3 launches at G 561 counted); the
                sharded raster of phase 10's main-path map (2,017 scans) and
                merge (16,136 scans) bit-equal to create_from_scans on the
                card, and the halo refresh's windows;
 13. the kernels line (JSON), the card's name and power limit, and the
     last line {"ok": true, "device": {...}}.

It exits non-zero with no result when no CUDA device is present. It imports
nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

MEM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
SCALAR_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
# the kernels every mapping path launches; score_ceiling runs only in its
# own entry point, the roofline measurement of phase 2
PATH_KERNELS = ("scatter_occupancy", "smear_quantize", "score_windows")
REPLACES = {
    "scatter_occupancy": "slam_toolbox_tpu/kernels/match_pallas.py:234",
    "smear_quantize": "slam_toolbox_tpu/kernels/match_pallas.py:394",
    "score_windows": "slam_toolbox_tpu/kernels/match_pallas.py:119",
    "score_ceiling": "scripts/exp_roofline.py:123",
}
# device time per launch from CUDA graph replays, where phase 2 takes it
DEVICE_KEYS = ("device_ms", "library_device_ms")
# the streaming pipeline's speculation counters a run reports
SPEC_COUNTS = ("spec_pairs", "spec_chain_hit", "spec_chain_miss",
               "spec_dispatch_abort", "spec_loop_dispatched", "spec_loop_hit",
               "spec_loop_partial", "spec_loop_miss")
# the adversarial occupancy patterns' geometries: both matchers', and a
# grid one row past a multiple of 32 with a single tap and with hk > 32
# (where the smear's row pass walks words beyond its three)
PATTERN_GEOMETRIES = ((2051, 20), (561, 1), (257, 0), (257, 40))

LAP = [
    (-6.0, -3.5), (1.5, -3.5), (5.5, -3.5), (5.5, 0.5), (5.5, 3.5),
    (1.0, 3.5), (-3.0, 3.5), (-6.0, 3.0), (-6.5, -1.0),
]


def bench_workload(n_laps: int, resolution: float = 0.01,
                   beam_deg: float = 1.0 / 3, seed: int = 42):
    """bench.py make_workload's world, laser and MapperConfig, in the
    port's own dataclasses, with `n_laps` laps instead of 16."""
    import numpy as np

    from slam_toolbox_tpu_torch.core.params import MapperConfig
    from slam_toolbox_tpu_torch.core.scan import LaserConfig
    from slam_toolbox_tpu_torch.io.dataset import LidarSimulator, SegmentWorld

    laser = LaserConfig(
        min_range=0.05, max_range=12.0, range_threshold=10.0,
        angular_resolution=np.deg2rad(beam_deg),
    )
    sim = LidarSimulator(
        SegmentWorld.rooms(16.0, 10.0), laser, range_noise=0.01,
        odom_noise=(0.015, 0.006), seed=seed,
    )
    data = sim.simulate(np.array(LAP * n_laps + [LAP[0]]), step=0.3)
    cfg = MapperConfig(
        minimum_travel_distance=0.2, minimum_time_interval=3600.0,
        scan_buffer_size=10,
        link_match_minimum_response_fine=0.1,
        link_scan_maximum_distance=1.5,
        loop_search_maximum_distance=3.0,
        loop_match_minimum_response_coarse=0.35,
        loop_match_minimum_response_fine=0.45,
        loop_match_maximum_variance_coarse=3.0,
        correlation_search_space_dimension=0.5,
        correlation_search_space_resolution=resolution,
        correlation_search_space_smear_deviation=0.1,
        distance_variance_penalty=0.5, angle_variance_penalty=1.0,
        loop_attempt_interval_scans=512,
    )
    return cfg, laser, data


def run_session(sess, data, on_scan=None, t0: float = 0.0):
    """Feed every scan, then flush; returns (estimates, ground truth,
    odometry, seconds of each accepted call that ran no drain, seconds of
    each call that ran a streaming drain, the flush included). Drains are
    seen through the session's stage counts, so with its stats disabled
    every call is in the first list. `on_scan(k)` runs before the k-th
    accepted scan's successor is fed (profile windows). Scan i is stamped
    t0 + 0.1 i."""
    import numpy as np

    counts = sess.stats.counts
    est, gt, odo, lat, drains = [], [], [], [], []
    for i, (scan, tp) in enumerate(data):
        n0 = counts.get("batch_dispatch", 0)
        t_call = time.perf_counter()
        out = sess.process_scan(scan.ranges, scan.odom_pose,
                                time=t0 + i * 0.1)
        dt = time.perf_counter() - t_call
        if counts.get("batch_dispatch", 0) != n0:
            drains.append(dt)
        elif out is not None:
            lat.append(dt)
        if out is not None:
            est.append(out[0])
            gt.append(tp)
            odo.append(scan.odom_pose)
            if on_scan is not None:
                on_scan(len(est))
    n0 = counts.get("batch_dispatch", 0)
    t_call = time.perf_counter()
    sess.flush()
    if counts.get("batch_dispatch", 0) != n0:
        drains.append(time.perf_counter() - t_call)
    return (np.stack(est), np.stack(gt), np.stack(odo), np.asarray(lat),
            np.asarray(drains))


def stage_times(sess) -> dict:
    """The session's per-stage host times: {stage: {calls, ms}}."""
    st = sess.stats
    return {k: {"calls": st.counts[k], "ms": 1e3 * v}
            for k, v in sorted(st.seconds.items())}


def run_mapping(sess, data, tag: str, need_closure: bool = True):
    """The main-path run of one session on the card: launch counts from 0,
    the scans, the flush, the counts read. Prints rate, latency, ATE,
    closures, launches, the speculation's counts and per-stage host
    times; returns a record."""
    import numpy as np
    import torch

    from slam_toolbox_tpu_torch.io.dataset import ate_rmse
    from slam_toolbox_tpu_torch.kernels import match_cuda as mc

    sess.stats.enabled = True
    closures = []
    sess.mapper.listeners.append(closures.append)
    torch.cuda.synchronize()
    mc.reset_launch_counts()
    t0 = time.perf_counter()
    est, gt, odo, lat, drains = run_session(sess, data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(mc.LAUNCHES)
    by_grid = launches_by_grid()
    traj = sess.trajectory
    if not (np.all(np.isfinite(traj)) and traj.shape == (len(est), 3)):
        raise AssertionError(f"{tag}: non-finite or misshapen trajectory")
    ate, ate_odom = ate_rmse(traj, gt), ate_rmse(odo, gt)
    st = sess.stats
    stages = stage_times(sess)
    verifies = st.counts["loop_verify_dispatch"] + st.counts["loop_verify"]
    print(f"# {tag}: {len(data)} scans in, {len(est)} accepted, {wall} s, "
          f"{len(est) / wall} scans/s, latency of the {len(lat)} calls "
          f"that ran no drain p50 {1e3 * np.percentile(lat, 50)} ms p95 "
          f"{1e3 * np.percentile(lat, 95)} ms", flush=True)
    if len(drains):
        print(f"# {tag}: {len(drains)} calls ran a drain (the flush "
              f"included): p50 {1e3 * np.percentile(drains, 50)} ms max "
              f"{1e3 * np.max(drains)} ms", flush=True)
    print(f"# {tag}: ATE {ate} m vs odometry {ate_odom} m, {len(closures)} "
          f"loop closures, {verifies} fused verify events, launches "
          f"{launches}, by grid side {by_grid}", flush=True)
    spec = {k: st.counts[k] for k in SPEC_COUNTS}
    print(f"# {tag} speculation: {json.dumps(spec)}, near_chain_match "
          f"{stages.get('near_chain_match', {}).get('ms', 0.0)} ms, "
          f"spec_dispatch {stages.get('spec_dispatch', {}).get('ms', 0.0)} "
          f"ms", flush=True)
    print(f"# {tag} stages (calls, host ms): {json.dumps(stages)}",
          flush=True)
    if not ate < 0.5 * ate_odom:
        raise AssertionError(f"{tag}: ATE {ate} not below half of {ate_odom}")
    if need_closure and not closures:
        raise AssertionError(f"{tag}: no loop closure fired")
    missing = [k for k in PATH_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"{tag}: kernels never launched: {missing}")
    return dict(launches=launches, by_grid=by_grid, verifies=verifies,
                ate=ate, scans=len(est), wall=wall, rate=len(est) / wall,
                traj=traj, closures=len(closures), spec=spec, sess=sess)


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


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


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
    from slam_toolbox_tpu_torch.kernels.match import (
        _f32, _rotated_tables, _scan_device_cache,
    )
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


def check_no_sync(cfg, laser, data, dev):
    """Phase 5. A streaming session commits the bench workload's first
    drain; its second drain's batch (256 scans) is then launched with its
    speculative launches under sync_debug_mode("error"), so any host
    synchronization between the batch's first scan and the last
    speculative launch raises: the pipeline's own _dispatch_spec (with
    EARLY_VERIFY off, so the newest scan's predicted loop candidates are
    verified too) and a near-chain speculation of 16 pairs of batch scans
    with committed chains. Then the speculative near-chain rows are held
    bit-equal to the non-speculative dispatch at the ring's centers, the
    batch is committed, and the speculative route's kernel launches and
    the commit's speculation counts are returned."""
    import numpy as np
    import torch

    from slam_toolbox_tpu_torch.api import SlamSession
    from slam_toolbox_tpu_torch.kernels import loop_verify as lv
    from slam_toolbox_tpu_torch.kernels import match_cuda as mc
    from slam_toolbox_tpu_torch.mapper import streaming as ts

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
    n = len(scans)
    pairs = spec_pairs_for(scans, committed)
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
    print(f"# no sync: a {n}-scan drain batch, its speculative launches "
          f"(the loop verify of {n_loop} predicted candidates) and "
          f"{len(pairs)} speculative near-chain matches ran "
          f"with no host synchronization; launches of the batch "
          f"{batch_launches}, of the speculation {spec_launches}; the "
          f"speculative near-chain rows bit-equal to the dispatch's; the "
          f"commit's speculation counts {json.dumps(counts)}", flush=True)
    if not n_loop:
        raise AssertionError("no-sync: the loop verify was not speculated")
    return dict(spec_launches=spec_launches, counts=counts)


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


def launches_by_grid():
    """The path kernels' launch counts since the last reset, by grid side:
    {kernel: {G: n}}."""
    from slam_toolbox_tpu_torch.kernels import match_cuda as mc

    out = {name: {} for name in PATH_KERNELS}
    for (name, G), n in sorted(mc.GRID_LAUNCHES.items()):
        if name in out:
            out[name][str(G)] = n
    return out


def timed(fn):
    """(fn(), host seconds with the card synchronized on both sides)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def occupancy_route(native: bool):
    """Send every render inside the block through one route: the native
    host Bresenham (native=True) or trace_beams on the card (a CUDA
    session's own choice)."""
    import functools

    from slam_toolbox_tpu_torch.kernels import occupancy as occ

    names = ("create_from_scans", "add_scans_incremental")
    old = {n: getattr(occ, n) for n in names}
    for n in names:
        setattr(occ, n, functools.partial(old[n], native=native))
    try:
        yield
    finally:
        for n in names:
            setattr(occ, n, old[n])


def grid_summary(grid) -> dict:
    import numpy as np

    from slam_toolbox_tpu_torch.kernels import occupancy as occ

    c = np.bincount(grid.cells.ravel(), minlength=256)
    return dict(shape=list(grid.cells.shape), free=int(c[occ.FREE]),
                occupied=int(c[occ.OCCUPIED]), unknown=int(c[occ.UNKNOWN]))


def same_grid(tag: str, a, b) -> None:
    """Bit-equal counters, cells and offset, or fail."""
    import numpy as np

    for key in ("pass_cnt", "hit_cnt", "cells", "offset"):
        if not np.array_equal(getattr(a, key), getattr(b, key)):
            raise AssertionError(f"{tag}: the grids' {key} differ")


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


def check_cli_kernels(fixture: str, dev):
    """K1-K3 at the CLI's geometries on the CARMEN fixture: ONLINE_SYNC's
    sequential and loop matchers for the log's laser (G 2403 and G 633 at
    271 beams), their inputs formed as phase 2 forms them from the log's
    scans at their true poses, thinned as the mapper's travel gate thins
    them, each kernel held bit-equal to its plain version; K2 and K3 also
    on the adversarial patterns at both (G, hk). Returns ({G: {kernel:
    record}}, patterns checked)."""
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
    out, n_patterns = {}, 0
    for matcher, base, qi in (
            (mapper.sequential_matcher, list(range(ring)), ring + 1),
            (mapper.loop_matcher, chain, q)):
        tag = f"cli G={matcher.G}"
        print(f"# {tag}: {len(kept)} scans past the travel gate, "
              f"{len(base)} base scans, query scan {qi}", flush=True)
        inp = kernel_inputs(matcher, [kept[i][0] for i in base],
                            kept[qi][0], dev)
        out[str(matcher.G)], _ = check_kernels(matcher, inp, tag)
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
# Own copies of scripts/bench_suite.py's config-3 and config-4 worlds,
# laser, configuration and prior snapshot (that file imports the JAX
# package inside its functions), on the port's io/dataset and serialization.

MODES_LIFELONG_SCANS = 6400    # config 3's first 6,400 of 19,241 raw scans
MODES_SWITCH_SCANS = 200       # per mode in the switch check
MODES_PRIOR_NODES = 10000      # config 4's prior, cut from 100,010 nodes
MODES_LOOP_ROWS = 4            # config 4's circuit: 4 rows out and back
# config 3's steady-state trigger as CONFIG3.json's bounded variants ran
# it (SLAM_SS_MIN=20 there); LifelongConfig's default 0 is the reference's
# decay alone, which does not plateau (0.78 nodes/scan in that record)
MODES_SS_MIN = 20


def warehouse(aisles: int = 4, length: float = 30.0, pitch: float = 4.0):
    """bench_suite._warehouse: aisles of racks with a mid-aisle gap and
    rack clutter every ~7 m, outer walls (no freestanding clutter, its
    default)."""
    from slam_toolbox_tpu_torch.io.dataset import SegmentWorld

    w = aisles * pitch + 4.0
    h = length + 4.0
    segs = [(-2, -2, w - 2, -2), (w - 2, -2, w - 2, h - 2),
            (w - 2, h - 2, -2, h - 2), (-2, h - 2, -2, -2)]
    for a in range(aisles):
        x = a * pitch + pitch / 2
        segs.append((x, 0.5, x, length / 2 - 1.5))
        segs.append((x, length / 2 + 1.5, x, length - 0.5))
        y0 = 2.0 + 1.3 * a
        while y0 < length - 2.0:
            d = 0.25 + 0.15 * ((a + int(y0)) % 3)
            segs.append((x - d, y0, x, y0))
            segs.append((x - d, y0, x - d, y0 + 0.6))
            segs.append((x - d, y0 + 0.6, x, y0 + 0.6))
            y0 += 6.5 + 0.9 * ((a * 7 + int(y0)) % 3)
    return SegmentWorld(segs), aisles, length, pitch


def serpentine(aisles, length, pitch):
    """bench_suite._serpentine: up one aisle, down the next."""
    import numpy as np

    wps = []
    for a in range(aisles):
        x = a * pitch
        wps += [(x, 0.0), (x, length)] if a % 2 == 0 else [(x, length),
                                                            (x, 0.0)]
    return np.array(wps)


def rows_world(n_rows: int, width: float = 62.0):
    """bench_suite._rows_world: horizontal broken-shelving rows every 2 m
    with per-row gap phases and boxes, walls at both x ends."""
    import numpy as np

    from slam_toolbox_tpu_torch.io.dataset import SegmentWorld

    segs = []
    for row in range(n_rows):
        y = row * 2.0 - 1.0
        phase = (row * 1.7) % 7.0
        for x0 in np.arange(-1.0 + phase - 7.0, width, 7.0):
            a = max(x0, 2.5)
            b = min(x0 + 5.5, width - 2.5)
            if b > a:
                segs.append((a, y, b, y))
        xb = 3.5 + ((row * 13) % 11)
        while xb < width - 3.5:
            d = 0.3 + 0.15 * ((row + int(xb)) % 3)
            segs.append((xb, y, xb, y + d))
            segs.append((xb, y + d, xb + 0.7, y + d))
            segs.append((xb + 0.7, y + d, xb + 0.7, y))
            xb += 6.3 + ((row * 7 + int(xb) * 3) % 5)
    segs.append((-1.0, -1.0, -1.0, n_rows * 2.0))
    segs.append((width, -1.0, width, n_rows * 2.0))
    return SegmentWorld(np.array(segs, dtype=np.float64))


def window(world, lo, hi, margin: float):
    """The segments of `world` whose bounding boxes come within `margin`
    of the box [lo, hi]: a raycast from inside the box to at most
    `margin` hits exactly what it hits in the whole world."""
    import numpy as np

    from slam_toolbox_tpu_torch.io.dataset import SegmentWorld

    s = world.segments
    keep = ((np.maximum(s[:, 0], s[:, 2]) >= lo[0] - margin)
            & (np.minimum(s[:, 0], s[:, 2]) <= hi[0] + margin)
            & (np.maximum(s[:, 1], s[:, 3]) >= lo[1] - margin)
            & (np.minimum(s[:, 1], s[:, 3]) <= hi[1] + margin))
    return SegmentWorld(s[keep])


def suite_laser(beam_deg: float = 1.0 / 3):
    """bench_suite._laser: 1081 beams over 360 degrees at its default."""
    import numpy as np

    from slam_toolbox_tpu_torch.core.scan import LaserConfig

    return LaserConfig(min_range=0.05, max_range=12.0, range_threshold=10.0,
                       angular_resolution=np.deg2rad(beam_deg))


def suite_cfg(**kw):
    """bench_suite._cfg: bench.py's mapper settings (G 2051 and 561)."""
    from slam_toolbox_tpu_torch.core.params import MapperConfig

    base = dict(
        minimum_travel_distance=0.2, minimum_time_interval=3600.0,
        scan_buffer_size=10,
        link_match_minimum_response_fine=0.1,
        link_scan_maximum_distance=1.5,
        loop_search_maximum_distance=3.0,
        loop_match_minimum_response_coarse=0.35,
        loop_match_minimum_response_fine=0.45,
        loop_match_maximum_variance_coarse=3.0,
        correlation_search_space_dimension=0.5,
        correlation_search_space_resolution=0.01,
        correlation_search_space_smear_deviation=0.1,
        distance_variance_penalty=0.5, angle_variance_penalty=1.0,
    )
    base.update(kw)
    return MapperConfig(**base)


def loc_cfg(**kw):
    """bench_suite's config-4 localization settings (its _loc_cfg): the
    self-similarity gates, the windowed solve, a loop attempt every 16
    scans."""
    return suite_cfg(**{**dict(
        minimum_travel_distance=0.2,
        loop_match_maximum_variance_coarse=0.16,
        loop_match_maximum_variance_fine=0.09,
        loop_closure_maximum_jump=1.0,
        localization_solve_radius=20.0,
        loop_attempt_interval_scans=16), **kw})


def build_prior_snapshot(path, n_nodes, laser, seed=7, dev="cpu"):
    """bench_suite.build_prior_snapshot: a config-4-scale prior written
    directly (simulated scans at serpentine poses over rows_world, an
    odometry chain plus a cross-row edge every 8th node, corrected poses
    with residual noise), saved with the port's save_snapshot. Each row's
    ranges come from its own simulator (seed 100 + row), raycast against
    the segments within the range of the pose, which hit what the whole
    world would. Returns (world, build s, save s)."""
    import numpy as np

    from slam_toolbox_tpu_torch.core.params import MapperConfig
    from slam_toolbox_tpu_torch.core.scan import LocalizedScan
    from slam_toolbox_tpu_torch.io.dataset import LidarSimulator
    from slam_toolbox_tpu_torch.io.serialization import save_snapshot
    from slam_toolbox_tpu_torch.mapper import Mapper

    step, width = 0.3, 62.0
    per_row = int(60.0 / step)
    n_rows = (n_nodes + per_row - 1) // per_row + 1
    world = rows_world(n_rows, width)
    rng = np.random.default_rng(seed)
    reach = laser.max_range + 0.5
    t0 = time.perf_counter()
    m = Mapper(MapperConfig(use_scan_matching=False), device=dev)
    m.initialize(laser.range_threshold)
    sm = m.sensor_manager
    cov_odom = np.diag([1e-3, 1e-3, 1e-4])
    cov_loop = np.diag([4e-3, 4e-3, 4e-4])
    prev, scans, sim, row_world = None, [], None, None
    for i in range(n_nodes):
        row, k = divmod(i, per_row)
        if k == 0:
            y = row * 2.0
            row_world = window(world, (0.0, y), (width, y), reach)
            sim = LidarSimulator(row_world, laser, range_noise=0.01,
                                 seed=100 + row)
        y = row * 2.0
        x = 1.0 + k * step if row % 2 == 0 else 1.0 + (per_row - 1 - k) * step
        gt = np.array([x, y, 0.0 if row % 2 == 0 else np.pi])
        sim.world = window(row_world, gt[:2], gt[:2], reach)
        r = sim.scan_at(gt)
        corrected = gt + rng.normal(0, [0.015, 0.015, 0.004])
        odom = gt + rng.normal(0, [0.05, 0.05, 0.01])
        s = LocalizedScan(laser, r, odom, time=float(i))
        s.set_corrected_pose(corrected)
        sm.add_scan(s)
        m.graph.add_vertex(s)
        if prev is not None:
            m.graph.link_scans(prev, s, s.sensor_pose, cov_odom)
        if row > 0 and k % 8 == 0:
            j = (row - 1) * per_row + (k if row % 2 == 1
                                       else per_row - 1 - k)
            if 0 <= j < len(scans):
                m.graph.link_scans(scans[j], s, s.sensor_pose, cov_loop)
        scans.append(s)
        sm.set_last_scan(s)
        prev = s
    for s in scans[-8:]:
        sm.add_running_scan(s)
    t1 = time.perf_counter()
    save_snapshot(m, path)
    return world, t1 - t0, time.perf_counter() - t1


def loc_circuit(world, laser, lap_rows: int = MODES_LOOP_ROWS, seed=29):
    """bench_suite's config-4 circuit: a serpentine over the first
    `lap_rows` rows and back (closed), fresh noise, simulated against the
    segments within range of the rows it drives."""
    import numpy as np

    from slam_toolbox_tpu_torch.io.dataset import LidarSimulator

    wps = []
    for row in range(lap_rows):
        y = row * 2.0
        wps += ([(1.0, y), (60.7, y)] if row % 2 == 0
                else [(60.7, y), (1.0, y)])
    for row in range(lap_rows - 1, -1, -1):
        y = row * 2.0
        wps += ([(60.7, y), (1.0, y)] if row % 2 == 0
                else [(1.0, y), (60.7, y)])
    near = window(world, (0.0, 0.0), (62.0, 2.0 * (lap_rows - 1)),
                  laser.max_range + 0.5)
    sim = LidarSimulator(near, laser, range_noise=0.01,
                         odom_noise=(0.012, 0.005), seed=seed)
    return sim.simulate(np.array(wps), step=0.3)


def timed_host(fn):
    """(fn(), host seconds) for host work (simulation, snapshot
    building)."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def survivors_ate(sess, gts, odos):
    """(ATE of the surviving nodes' corrected poses, of their odometry)
    against ground truth, raw RMSE in the map frame as bench_suite's
    config 3 takes it (unique_id is the accepted order)."""
    import numpy as np

    surv = [s for s in sess.mapper.all_processed_scans()
            if s.unique_id < len(gts)]
    gt = np.stack([gts[s.unique_id][:2] for s in surv])
    est = np.stack([s.corrected_pose[:2] for s in surv])
    odo = np.stack([odos[s.unique_id][:2] for s in surv])
    rms = lambda d: float(np.sqrt(np.mean(np.sum(d * d, axis=1))))
    return rms(est - gt), rms(odo - gt), len(surv)


def counted(fn, box: dict, key: str, when=lambda out: True):
    """fn wrapped to add one to box[key] per call whose result passes
    `when`."""
    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        if when(out):
            box[key] = box.get(key, 0) + 1
        return out
    return wrapped


def lifelong_run(dev, data, cfg, laser, n_scans, check_grids):
    """Config 3 on the card: the first n_scans of the lapped warehouse
    through SlamSession(streaming=True, drain_every=96) with
    LifelongMapper.stream_hook as the pipeline's post_finish, removals
    marginalized. Prints the node curve and the bars' numbers; returns
    the session, the ground truth and odometry of the accepted scans, and
    the launches by grid."""
    import numpy as np
    import torch

    from slam_toolbox_tpu_torch.api import SlamSession
    from slam_toolbox_tpu_torch.kernels import match_cuda as mc
    from slam_toolbox_tpu_torch.mapper.lifelong import (
        LifelongConfig, LifelongMapper,
    )

    sess = SlamSession(cfg, laser, streaming=True, drain_every=96,
                       device=dev)
    sess.stats.enabled = True
    closures = []
    sess.mapper.listeners.append(closures.append)
    ll = LifelongMapper(
        sess.mapper, LifelongConfig(steady_state_min_candidates=MODES_SS_MIN))
    decay_s = [0.0]

    def hook(scan):   # stream_hook, timed
        t = time.perf_counter()
        try:
            return ll.stream_hook(scan)
        finally:
            decay_s[0] += time.perf_counter() - t

    sess._ensure_pipe().post_finish = hook
    curve, gts, odos, errs = [], [], [], []
    half_nodes = None
    if dev.type == "cuda":
        torch.cuda.synchronize()
    mc.reset_launch_counts()
    t0 = time.perf_counter()
    for i, (scan, tp) in enumerate(data[:n_scans]):
        out = sess.process_scan(scan.ranges, scan.odom_pose, time=i * 0.1)
        if out is not None:
            gts.append(tp)
            odos.append(scan.odom_pose)
            errs.append(float(np.hypot(*(out[0][:2] - tp[:2]))))
        if i % 800 == 0:
            curve.append((i, sess.mapper.solver.n_nodes))
        if i == n_scans // 2:
            half_nodes = sess.mapper.solver.n_nodes
    sess.flush()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_grid = launches_by_grid()
    check_grids("lifelong", by_grid)
    nodes = sess.mapper.solver.n_nodes
    curve.append((n_scans, nodes))
    growth = (nodes - half_nodes) / (n_scans - n_scans // 2)
    ate, ate_odo, n_surv = survivors_ate(sess, gts, odos)
    e = np.asarray(errs)
    counts = sess.stats.counts
    marg = {k: counts[k] for k in ("marginal_factor_added",
                                   "marginal_factor_dup_skipped")}
    print(f"# lifelong: {n_scans} of the warehouse's raw scans (cut from "
          f"19,241 for the time limit), {len(gts)} accepted, {wall} s, "
          f"{len(gts) / wall} scans/s; nodes every 800 scans "
          f"{json.dumps(curve)}, final {nodes}, second-half growth "
          f"{growth} nodes/scan", flush=True)
    print(f"# lifelong: survivors-ATE {ate} m over {n_surv} survivors vs "
          f"their odometry's {ate_odo} m, online error p50 "
          f"{np.percentile(e, 50)} m p95 {np.percentile(e, 95)} m, "
          f"{len(closures)} loop closures, {json.dumps(marg)}, launches "
          f"by grid {by_grid}", flush=True)
    print(f"# lifelong stages (calls, host ms): "
          f"{json.dumps(stage_times(sess))}; the decay (stream_hook) "
          f"{1e3 * decay_s[0]} ms", flush=True)
    if not ate < 0.5 * ate_odo:
        raise AssertionError(f"lifelong: survivors-ATE {ate} not below "
                             f"half of {ate_odo}")
    if not closures:
        raise AssertionError("lifelong: no loop closure fired")
    if not growth < 0.02:
        raise AssertionError(f"lifelong: growth {growth} nodes/scan")
    if marg["marginal_factor_added"] < 1:
        raise AssertionError("lifelong: no marginalized removal")
    missing = [k for k in PATH_KERNELS if not by_grid[k]]
    if missing:
        raise AssertionError(f"lifelong: kernels never launched: {missing}")
    return dict(sess=sess, gts=gts, odos=odos, by_grid=by_grid,
                raw_scans=n_scans)


class GateCounter:
    """A mapper event listener counting the loop-closure checks by gate:
    candidates (coarse checks), past the coarse gates (fine checks),
    rejected by the fine response, the fine variance or the jump, and
    closed."""

    def __init__(self):
        self.counts = dict(candidates=0, past_coarse=0, rejected_fine=0,
                           rejected_variance=0, rejected_jump=0, closed=0)

    def info(self, msg):
        pass

    debug = begin_loop_closure = info

    def loop_closure_check(self, msg):
        c = self.counts
        if msg.startswith("COARSE RESPONSE"):
            c["candidates"] += 1
        elif msg.startswith("FINE RESPONSE"):
            c["past_coarse"] += 1
        elif msg.startswith("REJECTED (fine variance)"):
            c["rejected_variance"] += 1
        elif msg.startswith("REJECTED (jump"):
            c["rejected_jump"] += 1
        elif msg.startswith("REJECTED!"):
            c["rejected_fine"] += 1

    def end_loop_closure(self, msg):
        self.counts["closed"] += 1


def localization_run(tag, dev, snap, circuit, laser, cfg, n_prior,
                     check_grids, **switches):
    """Config 4 on the card: SlamSession(mode="localization",
    streaming=True, drain_every=16) loads the prior with LOCALIZE_AT_POSE
    at the circuit's first true pose, primes on its first scan and runs
    the rest, with the streaming module's `switches` set. Prints the
    numbers; returns the online poses, the trajectory and the counts."""
    import numpy as np
    import torch

    from slam_toolbox_tpu_torch.api import MatchType, SlamSession
    from slam_toolbox_tpu_torch.kernels import match_cuda as mc
    from slam_toolbox_tpu_torch.mapper import streaming as ts

    old = {k: getattr(ts, k) for k in switches}
    for k, v in switches.items():
        setattr(ts, k, v)
    try:
        sess = SlamSession(cfg, laser, mode="localization", streaming=True,
                           drain_every=16, device=dev)
        sess.stats.enabled = True
        _, load_s = timed_host(lambda: sess.deserialize(
            snap, MatchType.LOCALIZE_AT_POSE, initial_pose=circuit[0][1]))
        if sess.mapper.solver.n_nodes != n_prior:
            raise AssertionError(f"{tag}: loaded {sess.mapper.solver.n_nodes}"
                                 f" of {n_prior} nodes")
        gates = GateCounter()
        sess.mapper.add_listener(gates)
        solves = {}
        solver = sess.mapper.solver
        solver.compute_window = counted(solver.compute_window, solves,
                                        "windowed", lambda o: o is not None)
        solver.compute = counted(solver.compute, solves, "full")
        if dev.type == "cuda":
            torch.cuda.synchronize()
        mc.reset_launch_counts()
        poses, errs = [], []
        t0 = time.perf_counter()
        for i, (scan, tp) in enumerate(circuit):
            out = sess.process_scan(scan.ranges, scan.odom_pose, time=i * 0.1)
            if i == 0:
                prime_s = time.perf_counter() - t0
            if out is not None:
                poses.append(np.array(out[0]))
                errs.append(float(np.hypot(*(out[0][:2] - tp[:2]))))
        sess.flush()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_grid = launches_by_grid()
        check_grids(tag, by_grid)
    finally:
        for k, v in old.items():
            setattr(ts, k, v)
    e = np.asarray(errs)
    rmse = float(np.sqrt(np.mean(e * e)))
    nodes = sess.mapper.solver.n_nodes
    counts = sess.stats.counts
    spec = {k: counts[k] for k in SPEC_COUNTS}
    print(f"# {tag}: prior {n_prior} nodes loaded in {load_s} s, prime "
          f"{prime_s} s, {len(poses)} of {len(circuit)} scans in {wall} s "
          f"(prime included), {len(poses) / wall} scans/s; error p50 "
          f"{np.percentile(e, 50)} m p95 {np.percentile(e, 95)} m max "
          f"{e.max()} m rmse {rmse} m; nodes {nodes} (prior + buffer "
          f"{n_prior + cfg.scan_buffer_size}); solves {json.dumps(solves)}; "
          f"loop gates {json.dumps(gates.counts)}", flush=True)
    print(f"# {tag} speculation: {json.dumps(spec)}, launches by grid "
          f"{by_grid}", flush=True)
    print(f"# {tag} stages (calls, host ms): "
          f"{json.dumps(stage_times(sess))}", flush=True)
    if not rmse < 0.35:
        raise AssertionError(f"{tag}: rmse {rmse} m")
    if nodes > n_prior + cfg.scan_buffer_size + 1:
        raise AssertionError(f"{tag}: {nodes} nodes, prior {n_prior}")
    if gates.counts["closed"] < 1:
        raise AssertionError(f"{tag}: no localization closure accepted")
    if solves.get("windowed", 0) < 1:
        raise AssertionError(f"{tag}: no windowed solve")
    missing = [k for k in PATH_KERNELS if not by_grid[k]]
    if missing:
        raise AssertionError(f"{tag}: kernels never launched: {missing}")
    return dict(poses=np.stack(poses), traj=sess.trajectory, spec=spec,
                by_grid=by_grid, rate=len(poses) / wall, rmse=rmse)


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

    from slam_toolbox_tpu_torch.io.dataset import LidarSimulator

    t_phase = time.perf_counter()

    def check_grids(tag, by_grid):
        seen = {int(G) for k in PATH_KERNELS for G in by_grid[k]}
        if not seen <= set(checked_grids):
                raise AssertionError(
                f"{tag}: K1-K3 ran at grids {seen - set(checked_grids)} "
                f"that no phase held to their plain versions")

    laser = suite_laser(beam_deg)
    world, aisles, length, pitch = warehouse()
    sim = LidarSimulator(world, laser, range_noise=0.01,
                         odom_noise=(0.012, 0.005), seed=11)
    data, sim_s = timed_host(lambda: sim.simulate(
        np.concatenate([serpentine(aisles, length, pitch)] * laps),
        step=0.3))
    print(f"# modes: the warehouse's {laps} laps, {len(data)} raw scans "
          f"simulated in {sim_s} s", flush=True)
    ll = lifelong_run(
        dev, data, suite_cfg(loop_match_minimum_chain_size=5,
                             marginalize_on_removal=True,
                             correlation_search_space_resolution=resolution),
        laser, lifelong_scans, check_grids)
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

    # the host reference: host_sparse_lm in f64 on the same edges, unpadded
    h_free = np.ones(n)
    h_free[0] = 0.0
    (host, host_chi2, host_iters), host_s = timed(lambda: ts.host_sparse_lm(
        init.copy(), np.array([ed[0] for ed in edges]),
        np.array([ed[1] for ed in edges]), np.stack([ed[2] for ed in edges]),
        np.stack([ts._sqrt_info_3x3(ed[3]) for ed in edges]), h_free, cfg))

    def parity(poses):
        d = poses[:n] - host
        dh = np.arctan2(np.sin(d[:, 2]), np.cos(d[:, 2]))
        return (float(np.max(np.hypot(d[:, 0], d[:, 1]))),
                float(np.max(np.abs(dh))))

    # 1. the PCG tier: lm_solve past the dense ceiling, padded as compute()
    # pads (16,384 nodes: the PCR chain preconditioner), f32 on the card
    n_pad, e_pad = ts._pad_pow2(n, 256), ts._pad_pow2(e, 512)
    args = pack_graph(init, edges, n_pad, e_pad)
    poses, src, dst, rel, si, em, free = (torch.from_numpy(a).to(dev)
                                          for a in args)
    cg_log = []
    step = ts.pcg_step

    def logged(*a, **kw):
        x = step(*a, **kw)
        cg_log.append(ts.pcg_step.last_cg_iters)
        return x

    ts.pcg_step = logged
    try:
        f32 = np.float32
        (p_out, p_chi2, p_iters), pcg_s = timed(lambda: ts.lm_solve(
            poses, src, dst, rel, si, free,
            float(f32(cfg.initial_lm_lambda)),
            float(f32(cfg.function_tolerance)),
            float(f32(cfg.gradient_tolerance)),
            float(f32(cfg.parameter_tolerance)), cfg.max_iterations,
            cg_tol=float(f32(cfg.cg_tolerance)),
            cg_iters=cfg.cg_max_iterations))
    finally:
        ts.pcg_step = step
    p_out = p_out.cpu().numpy()
    p_chi2 = float(p_chi2)
    host_pad = np.zeros((n_pad, 3), np.float32)
    host_pad[:n] = host
    # the host solution's chi2 in the tier's own f32 arithmetic on the same
    # padded arrays (the f32 problem's rel and weights are rounded)
    host_chi2_f32 = float(ts.chi2_only(torch.from_numpy(host_pad).to(dev),
                                       src, dst, rel, si, em))
    chi2_0 = float(ts.chi2_only(poses, src, dst, rel, si, em))
    dxy, dth = parity(p_out)
    print(f"# pcg tier: {n} nodes, {e} edges padded to ({n_pad}, {e_pad}), "
          f"f32 on the card: {p_iters} LM iterations, CG iterations per step "
          f"{cg_log}, chi2 {chi2_0} -> {p_chi2} (the host solve's {host_chi2}"
          f" in f64, {host_chi2_f32} on the tier's f32 arrays), largest "
          f"difference to the host solve {dxy} m {dth} rad, {pcg_s} s (host "
          f"sparse {host_s} s, {host_iters} LM iterations)", flush=True)
    if not (np.all(np.isfinite(p_out)) and p_chi2 < chi2_0):
        raise AssertionError("pcg tier: no progress or non-finite poses")
    if abs(p_chi2 - host_chi2_f32) > PCG_TIER_MAX_CHI2_REL * host_chi2_f32:
        raise AssertionError(f"pcg tier: chi2 {p_chi2} not within "
                             f"{PCG_TIER_MAX_CHI2_REL:.1%} of {host_chi2_f32}")
    if dxy > PCG_TIER_MAX_DXY:
        raise AssertionError(f"pcg tier: {dxy} m from the host solve")

    # the Thomas sweeps once at n = 2,100 against PCR on the same system
    D, U = random_spd_chain(2100, seed=8)
    cfree = np.ones(2100)
    cfree[0] = 0.0
    r = np.random.default_rng(5).normal(0, 1, (2100, 3))
    Um = U * (cfree[:-1] * cfree[1:])[:, None, None]
    Dt, Ut, rt, ft = (torch.from_numpy(a).to(dev, torch.float32)
                      for a in (D, Um, r, cfree))
    z_thomas, thomas_s = timed(lambda: cp.apply(*cp.factorize(Dt, Ut, ft),
                                                rt, ft))
    z_pcr, pcr_s = timed(lambda: cp.pcr_solve(Dt, Ut, rt, ft, 13))
    z_thomas, z_pcr = z_thomas.cpu().numpy(), z_pcr.cpu().numpy()
    err = float(np.max(np.abs(z_thomas - z_pcr)))
    print(f"# pcg thomas: n 2100, factorize + apply {thomas_s} s, PCR "
          f"{pcr_s} s, largest difference {err}", flush=True)
    np.testing.assert_allclose(z_pcr, z_thomas, rtol=1e-4, atol=1e-5)

    # 2. the distributed solve on the same graph: f32, f64, and the chain
    # preconditioner (schwarz=False) in f32
    packed = pack_graph(init, edges, ts._pad_pow2(n, 1), e)
    for tag, dtype, schwarz in (("f32", np.float32, True),
                                ("f64", np.float64, True),
                                ("f32 schwarz=False", np.float32, False)):
        (d_out, d_chi2), d_s = timed(lambda: distributed_lm_solve(
            mesh, *packed, cg_iters=200, dtype=dtype, schwarz=schwarz))
        cg = list(distributed_lm_solve.last_cg_iters)
        dxy, dth = parity(d_out)
        print(f"# dist solve ({tag}): CG iterations per LM step {cg} (CPU "
              f"mesh {DIST_CPU_CG.get(tag)}), chi2 {d_chi2}, largest "
              f"difference to the host solve {dxy} m {dth} rad, {d_s} s",
              flush=True)
        if not np.all(np.isfinite(d_out)):
            raise AssertionError(f"dist solve ({tag}): non-finite poses")
        if schwarz and (dxy >= 0.01 or max(cg) >= 200):
            raise AssertionError(f"dist solve ({tag}): parity {dxy} m or a "
                                 f"step at the CG cap {cg}")

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
    return by_grid


def occ_row(scan, grid):
    """The grid row of a scan's sensor."""
    return grid.world_to_grid(scan.sensor_pose[:2])[1]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2

    from slam_toolbox_tpu_torch.api import SlamSession
    from slam_toolbox_tpu_torch.core.scan import LocalizedScan
    from slam_toolbox_tpu_torch.kernels import match_cuda as mc
    from slam_toolbox_tpu_torch.kernels import rasterize as rz
    from slam_toolbox_tpu_torch.mapper import Mapper

    dev = torch.device("cuda")
    card = card_line()
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
          f"card {card}", flush=True)

    # 1. build
    build_s = mc.build_kernels(force=True)
    print(f"# build: {len(mc.KERNELS)} kernels in {build_s:.2f} s",
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
    checks, grids = {}, {}
    for tag, (matcher, base, qi) in bases.items():
        print(f"# {tag}: {len(base)} base scans, query scan {qi}",
              flush=True)
        inp = kernel_inputs(matcher, [scan_at(i) for i in base],
                            scan_at(qi), dev)
        checks[tag], grids[tag] = check_kernels(matcher, inp, tag)
        if tag == "seq":
            ceiling = measure_ceiling(
                matcher, grids[tag], inp["d"], inp["ncand"])
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

    # 4. the classic path at the bench geometry, cut to 2 laps
    run_mapping(SlamSession(cfg, laser, device=dev), data, "classic")

    # 5. no host synchronization in a drain's batch loop and its
    # speculative launches
    cfg16, laser16, data16 = bench_workload(n_laps=16)
    no_sync = check_no_sync(cfg16, laser16, data16, dev)

    # 6. the main path: the streaming pipeline on bench.py's full workload,
    # the defaults (speculation on)
    from slam_toolbox_tpu_torch.mapper import streaming as ts

    def streaming_run(tag, data_=data16, cfg_=cfg16, drain_every=256,
                      need_closure=True, **switches):
        old = {k: getattr(ts, k) for k in switches}
        for k, v in switches.items():
            setattr(ts, k, v)
        try:
            return run_mapping(
                SlamSession(cfg_, laser16, device=dev, streaming=True,
                            drain_every=drain_every),
                data_, tag, need_closure=need_closure)
        finally:
            for k, v in old.items():
                setattr(ts, k, v)

    main_run = streaming_run("streaming")
    if main_run["verifies"] < 1:
        raise AssertionError("streaming: no fused loop verify ran")
    if main_run["spec"]["spec_chain_hit"] < 1:
        raise AssertionError("streaming: no speculative near-chain row used")

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

    # 12. dist/ and the PCG tier under a world-size-1 NCCL group: the
    # solver tiers on the snake graph, the sharded chain match (K1-K3 at
    # G 561), the sharded raster of phase 10's grids
    dist_launches = dist_path(mapper, scan_at, data,
                              cfg.loop_search_maximum_distance,
                              map_launches["grids"])

    # 13. kernels line, card line, result line
    rows = []
    for name in mc.KERNELS:
        if name == "score_ceiling":
            rec, loop = ceiling, None
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
        if name in PATH_KERNELS:
            row["align_launches_by_grid"] = map_launches["align"][name]
            row["cli_launches_by_grid"] = {
                tag: counts[name]
                for tag, counts in map_launches["cli"].items()}
            row["cli"] = {}
            for G, recs in map_launches["checks"].items():
                r = recs[name]
                row["max_abs_err"] = max(row["max_abs_err"], r["err"])
                row["cli"][G] = {
                    "shape": r["shape"], "ms": r["ms"],
                    "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
                    "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                    "library_ms": r["library_ms"]}
            row["dist_launches_by_grid"] = dist_launches[name]
            row["lifelong_launches_by_grid"] = modes["lifelong"][name]
            row["loc_launches_by_grid"] = modes["loc"][name]
            row["loc_spec"] = modes["loc_spec"]
            row["main_path_spec"] = main_run["spec"]
            row["spec_off_launches"] = off_run["launches"][name]
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
                                           + map_launches["patterns"])
            if name == "smear_quantize":
                row["dense_device_ms"] = dense_ms
                row["empty_tile_rows"] = rec["empty_tile_rows"]
                row["loop"]["empty_tile_rows"] = loop["empty_tile_rows"]
            if name == "score_windows":
                row["beam_classes"] = rec["beam_classes"]
                row["loop"]["beam_classes"] = loop["beam_classes"]
                row["cases_checked"] = rec["cases_checked"] + loop[
                    "cases_checked"]
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
