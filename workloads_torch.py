"""Workloads of the PyTorch port (slam_toolbox_tpu_torch) and the runs
that drive them through the port's entry points.

The builders give bench.py's workload and the configurations 2-5 of
BASELINE.md (scripts/bench_suite.py, scripts/bench_merge500k.py) in the
port's own dataclasses, from the same seeds, so each scan sequence equals
the script's bit for bit (tests/test_torch_workloads.py and
tests/test_torch_config5.py hold them to it):
  - bench_workload: bench.py make_workload's 16-lap rooms world (config 1);
  - apartment_workload: config 2, the apartment's 40 laps (5,080 raw scans);
  - warehouse_workload: config 3, the serpentine warehouse (40 laps,
    19,241 raw scans, as CONFIG3.json ran it);
  - build_prior_snapshot, loc_circuit and repeat_circuit: config 4, the
    rows warehouse's prior (100,010 nodes) and the localization circuit
    tiled with fresh odometry;
  - build_merge_snapshots and joint_graph: config 5 as
    scripts/bench_merge500k.py builds it (8 sessions of 62,500 nodes and
    their joint pose graph); band_sessions: scripts/bench_suite.py
    config5's three mapped sessions.
The runs (run_mapping, lifelong_run, localization_run) feed a session,
check what every run must show and return a record; `resources` reads
the device memory, the pack pool's growths and the program captures of a
session. chip_smoke.py, configs_torch.py, ab_main_path.py and
profile_torch.py import them. This module imports nothing of JAX and
nothing of the JAX package, and the port only inside its functions."""
from __future__ import annotations

import collections
import contextlib
import json
import os
import time

# the kernels every mapping path launches (each match: score_windows in
# its head form, then score_tail, on its raster); score_ceiling runs only
# in its own entry point, chip_smoke's roofline measurement
PATH_KERNELS = ("scatter_occupancy", "smear_quantize", "score_windows",
                "score_tail")
# the kernels only the streaming paths launch: the drain step's first and
# last (ring_points also forms every chain raster of a fused verify)
STREAM_KERNELS = ("ring_points", "stream_update")
# the streaming pipeline's speculation counters a run reports
SPEC_COUNTS = ("spec_pairs", "spec_chain_hit", "spec_chain_miss",
               "spec_dispatch_abort", "spec_loop_dispatched", "spec_loop_hit",
               "spec_loop_partial", "spec_loop_miss")
# config 3's steady-state trigger as CONFIG3.json's bounded variants ran
# it (SLAM_SS_MIN=20 there); LifelongConfig's default 0 is the reference's
# decay alone, which does not plateau (0.78 nodes/scan in that record)
SS_MIN = 20
# config 3's laps: CONFIG3.json's 19,241 raw scans are 40 laps
# (bench_suite.py config3 --laps 40; its --full is 20 laps, 9,601 scans)
WAREHOUSE_LAPS = 40
# config 2's laps (bench_suite.py config2 --full) and config 4's prior
APARTMENT_LAPS = 40
PRIOR_NODES = 100010
# config 4's circuit: 4 rows out and back; tiled with fresh odometry to
# at least CONFIG4.json's 6,568 localized scans
LOOP_ROWS = 4
LOCALIZED_SCANS = 6568


# bench.py's lap of the rooms world; config 2's lap closes it
# (scripts/bench_suite.py:206-209)
LAP = [
    (-6.0, -3.5), (1.5, -3.5), (5.5, -3.5), (5.5, 0.5), (5.5, 3.5),
    (1.0, 3.5), (-3.0, 3.5), (-6.0, 3.0), (-6.5, -1.0),
]
APARTMENT_LAP = LAP + [LAP[0]]


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def keep_freed_memory() -> bool:
    """Keep the host memory the process frees for its next allocations
    (glibc's mallopt: no trim of the heap's top, no mmap below 32 MB),
    where the C library is glibc; returns whether it applied. The
    simulator's ray casts allocate and free about 6 MB of NumPy
    temporaries a scan; returned to the kernel and faulted back in each
    time, they made a process's first prior build several times slower
    than its later ones on the sandboxed H100 host of PERF.md."""
    import ctypes

    try:
        libc = ctypes.CDLL("libc.so.6")
    except OSError:
        return False
    m_trim_threshold, m_mmap_threshold = -1, -3
    return bool(libc.mallopt(m_trim_threshold, 1 << 30)
                and libc.mallopt(m_mmap_threshold, 32 << 20))


def sync(dev) -> None:
    """Wait for the card where `dev` is one (a CPU run has nothing to
    wait for)."""
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


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


def apartment_workload(laps: int = APARTMENT_LAPS,
                       beam_deg: float = 1.0 / 3):
    """Config 2 (scripts/bench_suite.py cmd_config2): the apartment
    (SegmentWorld.rooms(16.0, 10.0)) driven `laps` times around its closed
    lap, bench_suite's laser and configuration (_laser, _cfg), the
    simulator's seed 7 and odometry noise (0.015, 0.006)."""
    import numpy as np

    from slam_toolbox_tpu_torch.io.dataset import LidarSimulator, SegmentWorld

    laser = suite_laser(beam_deg)
    sim = LidarSimulator(SegmentWorld.rooms(16.0, 10.0), laser,
                         range_noise=0.01, odom_noise=(0.015, 0.006),
                         seed=7)
    data = sim.simulate(np.array(APARTMENT_LAP * laps), step=0.3)
    return suite_cfg(), laser, data


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


def run_mapping(sess, data, tag: str, need_closure: bool = True,
                ate_bar: bool = True):
    """One session's mapping run: launch counts from 0, the scans, the
    flush, the counts read. Prints rate, latency, ATE, closures, launches,
    the speculation's counts and per-stage host times; returns a record.
    The ATE must be below half of odometry's (where `ate_bar`). On a card
    every path kernel must have launched, and on a streaming session the
    step's ring_points and stream_update too (the CPU runs the plain
    versions, uncounted)."""
    import numpy as np

    from slam_toolbox_tpu_torch.io.dataset import ate_rmse
    from slam_toolbox_tpu_torch.kernels import match_cuda as mc

    sess.stats.enabled = True
    closures = []
    sess.mapper.listeners.append(closures.append)
    sync(sess.device)
    mc.reset_launch_counts()
    t0 = time.perf_counter()
    est, gt, odo, lat, drains = run_session(sess, data)
    sync(sess.device)
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
    if ate_bar and not ate < 0.5 * ate_odom:
        raise AssertionError(f"{tag}: ATE {ate} not below half of {ate_odom}")
    if need_closure and not closures:
        raise AssertionError(f"{tag}: no loop closure fired")
    path = PATH_KERNELS + (STREAM_KERNELS if sess.streaming else ())
    missing = [k for k in path if launches[k] == 0]
    if missing and sess.device.type == "cuda":
        raise AssertionError(f"{tag}: kernels never launched: {missing}")
    return dict(launches=launches, by_grid=by_grid, verifies=verifies,
                ate=ate, scans=len(est), wall=wall, rate=len(est) / wall,
                traj=traj, closures=len(closures), spec=spec, sess=sess)


def launches_by_grid():
    """The path kernels' launch counts since the last reset, by grid side
    (the side of the raster each launch served): {kernel: {G: n}}."""
    from slam_toolbox_tpu_torch.kernels import match_cuda as mc

    out = {name: {} for name in PATH_KERNELS + STREAM_KERNELS}
    for (name, G), n in sorted(mc.GRID_LAUNCHES.items()):
        if name in out:
            out[name][str(G)] = n
    return out



def grid_check(checked):
    """A run's check_grids: fails a run whose kernels launched at a grid
    side outside `checked` (the sides at which chip_smoke held K1-K3 to
    their plain versions)."""
    def check_grids(tag, by_grid):
        seen = {int(G) for k in PATH_KERNELS + STREAM_KERNELS
                for G in by_grid[k]}
        if not seen <= set(checked):
            raise AssertionError(
                f"{tag}: kernels ran at grids {seen - set(checked)} that no "
                f"phase held to their plain versions")
    return check_grids


def graph_pool_bytes():
    """Device memory in the segments of CUDA graphs' private pools (the
    caching allocator's snapshot), or None where the snapshot does not
    name a segment's pool."""
    import torch

    segs = torch.cuda.memory_snapshot()
    if any("segment_pool_id" not in seg for seg in segs):
        return None
    return sum(seg["total_size"] for seg in segs
               if tuple(seg["segment_pool_id"]) != (0, 0))


def grid_summary(grid) -> dict:
    """An occupancy grid's shape and its free, occupied and unknown
    cells."""
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


@contextlib.contextmanager
def occupancy_route(native: bool):
    """Send every render inside the block through one route: the native
    host Bresenham (native=True) or trace_beams (native=False: a CUDA
    session's own choice, on the CPU its plain version)."""
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


def warehouse_workload(laps: int = WAREHOUSE_LAPS,
                       beam_deg: float = 1.0 / 3):
    """Config 3's scans (scripts/bench_suite.py cmd_config3): the
    warehouse's serpentine `laps` times, bench_suite's laser, the
    simulator's seed 11 and odometry noise (0.012, 0.005). Returns
    (laser, data)."""
    import numpy as np

    from slam_toolbox_tpu_torch.io.dataset import LidarSimulator

    laser = suite_laser(beam_deg)
    world, aisles, length, pitch = warehouse()
    sim = LidarSimulator(world, laser, range_noise=0.01,
                         odom_noise=(0.012, 0.005), seed=11)
    return laser, sim.simulate(
        np.concatenate([serpentine(aisles, length, pitch)] * laps), step=0.3)


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


def lifelong_cfg(marginalize: bool, **kw):
    """bench_suite's config-3 settings: chains of at least 5 scans (the
    decay shortens the surviving runs of ids), the removed nodes'
    constraints marginalized onto their neighbours or deleted
    (SLAM_MARGINALIZE=1 there)."""
    return suite_cfg(**{**dict(loop_match_minimum_chain_size=5,
                               marginalize_on_removal=marginalize), **kw})


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


PRIOR_STEP, PRIOR_WIDTH = 0.3, 62.0
PRIOR_PER_ROW = int(60.0 / PRIOR_STEP)   # 200 nodes a row


def prior_pose(row: int, k: int):
    """The true pose of node k of the prior's row `row`: serpentine rows
    2 m apart, east on even rows and west on odd ones."""
    import numpy as np

    x = (1.0 + k * PRIOR_STEP if row % 2 == 0
         else 1.0 + (PRIOR_PER_ROW - 1 - k) * PRIOR_STEP)
    return np.array([x, row * 2.0, 0.0 if row % 2 == 0 else np.pi])


def prior_row_ranges(job):
    """The ranges of one prior row's first n nodes, (segments of the row's
    world, laser, row, n): the row's own simulator (seed 100 + row)
    raycasting at each pose against the segments within its reach, which
    hit what the whole world would. A task of build_prior_snapshot's
    threads (rows are independent; the casts' NumPy releases the
    interpreter lock)."""
    from slam_toolbox_tpu_torch.io.dataset import LidarSimulator, SegmentWorld

    segments, laser, row, n = job
    row_world = SegmentWorld(segments)
    sim = LidarSimulator(row_world, laser, range_noise=0.01, seed=100 + row)
    reach = laser.max_range + 0.5
    out = []
    for k in range(n):
        gt = prior_pose(row, k)
        sim.world = window(row_world, gt[:2], gt[:2], reach)
        out.append(sim.scan_at(gt))
    return out


def build_prior_snapshot(path, n_nodes, laser, seed=7, dev="cpu"):
    """bench_suite.build_prior_snapshot: a config-4-scale prior written
    directly (simulated scans at serpentine poses over rows_world, an
    odometry chain plus a cross-row edge every 8th node, corrected poses
    with residual noise), saved with the port's save_snapshot. Each row's
    ranges come from prior_row_ranges, in as many threads as the process
    may use cores (the same ranges for any count: each row has its own
    simulator). Returns (world, build s, save s)."""
    import concurrent.futures

    import numpy as np

    from slam_toolbox_tpu_torch.core.params import MapperConfig
    from slam_toolbox_tpu_torch.core.scan import LocalizedScan
    from slam_toolbox_tpu_torch.mapper import Mapper

    per_row = PRIOR_PER_ROW
    n_rows = (n_nodes + per_row - 1) // per_row + 1
    world = rows_world(n_rows, PRIOR_WIDTH)
    rng = np.random.default_rng(seed)
    reach = laser.max_range + 0.5
    t0 = time.perf_counter()
    jobs = [(window(world, (0.0, row * 2.0), (PRIOR_WIDTH, row * 2.0),
                    reach).segments, laser, row,
             min(per_row, n_nodes - row * per_row))
            for row in range((n_nodes + per_row - 1) // per_row)]
    pool = concurrent.futures.ThreadPoolExecutor(
        min(len(os.sched_getaffinity(0)), len(jobs)))
    rows = pool.map(prior_row_ranges, jobs)
    try:
        m = Mapper(MapperConfig(use_scan_matching=False), device=dev)
        m.initialize(laser.range_threshold)
        sm = m.sensor_manager
        cov_odom = np.diag([1e-3, 1e-3, 1e-4])
        cov_loop = np.diag([4e-3, 4e-3, 4e-4])
        prev, scans = None, []
        for row, ranges in enumerate(rows):
            for k, r in enumerate(ranges):
                i = row * per_row + k
                gt = prior_pose(row, k)
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
                        m.graph.link_scans(scans[j], s, s.sensor_pose,
                                           cov_loop)
                scans.append(s)
                sm.set_last_scan(s)
                prev = s
    finally:
        pool.shutdown(cancel_futures=True)
    for s in scans[-8:]:
        sm.add_running_scan(s)
    t1 = time.perf_counter()
    save_atomic(m, path)
    return world, t1 - t0, time.perf_counter() - t1


def loc_circuit(world, laser, lap_rows: int = LOOP_ROWS, seed=29):
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


def prior_world(n_nodes: int):
    """The rows world a prior of n_nodes lies in (build_prior_snapshot's,
    for a prior loaded from a cache)."""
    return rows_world((n_nodes + PRIOR_PER_ROW - 1) // PRIOR_PER_ROW + 1,
                      PRIOR_WIDTH)


def repeat_circuit(data, repeats: int):
    """bench_suite._repeat_circuit: a closed circuit tiled `repeats` times,
    the ranges and ground truth repeated and the odometry drawn afresh
    (continuous, from its own seed 31, with the circuit's odometry noise
    (0.012, 0.005))."""
    import types

    import numpy as np

    from slam_toolbox_tpu_torch.io.dataset import _compose_np, _relative_np

    if repeats <= 1:
        return data
    rng = np.random.default_rng(31)
    trans, rot = 0.012, 0.005
    gts = [np.asarray(tp) for _, tp in data] * repeats
    ranges = [r.ranges for r, _ in data] * repeats
    out = []
    odom = np.array(gts[0])
    prev = gts[0]
    for i, (tp, rr) in enumerate(zip(gts, ranges)):
        if i > 0:
            rel = _relative_np(prev, tp)
            rel[0] += rng.normal(0, trans)
            rel[1] += rng.normal(0, trans * 0.3)
            rel[2] += rng.normal(0, rot)
            odom = _compose_np(odom, rel)
            prev = tp
        out.append((types.SimpleNamespace(ranges=rr, odom_pose=odom.copy()),
                    np.array(tp)))
    return out


# config 5 (scripts/bench_merge500k.py; MERGE500K.json ran 8 sessions of
# 62,500 nodes at 61 beams): serpentine sessions over shelving rows, one
# aisle of 200 nodes 0.3 m apart per row, each session started on the
# previous one's last aisle
MERGE_SESSIONS = 8
MERGE_NODES_PER = 62500
MERGE_BEAMS = 61
MERGE_STEP = 0.3
MERGE_PER_AISLE = int(60.0 / MERGE_STEP)   # 200 nodes an aisle
MERGE_WIDTH = 62.0
# a node's noise from the one generator (seed 7): its corrected pose's
# (x, y, heading), then its odometry's; after every session's nodes, each
# chain edge's relative pose, then each cross-session edge's
MERGE_NODE_NOISE = (0.02, 0.02, 0.005, 0.05, 0.05, 0.01)
MERGE_CHAIN_NOISE = (0.002, 0.002, 0.0005)
MERGE_CROSS_NOISE = 0.004
# every 64th node of a session is tried against the nearest node of the
# session before it, and linked when that node is closer than 1 m
MERGE_CROSS_EVERY = 64
MERGE_COV_ODOM = (1e-3, 1e-3, 1e-4)
MERGE_COV_CROSS = (4e-3, 4e-3, 4e-4)


def merge_laser(beams: int = MERGE_BEAMS):
    """bench_merge500k's laser: `beams` beams from -90 degrees, range
    threshold 10 m, max range 12 m, not a 360-degree laser."""
    import numpy as np

    from slam_toolbox_tpu_torch.core.scan import LaserConfig

    return LaserConfig(
        beam_count=beams, min_angle=-np.pi / 2, max_angle=np.pi / 2,
        min_range=0.05, max_range=12.0, range_threshold=10.0, is_360=False)


def merge_world(sessions: int, nodes_per: int):
    """bench_merge500k's warehouse: rows every 2 m of broken 5.5 m
    shelving walls spanning every session, walls at both x ends."""
    import numpy as np

    from slam_toolbox_tpu_torch.io.dataset import SegmentWorld

    n_rows = sessions * (nodes_per // MERGE_PER_AISLE + 2) + 4
    segs = []
    for row in range(n_rows):
        y = row * 2.0 - 1.0
        for x0 in np.arange(-1.0, MERGE_WIDTH, 7.0):
            segs.append((x0, y, min(x0 + 5.5, MERGE_WIDTH), y))
    segs.append((-1.0, -1.0, -1.0, n_rows * 2.0))
    segs.append((MERGE_WIDTH, -1.0, MERGE_WIDTH, n_rows * 2.0))
    return SegmentWorld(np.array(segs, dtype=np.float64))


def merge_origins(sessions: int, nodes_per: int):
    """Each session's first aisle's y: sessions overlap by an even number
    of aisles (the serpentine alternates its direction an aisle, and
    FindValidPoints culls opposing scans, so the shared aisle is driven
    the same way in both sessions)."""
    n_aisles = (nodes_per + MERGE_PER_AISLE - 1) // MERGE_PER_AISLE
    off_aisles = n_aisles - 1
    if off_aisles % 2:
        off_aisles -= 1
    return [s * off_aisles * 2.0 for s in range(sessions)]


def merge_pose(i: int, y0: float):
    """The true pose of a session's node i: east on even aisles, west on
    odd ones, 2 m apart from y0."""
    import numpy as np

    aisle, k = divmod(i, MERGE_PER_AISLE)
    y = y0 + aisle * 2.0
    x = (k * MERGE_STEP if aisle % 2 == 0
         else (MERGE_PER_AISLE - 1 - k) * MERGE_STEP)
    return np.array([x, y, 0.0 if aisle % 2 == 0 else np.pi])


CAST_BLOCK = 32


def cast_poses(world, laser, poses, rng):
    """LidarSimulator.scan_at (range noise 0.01) at each of `poses` in
    turn: SegmentWorld.cast for CAST_BLOCK poses at a time, against the
    segments within the block's reach (a ray hits nothing else within
    max_range), and the range noise drawn from `rng` scan by scan, so the
    ranges equal the simulator's bit for bit. Returns (n, beams)."""
    import numpy as np

    from slam_toolbox_tpu_torch.core import geometry

    offset = np.array(laser.offset_pose)
    sensor = np.stack([np.asarray(geometry.sensor_at(p, offset))
                       for p in poses])
    r = np.empty((len(poses), laser.n_beams))
    for b0 in range(0, len(poses), CAST_BLOCK):
        sb = sensor[b0:b0 + CAST_BLOCK]
        near = window(world, sb[:, :2].min(axis=0), sb[:, :2].max(axis=0),
                      laser.max_range + 0.5)
        r[b0:b0 + CAST_BLOCK] = near.cast(
            sb[:, :2], laser.beam_angles[None, :] + sb[:, 2:3],
            laser.max_range)
    return r + rng.normal(0, 0.01, r.shape)


def merge_aisle_ranges(job):
    """The ranges of one aisle of a session, (world, laser, session, y0,
    aisle, first node, nodes): cast_poses at the aisle's poses with a
    generator of the session's seed (100 + session) against the segments
    within 13 m of the aisle's row, as bench_merge500k's sim_for makes a
    simulator for each aisle. A task of build_merge_snapshots' threads
    (aisles are independent, and the casts' NumPy releases the
    interpreter lock)."""
    import numpy as np

    from slam_toolbox_tpu_torch.io.dataset import SegmentWorld

    world, laser, sess_idx, y0, aisle, i0, n = job
    segs = world.segments
    y = y0 + aisle * 2.0
    keep = ((np.maximum(segs[:, 1], segs[:, 3]) >= y - 13.0)
            & (np.minimum(segs[:, 1], segs[:, 3]) <= y + 13.0))
    return cast_poses(SegmentWorld(segs[keep]), laser,
                      [merge_pose(i, y0) for i in range(i0, i0 + n)],
                      np.random.default_rng(100 + sess_idx))


def merge_aisle_jobs(world, laser, sess_idx: int, nodes: int, y0: float):
    """One session's merge_aisle_ranges tasks, aisle by aisle."""
    return [(world, laser, sess_idx, y0, a, i0,
             min(MERGE_PER_AISLE, nodes - i0))
            for a, i0 in enumerate(range(0, nodes, MERGE_PER_AISLE))]


def build_merge_session(sess_idx: int, nodes: int, laser, y0: float, rng,
                        aisles):
    """bench_merge500k.build_session: one serpentine session as a skeleton
    Mapper (use_scan_matching off): each node's scan, its corrected pose
    (the true pose with residual noise) and odometry, linked along the
    chain with covariance diag(1e-3, 1e-3, 1e-4). The session's node noise
    is drawn from `rng` first, in the script's order; `aisles` yields
    each aisle's ranges (merge_aisle_ranges of merge_aisle_jobs)."""
    import numpy as np

    from slam_toolbox_tpu_torch.core.params import MapperConfig
    from slam_toolbox_tpu_torch.core.scan import LocalizedScan
    from slam_toolbox_tpu_torch.mapper import Mapper

    noise = rng.normal(0.0, MERGE_NODE_NOISE, size=(nodes, 6))
    m = Mapper(MapperConfig(use_scan_matching=False), device="cpu")
    m.initialize(laser.range_threshold)
    sm = m.sensor_manager
    cov = np.diag(MERGE_COV_ODOM)
    prev, i = None, 0
    for ranges in aisles:
        for r in ranges:
            gt = merge_pose(i, y0)
            s = LocalizedScan(laser, r, gt + noise[i, 3:], time=float(i))
            s.set_corrected_pose(gt + noise[i, :3])
            sm.add_scan(s)
            m.graph.add_vertex(s)
            if prev is not None:
                m.graph.link_scans(prev, s, s.sensor_pose, cov)
            prev = s
            i += 1
    if i != nodes:
        raise AssertionError(f"session {sess_idx}: {i} of {nodes} nodes")
    return m


def skip_merge_noise(rng, sessions: int, nodes_per: int) -> None:
    """Advance `rng` past the sessions' node noise, as a build would (for
    snapshots found in a cache)."""
    for _ in range(sessions):
        rng.normal(0.0, MERGE_NODE_NOISE, size=(nodes_per, 6))


def build_merge_snapshots(paths, nodes_per: int, laser, rng):
    """bench_merge500k's sessions, one a path: each built
    (build_merge_session), saved with the port's save_snapshot and freed
    before the next. Every session's aisles are raycast in as many
    threads as the process may use cores, ahead of the session being
    built (the same ranges for any count: each aisle has its own
    simulator). Returns (world, build s, save s)."""
    import concurrent.futures

    sessions = len(paths)
    world = merge_world(sessions, nodes_per)
    origins = merge_origins(sessions, nodes_per)
    build_s = save_s = 0.0
    jobs = [merge_aisle_jobs(world, laser, s, nodes_per, origins[s])
            for s in range(sessions)]
    pool = concurrent.futures.ThreadPoolExecutor(
        min(len(os.sched_getaffinity(0)), sum(map(len, jobs))))
    futures = [[pool.submit(merge_aisle_ranges, j) for j in js]
               for js in jobs]
    try:
        for s, path in enumerate(paths):
            t0 = time.perf_counter()
            m = build_merge_session(
                s, nodes_per, laser, origins[s], rng,
                (f.result() for f in futures[s]))
            futures[s] = None
            t1 = time.perf_counter()
            save_atomic(m, path)
            build_s += t1 - t0
            save_s += time.perf_counter() - t1
            print(f"# config5 session {s}: {m.solver.n_nodes} nodes built in "
                  f"{t1 - t0} s, saved in {time.perf_counter() - t1} s",
                  flush=True)
            del m
    finally:
        pool.shutdown(cancel_futures=True)
    return world, build_s, save_s


def save_atomic(mapper, path) -> None:
    """save_snapshot written beside `path` and renamed onto it, so a
    killed build leaves no half-written snapshot under its name (np.savez
    keeps a .npz name)."""
    from slam_toolbox_tpu_torch.io.serialization import save_snapshot

    part = f"{path}.{os.getpid()}.part.npz"
    try:
        save_snapshot(mapper, part)
        os.replace(part, path)
    finally:
        if os.path.exists(part):
            os.remove(part)


def joint_graph(merger, rng) -> dict:
    """bench_merge500k's joint pose graph of the merger's sessions, on
    their own corrected poses (the alignment's corrections are the
    merge's, not the graph's): every session's chain with relative-pose
    noise N(0, MERGE_CHAIN_NOISE) and covariance MERGE_COV_ODOM, then
    every 64th node of session s linked to its nearest node of session
    s - 1 where that one is closer than 1 m, with noise N(0, 0.004) and
    covariance MERGE_COV_CROSS; the noise drawn from `rng` in the
    script's order. Nodes are padded to the next power of two; node 0 and
    the padding are fixed. Returns the solve's arrays (poses f32 (n_pad,
    3), src, dst, rel, sqrt_info, emask, free) and the counts."""
    import numpy as np

    from slam_toolbox_tpu_torch.core import geometry

    n = sum(len(s) for s in merger.submaps)
    n_pad = 1
    while n_pad < n:
        n_pad <<= 1
    poses = np.zeros((n_pad, 3), np.float32)
    bases, srcs, dsts, rels = [], [], [], []
    base = 0
    for scans in merger.submaps:
        bases.append(base)
        c = np.stack([s.corrected_pose for s in scans])
        poses[base:base + len(scans)] = c
        srcs.append(np.arange(base, base + len(scans) - 1))
        rels += [geometry.relative_pose(c[i], c[i + 1])
                 for i in range(len(scans) - 1)]
        base += len(scans)
    n_chain = len(rels)
    rel = (np.array(rels).reshape(n_chain, 3)
           + rng.normal(0.0, MERGE_CHAIN_NOISE, size=(n_chain, 3)))
    src = np.concatenate(srcs) if srcs else np.zeros(0, np.int64)
    dst = src + 1
    cross = []
    for s in range(1, len(merger.submaps)):
        a, b = merger.submaps[s - 1], merger.submaps[s]
        axy = np.stack([sc.corrected_pose[:2] for sc in a])
        for i in range(0, len(b), MERGE_CROSS_EVERY):
            bxy = b[i].corrected_pose[:2]
            j = int(np.argmin(np.sum((axy - bxy) ** 2, axis=1)))
            if np.hypot(*(axy[j] - bxy)) < 1.0:
                cross.append((bases[s - 1] + j, bases[s] + i, geometry.
                              relative_pose(a[j].corrected_pose,
                                            b[i].corrected_pose)))
    n_cross = len(cross)
    if n_cross:
        x_rel = (np.array([c[2] for c in cross])
                 + rng.normal(0.0, MERGE_CROSS_NOISE, size=(n_cross, 3)))
        src = np.concatenate([src, [c[0] for c in cross]])
        dst = np.concatenate([dst, [c[1] for c in cross]])
        rel = np.concatenate([rel, x_rel])

    def sqrt_info(cov):
        return np.linalg.cholesky(np.linalg.inv(np.diag(cov))).T

    si = np.concatenate([
        np.broadcast_to(sqrt_info(MERGE_COV_ODOM), (n_chain, 3, 3)),
        np.broadcast_to(sqrt_info(MERGE_COV_CROSS), (n_cross, 3, 3))])
    free = np.ones(n_pad, np.float32)
    free[n:] = 0
    free[0] = 0
    e = n_chain + n_cross
    return dict(poses=poses, src=src.astype(np.int64),
                dst=dst.astype(np.int64), rel=rel, sqrt_info=si,
                emask=np.ones(e, bool), free=free, n=n, n_pad=n_pad,
                n_chain=n_chain, n_cross=n_cross)


def band_sessions(sessions: int = 3, beam_deg: float = 1.0 / 3):
    """scripts/bench_suite.py cmd_config5's sessions: session s drives the
    serpentine over a band of `per` aisles of the warehouse from aisle a0
    (the bands overlap by one aisle), its simulator seeded 31 + s with
    odometry noise (0.012, 0.005). Returns (laser, [(a0, per, simulator,
    waypoints)]); each session's scans are simulator.simulate(waypoints,
    step=0.3)."""
    import numpy as np

    from slam_toolbox_tpu_torch.io.dataset import LidarSimulator

    laser = suite_laser(beam_deg)
    world, aisles, length, pitch = warehouse()
    per = max(2, aisles // sessions + 1)
    out = []
    for s in range(sessions):
        a0 = min(s * (per - 1), aisles - per)
        wps = serpentine(per, length, pitch) + np.array([a0 * pitch, 0.0])
        out.append((a0, per, LidarSimulator(
            world, laser, range_noise=0.01, odom_noise=(0.012, 0.005),
            seed=31 + s), wps))
    return laser, out


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

# the decay's spans (mapper/lifelong.py): the whole evaluation and its
# parts; decay_remove nests under decay_score and decay_topup
DECAY_SPANS = ("decay", "decay_query", "decay_filter", "decay_score",
               "decay_topup", "decay_remove")


def time_decay(stats) -> dict:
    """The decay's host ms by span (inclusive) from a session's Stats,
    with the evaluations, removals and top-up removals counted."""
    ms = {k: 1e3 * stats.seconds.get(k, 0.0) for k in DECAY_SPANS}
    for k in ("decay_evals", "decay_removed", "decay_forced",
              "decay_resync"):
        ms[k] = stats.counts.get(k, 0)
    return ms


def lifelong_run(dev, data, cfg, laser, n_scans=None, ss_min=SS_MIN,
                 check_grids=None, tag="lifelong"):
    """Config 3: the first n_scans (all by default) of the lapped
    warehouse through SlamSession(streaming=True, drain_every=96,
    lifelong=LifelongConfig(steady_state_min_candidates=ss_min)) (the
    removals marginalized where cfg says so). Prints the node curve
    (every 800 raw scans, as CONFIG3.json records it), the bars' numbers,
    the host stages and the decay's spans (time_decay); returns a record
    (lifelong_bars checks the bounded variants' bars). Every pose must be
    finite, and on a card every path kernel must have launched, at grids
    `check_grids(tag, by_grid)` accepts."""
    import numpy as np

    from slam_toolbox_tpu_torch.api import SlamSession
    from slam_toolbox_tpu_torch.kernels import match_cuda as mc
    from slam_toolbox_tpu_torch.mapper.lifelong import LifelongConfig

    n_scans = len(data) if n_scans is None else n_scans
    sess = SlamSession(
        cfg, laser, streaming=True, drain_every=96, device=dev,
        lifelong=LifelongConfig(steady_state_min_candidates=ss_min))
    sess.stats.enabled = True
    closures = []
    sess.mapper.listeners.append(closures.append)
    curve, gts, odos, errs = [], [], [], []
    half_nodes = None
    sync(dev)
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
    sync(dev)
    wall = time.perf_counter() - t0
    by_grid = launches_by_grid()
    if check_grids is not None:
        check_grids(tag, by_grid)
    nodes = sess.mapper.solver.n_nodes
    curve.append((n_scans, nodes))
    growth = (nodes - half_nodes) / (n_scans - n_scans // 2)
    ate, ate_odo, n_surv = survivors_ate(sess, gts, odos)
    e = np.asarray(errs)
    counts = sess.stats.counts
    marg = {k: counts[k] for k in ("marginal_factor_added",
                                   "marginal_factor_dup_skipped")}
    stages = stage_times(sess)
    decay_ms = time_decay(sess.stats)
    print(f"# {tag}: {n_scans} of the warehouse's {len(data)} raw scans, "
          f"{len(gts)} accepted, {wall} s, {len(gts) / wall} scans/s; nodes "
          f"every 800 scans {json.dumps(curve)}, final {nodes}, "
          f"second-half growth {growth} nodes/scan", flush=True)
    print(f"# {tag}: survivors-ATE {ate} m over {n_surv} survivors vs "
          f"their odometry's {ate_odo} m, online error p50 "
          f"{np.percentile(e, 50)} m p95 {np.percentile(e, 95)} m max "
          f"{e.max()} m, {len(closures)} loop closures, {json.dumps(marg)}, "
          f"launches by grid {by_grid}", flush=True)
    print(f"# {tag} stages (calls, host ms): {json.dumps(stages)}; the "
          f"decay {decay_ms['decay']} ms, its spans (ms) and counts "
          f"{json.dumps(decay_ms)}", flush=True)
    poses = np.stack([s.corrected_pose
                      for s in sess.mapper.all_processed_scans()])
    if not (np.all(np.isfinite(poses)) and np.all(np.isfinite(e))):
        raise AssertionError(f"{tag}: a pose is not finite")
    missing = [k for k in PATH_KERNELS if not by_grid[k]]
    if missing and sess.device.type == "cuda":
        raise AssertionError(f"{tag}: kernels never launched: {missing}")
    return dict(sess=sess, gts=gts, odos=odos, by_grid=by_grid,
                raw_scans=n_scans, accepted=len(gts), wall=wall,
                rate=len(gts) / wall, curve=curve, nodes=nodes,
                growth=growth, ate=ate, ate_odo=ate_odo, survivors=n_surv,
                err=dict(p50=float(np.percentile(e, 50)),
                         p95=float(np.percentile(e, 95)),
                         max=float(e.max())),
                closures=len(closures), marg=marg, stages=stages,
                decay_ms=decay_ms)


def lifelong_bars(tag, r) -> None:
    """The marginalized variant's bars (chip_smoke's phase 11):
    survivors-ATE below half of their odometry's, a closure, second-half
    growth below 0.02 nodes/scan, and a marginalized removal."""
    if not r["ate"] < 0.5 * r["ate_odo"]:
        raise AssertionError(f"{tag}: survivors-ATE {r['ate']} not below "
                             f"half of {r['ate_odo']}")
    if not r["closures"]:
        raise AssertionError(f"{tag}: no loop closure fired")
    if not r["growth"] < 0.02:
        raise AssertionError(f"{tag}: growth {r['growth']} nodes/scan")
    if r["marg"]["marginal_factor_added"] < 1:
        raise AssertionError(f"{tag}: no marginalized removal")


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
                     check_grids=None, bars=True, **switches):
    """Config 4: SlamSession(mode="localization", streaming=True,
    drain_every=16) loads the prior with LOCALIZE_AT_POSE at the circuit's
    first true pose, primes on its first scan and runs the rest, with the
    streaming module's `switches` set. Prints the numbers; returns the
    online poses, the trajectory, the counts and the figures. Bars:
    rmse below 0.35 m, the graph bounded by prior + buffer, an accepted
    closure, a windowed solve (where `bars`), and on a card every path
    kernel launched, at grids `check_grids(tag, by_grid)` accepts."""
    import numpy as np

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
        sync(dev)
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
        sync(dev)
        wall = time.perf_counter() - t0
        by_grid = launches_by_grid()
        if check_grids is not None:
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
    stages = stage_times(sess)
    print(f"# {tag} stages (calls, host ms): {json.dumps(stages)}",
          flush=True)
    if not np.all(np.isfinite(e)):
        raise AssertionError(f"{tag}: a pose is not finite")
    if bars and not rmse < 0.35:
        raise AssertionError(f"{tag}: rmse {rmse} m")
    if bars and nodes > n_prior + cfg.scan_buffer_size + 1:
        raise AssertionError(f"{tag}: {nodes} nodes, prior {n_prior}")
    if bars and gates.counts["closed"] < 1:
        raise AssertionError(f"{tag}: no localization closure accepted")
    if bars and solves.get("windowed", 0) < 1:
        raise AssertionError(f"{tag}: no windowed solve")
    missing = [k for k in PATH_KERNELS if not by_grid[k]]
    if missing and sess.device.type == "cuda":
        raise AssertionError(f"{tag}: kernels never launched: {missing}")
    return dict(poses=np.stack(poses), traj=sess.trajectory, spec=spec,
                by_grid=by_grid, rate=len(poses) / wall, rmse=rmse,
                sess=sess, load_s=load_s, prime_s=prime_s, wall=wall,
                localized=len(poses), nodes=nodes, solves=solves,
                gates=dict(gates.counts), stages=stages,
                err=dict(p50=float(np.percentile(e, 50)),
                         p95=float(np.percentile(e, 95)),
                         max=float(e.max())))


def resources(sess, base: int = 0) -> dict:
    """What a session's run held: the pack pool's rows, used rows,
    growths and compactions; the program captures by kind (the matchers'
    programs: match, verify, chain, raster, pass; `step` the drain's step
    graph); on a card the peak of allocated device memory since the last
    reset of the peak, that peak less `base` (what was allocated when
    the run started) and the graphs' private pools, which are the
    process's: every live session's and the solver's loop programs."""
    import torch

    pipe = sess._pipe
    pool = pipe.pack_pool if pipe is not None else None
    caps = collections.Counter()
    for m in (sess.mapper.sequential_matcher, sess.mapper.loop_matcher):
        if m is not None:
            caps.update(m.captures)
    caps["step"] = sess.stats.counts.get("graph_capture", 0)
    out = dict(pool=None if pool is None else dict(
        rows=pool.cap, used=pool.n, growths=pool.growths,
        compactions=pool.compactions), captures=dict(sorted(caps.items())))
    if sess.device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(sess.device)
        out.update(peak_allocated_bytes=peak, allocated_at_start_bytes=base,
                   peak_over_start_bytes=peak - base,
                   process_graph_pool_bytes=graph_pool_bytes())
    return out
