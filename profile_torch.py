#!/usr/bin/env python3
"""Where the time goes on the port's two mapping paths, on one GPU.

    python3 profile_torch.py [--out profile_torch.json]

The classic path: chip_smoke.py's 2-lap bench workload (bench.py's
configuration, seed 42) through SlamSession(device="cuda"). The streaming
path (the main path): bench.py's full 16-lap workload through
SlamSession(streaming=True, drain_every=256). Each runs once plain, for
the wall time and the per-stage host timers (both plain runs come before
any tracing), and once under torch.profiler: the classic run whole, the
streaming run over a steady window of two drains (accepted scans 768 to
1280, one loop attempt). From each trace:
the device's busy time (the union of its kernels' and copies'
intervals), its idle share over the traced wall time, the device time of
every kernel by name, kernel launches and copies per scan, and the host's
waits on the device (the runtime's *Synchronize calls) per drain. Writes
the numbers as JSON to --out and prints a summary. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

WINDOW = (768, 1280)   # accepted scans of the traced streaming window
DRAIN = 256


def _device_intervals(prof):
    """(name, start_us, end_us) of every device event in the trace:
    kernels, memory copies and memsets."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out.append((e.name, e.time_range.start, e.time_range.end))
    return out


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def _union_us(intervals):
    total, cur_s, cur_e = 0.0, None, None
    for _, s, e in sorted(intervals, key=lambda t: t[1]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _sync_calls(prof) -> int:
    """Host waits on the device recorded in the trace: the CUDA runtime's
    stream, event and device synchronize calls."""
    from torch.autograd import DeviceType

    return sum(1 for e in prof.events()
               if e.device_type == DeviceType.CPU
               and "Synchronize" in e.name)


def _trace_summary(prof, wall_s: float, n_scans: int):
    ivals = _device_intervals(prof)
    busy_s = _union_us(ivals) * 1e-6
    n_copies = sum(_is_copy(name) for name, _, _ in ivals)
    by_name = {}
    for name, s, e in ivals:
        r = by_name.setdefault(name, {"count": 0, "us_total": 0.0})
        r["count"] += 1
        r["us_total"] += e - s
    top = sorted(by_name.items(), key=lambda kv: -kv[1]["us_total"])
    return {
        "traced_wall_s": wall_s, "traced_scans": n_scans,
        "device_busy_s": busy_s,
        "device_idle_share": 1.0 - busy_s / wall_s if ivals else None,
        "kernel_launches_per_scan": (len(ivals) - n_copies) / n_scans,
        "copies_per_scan": n_copies / n_scans,
        "sync_calls": _sync_calls(prof),
        "device_time_by_name": [
            {"name": k[:120], "count": v["count"],
             "us_total": v["us_total"],
             "us_mean": v["us_total"] / v["count"]}
            for k, v in top
        ],
    }


def _plain_run(sess, data):
    import numpy as np
    import torch

    from chip_smoke import run_session

    sess.stats.enabled = True
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est, _, _, lat, drains = run_session(sess, data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = len(est)
    return {
        "scans": n, "wall_s": wall, "scans_per_s": n / wall,
        "latency_ms_p50": 1e3 * float(np.percentile(lat, 50)),
        "latency_ms_p95": 1e3 * float(np.percentile(lat, 95)),
        "drain_calls": len(drains),
        "drain_ms_p50": (1e3 * float(np.percentile(drains, 50))
                         if len(drains) else None),
        "drain_ms_max": 1e3 * float(np.max(drains)) if len(drains) else None,
        "stages": {k: {"calls": sess.stats.counts[k], "ms_total": 1e3 * v}
                   for k, v in sess.stats.seconds.items()},
    }


def _print(tag, card, r):
    print(f"# {tag} ({card}): {r['scans']} scans, {r['wall_s']} s, "
          f"{r['scans_per_s']} scans/s, calls that ran no drain: p50 "
          f"{r['latency_ms_p50']} ms p95 {r['latency_ms_p95']} ms; "
          f"{r['drain_calls']} calls that ran a drain: p50 "
          f"{r['drain_ms_p50']} ms max {r['drain_ms_max']} ms")
    for k, v in sorted(r["stages"].items(),
                       key=lambda kv: -kv[1]["ms_total"]):
        print(f"# {tag} stage {k}: {v['calls']} calls, {v['ms_total']} ms")
    t = r["trace"]
    print(f"# {tag} traced: {t['traced_scans']} scans in "
          f"{t['traced_wall_s']} s, device busy {t['device_busy_s']} s, "
          f"idle share {t['device_idle_share']}, "
          f"{t['kernel_launches_per_scan']} kernel launches and "
          f"{t['copies_per_scan']} copies per scan, "
          f"{t['sync_calls']} synchronize calls")
    for d in t["device_time_by_name"][:12]:
        print(f"# {tag} device {d['count']:7d} x {d['us_mean']:9.3f} us = "
              f"{d['us_total'] / 1e3:9.3f} ms  {d['name'][:80]}")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="profile_torch.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch: no CUDA device available", file=sys.stderr)
        return 2

    from chip_smoke import bench_workload, card_line, run_session
    from slam_toolbox_tpu_torch.api import SlamSession
    from slam_toolbox_tpu_torch.kernels import match_cuda as mc

    mc.build_kernels()
    card = card_line()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    # both plain runs first, so that no timed run follows a traced one in
    # the same process (tracing can leave per-launch costs behind)
    cfg2, laser2, data2 = bench_workload(n_laps=2)
    cfg, laser, data = bench_workload(n_laps=16)
    kw = dict(device="cuda", streaming=True, drain_every=DRAIN)
    classic = _plain_run(SlamSession(cfg2, laser2, device="cuda"), data2)
    streaming = _plain_run(SlamSession(cfg, laser, **kw), data)

    # the classic path, 2 laps, traced whole
    sess = SlamSession(cfg2, laser2, device="cuda")
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_session(sess, data2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    classic["trace"] = _trace_summary(prof, wall, classic["scans"])
    classic["trace"]["sync_calls_per_scan"] = (
        classic["trace"]["sync_calls"] / classic["scans"])

    # the streaming path, 16 laps, a two-drain window traced
    prof = torch.profiler.profile(activities=acts)
    window = {}

    def on_scan(k):
        if k == WINDOW[0]:
            torch.cuda.synchronize()
            prof.start()
            window["t0"] = time.perf_counter()
        elif k == WINDOW[1]:
            torch.cuda.synchronize()
            window["wall"] = time.perf_counter() - window["t0"]
            prof.stop()

    run_session(SlamSession(cfg, laser, **kw), data, on_scan=on_scan)
    n_win = WINDOW[1] - WINDOW[0]
    streaming["trace"] = _trace_summary(prof, window["wall"], n_win)
    # less the synchronize that closes the window
    streaming["trace"]["sync_calls_per_drain"] = (
        (streaming["trace"]["sync_calls"] - 1) / (n_win // DRAIN))

    result = {"card": card, "classic": classic, "streaming": streaming}
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    _print("classic", card, classic)
    _print("streaming", card, streaming)
    return 0


if __name__ == "__main__":
    sys.exit(main())
