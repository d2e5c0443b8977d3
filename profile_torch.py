#!/usr/bin/env python3
"""Where the time goes on the port's two mapping paths, on one GPU.

    python3 profile_torch.py [--out profile_torch.json]

The classic path: chip_smoke.py's 2-lap bench workload (bench.py's
configuration, seed 42) through SlamSession(device="cuda"). The streaming
path (the main path): bench.py's full 16-lap workload through
SlamSession(streaming=True, drain_every=256), whose drains replay the
step graph of mapper/streaming.py. Each runs once plain, for the wall
time and the per-stage host timers (both plain runs come before any
tracing), and once under torch.profiler: the classic run whole, the
streaming run over a steady window of two drains (accepted scans 768 to
1280, one loop attempt). From each trace:
the device's busy time (the union of its kernels' and copies'
intervals), its idle share over the traced wall time, the device time of
every kernel by name, kernel launches and copies per scan, the host's
launch calls (cudaLaunchKernel and cudaGraphLaunch apart) and, per
scan on the classic path, where every match is a program replay, both
and the sequential match's host ms of the plain run; on the
streaming path both and the device's kernels per batch step, and the
host's waits on the device (the runtime's *Synchronize calls) per drain.
Then a third streaming run under cProfile over one steady drain
(accepted scans 1025 to 1280): where the host time that is left goes.
Writes the numbers as JSON to --out and prints a summary. Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import sys
import time

from slam_toolbox_tpu_torch.utils.metrics import GRAPH_CALLS, LAUNCH_CALLS

WINDOW = (768, 1280)   # accepted scans of the traced streaming window
CPROFILE_WINDOW = (1024, 1280)   # one drain
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


def _host_calls(prof, names) -> int:
    """Host calls to the CUDA API functions `names`."""
    from torch.autograd import DeviceType

    return sum(1 for e in prof.events()
               if e.device_type == DeviceType.CPU and e.name in names)


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
        "kernel_launch_calls": _host_calls(prof, LAUNCH_CALLS),
        "graph_launch_calls": _host_calls(prof, GRAPH_CALLS),
        "kernels": len(ivals) - n_copies,
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
        "batch_steps": sess.stats.counts.get("batch_steps", 0),
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
          f"{t['sync_calls']} synchronize calls, host launch calls "
          f"{t['kernel_launch_calls']} cudaLaunchKernel and "
          f"{t['graph_launch_calls']} cudaGraphLaunch")
    if "sequential_match_ms_per_scan" in r:
        print(f"# {tag} per scan: {t['kernel_launch_calls_per_scan']} "
              f"cudaLaunchKernel, {t['graph_launch_calls_per_scan']} "
              f"cudaGraphLaunch, {t['kernel_launches_per_scan']} device "
              f"kernels ({t['programs_captured']} programs captured in "
              f"the traced run); sequential_match "
              f"{r['sequential_match_ms_per_scan']} host ms per scan over "
              f"the plain run")
    if "steps" in t:
        print(f"# {tag} per batch step ({t['steps']} steps in the window): "
              f"{t['kernel_launch_calls_per_step']} cudaLaunchKernel, "
              f"{t['graph_launch_calls_per_step']} cudaGraphLaunch, "
              f"{t['kernels_per_step']} device kernels; batch_dispatch "
              f"{r['batch_dispatch_ms_per_step']} ms per scan over the run "
              f"(less the graph's capture)")
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
    sess.mapper.initialize(laser2.range_threshold)
    matchers = (sess.mapper.sequential_matcher, sess.mapper.loop_matcher)
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_session(sess, data2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t = classic["trace"] = _trace_summary(prof, wall, classic["scans"])
    t["sync_calls_per_scan"] = t["sync_calls"] / classic["scans"]
    # the matches are program replays: the host's launch calls per scan,
    # kernels and graphs apart, and the sequential match's host time
    for key in ("kernel_launch_calls", "graph_launch_calls"):
        t[f"{key}_per_scan"] = t[key] / classic["scans"]
    # captured inside the trace: each capture's eager warm-up is one
    # match's or verify's worth of cudaLaunchKernel
    t["programs_captured"] = sum(len(m._programs) for m in matchers)
    classic["sequential_match_ms_per_scan"] = (
        classic["stages"]["sequential_match"]["ms_total"] / classic["scans"])

    # the streaming path, 16 laps, a two-drain window traced
    prof = torch.profiler.profile(activities=acts)
    window = {}

    sess = SlamSession(cfg, laser, **kw)
    sess.stats.enabled = True
    steps = sess.stats.counts

    def on_scan(k):
        if k == WINDOW[0]:
            torch.cuda.synchronize()
            window["steps"] = steps["batch_steps"]
            prof.start()
            window["t0"] = time.perf_counter()
        elif k == WINDOW[1]:
            torch.cuda.synchronize()
            window["wall"] = time.perf_counter() - window["t0"]
            prof.stop()
            window["steps"] = steps["batch_steps"] - window["steps"]

    run_session(sess, data, on_scan=on_scan)
    n_win = WINDOW[1] - WINDOW[0]
    t = streaming["trace"] = _trace_summary(prof, window["wall"], n_win)
    # less the synchronize that closes the window
    t["sync_calls_per_drain"] = (t["sync_calls"] - 1) / (n_win // DRAIN)
    t["steps"] = window["steps"]
    for key in ("kernel_launch_calls", "graph_launch_calls", "kernels"):
        t[f"{key}_per_step"] = t[key] / window["steps"]
    # per scan of a first run (re-runs are outside batch_dispatch), less
    # the step graph's capture at the first batch
    stages = streaming["stages"]
    streaming["batch_dispatch_ms_per_step"] = (
        stages["batch_dispatch"]["ms_total"]
        - stages.get("graph_capture", {}).get("ms_total", 0.0)
    ) / streaming["scans"]

    # one steady drain under cProfile
    streaming["cprofile"] = _cprofile_drain(
        SlamSession(cfg, laser, **kw), data)

    result = {"card": card, "classic": classic, "streaming": streaming}
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    _print("classic", card, classic)
    _print("streaming", card, streaming)
    c = streaming["cprofile"]
    print(f"# streaming cProfile of one drain: {c['calls_s']} s in the "
          f"calls of accepted scans {CPROFILE_WINDOW[0] + 1} to "
          f"{CPROFILE_WINDOW[1]}; by cumulative time:")
    print(c["by_cumulative"])
    print("# by own time:")
    print(c["by_own"])
    return 0


def _cprofile_drain(sess, data, top: int = 30):
    """cProfile over the process_scan calls of CPROFILE_WINDOW's accepted
    scans (one drain), the card synchronized at both ends: the window's
    seconds and the top functions by cumulative and by own time."""
    import torch

    from chip_smoke import run_session

    prof = cProfile.Profile()
    box = {}

    def on_scan(k):
        if k == CPROFILE_WINDOW[0]:
            torch.cuda.synchronize()
            box["t0"] = time.perf_counter()
            prof.enable()
        elif k == CPROFILE_WINDOW[1]:
            torch.cuda.synchronize()
            prof.disable()
            box["s"] = time.perf_counter() - box["t0"]

    sess.stats.enabled = True
    run_session(sess, data, on_scan=on_scan)
    out = {"calls_s": box["s"]}
    for key, sort in (("by_cumulative", "cumulative"), ("by_own", "tottime")):
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats(sort).print_stats(top)
        out[key] = buf.getvalue()
    return out


if __name__ == "__main__":
    sys.exit(main())
