#!/usr/bin/env python3
"""BASELINE configurations 2, 3 and 4 (BASELINE.md) run whole through
the PyTorch port's entry points: the port's counterpart of
scripts/bench_suite.py config2 / config3 / config4.

    python3 configs_torch.py config2
    python3 configs_torch.py config3 --variant marginalized
    python3 configs_torch.py config3 --variant reference
    python3 configs_torch.py config4

One configuration per call. On a card it first builds the kernels
(timed apart from the run). Each run prints `#` lines as it goes, then
one JSON line with its figures: the card's name and power limit, peak
device memory, the pack pool's growths and compactions, the program
captures by kind with the graphs' pool bytes, the K1-K3 launches by grid
side, the host stages, and the configuration's own figures beside the
JAX package's record where it has one (CONFIG3.json, CONFIG4.json: its
accuracy figures, read from the repo). It writes no file into the repo.

  config2  the apartment's 40 laps (5,080 raw scans) through
           SlamSession(streaming=True, drain_every=96), a warm pass then
           a timed pass in new sessions; bars: ATE below 0.15 m, a
           closure.
  config3  the warehouse's 40 serpentine laps (19,241 raw scans) with
           LifelongMapper.stream_hook, drains of 96, chains of at least
           5 scans. `marginalized`: steady_state_min_candidates 20,
           marginalize_on_removal; bars: survivors-ATE below half of
           their odometry's, second-half growth below 0.02 nodes/scan, a
           closure. `reference`: the reference's decay alone
           (steady_state_min_candidates 0, removals deleted); bar: every
           scan processed and every pose finite.
  config4  a 100,010-node prior (build_prior_snapshot), saved and loaded,
           then localization (LOCALIZE_AT_POSE, drains of 16) over the
           4-row circuit tiled to at least 6,568 localized scans; bars:
           rmse below 0.35 m, the graph bounded by prior + buffer, an
           accepted closure, a windowed solve. The prior's rows are
           raycast in threads (one for each core the process may use),
           each row from its own seeded simulator, so the snapshot is the
           same for any count. The prior snapshot is kept in the
           temporary directory (TMPDIR) under its size, beam count and a
           hash of the code that builds it, and a later run on the same
           machine loads it from there (--cache DIR puts it elsewhere).

It runs on the card unless `--device cpu` is given, and raises without
one. Run as a script it keeps the host memory it frees
(workloads_torch.keep_freed_memory: glibc neither trims the heap nor maps
the simulator's temporaries), which the prior's ray casts need where the
kernel's page faults are costly (the sandboxed H100 host of PERF.md).
The cut options (--laps, --scans, --prior-nodes, --resolution,
--beam-deg) shrink a run for a rehearsal on the CPU; the bars are held
only on a whole run, and no rate is asserted. It imports
nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import resource
import sys
import tempfile
import time

import workloads_torch as wl

REPO = os.path.dirname(os.path.abspath(__file__))


def reference(name: str) -> dict:
    """The JAX package's record of a configuration (CONFIG3.json,
    CONFIG4.json)."""
    with open(os.path.join(REPO, name)) as f:
        return json.load(f)


def start(dev) -> int:
    """Reset the launch counts and the device memory's peak; returns the
    device memory allocated now (0 on the CPU)."""
    import torch

    from slam_toolbox_tpu_torch.kernels import match_cuda as mc

    mc.reset_launch_counts()
    if dev.type != "cuda":
        return 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev)


def report(tag: str, sess, base: int) -> dict:
    """Print and return the session's resources (wl.resources, its peak
    over `base`); on a card also the process's graph pools after the
    allocator's cache is emptied, which keeps only the live programs'
    pools (a program captured again leaves its old pool cached until
    then)."""
    import torch

    res = wl.resources(sess, base)
    if sess.device.type == "cuda":
        torch.cuda.empty_cache()
        res["process_graph_pool_bytes_live"] = wl.graph_pool_bytes()
    print(f"# {tag} resources: {json.dumps(res)}", flush=True)
    return res


def config2(dev, laps: int = wl.APARTMENT_LAPS, scans=None,
            resolution: float = 0.01, beam_deg: float = 1.0 / 3,
            bars: bool = True, check_grids=None) -> dict:
    """Config 2: a warm pass and a timed pass, each a new session over the
    first `scans` raw scans (all by default); where `bars`, each pass's
    ATE below half of odometry's with a closure (run_mapping) and the
    timed pass's ATE below 0.15 m."""
    import dataclasses

    from slam_toolbox_tpu_torch.api import SlamSession

    t0 = time.perf_counter()
    (cfg, laser, data), sim_s = wl.timed_host(
        lambda: wl.apartment_workload(laps, beam_deg))
    cfg = dataclasses.replace(
        cfg, correlation_search_space_resolution=resolution)
    print(f"# config2: the apartment's {laps} laps, {len(data)} raw scans "
          f"simulated in {sim_s} s", flush=True)
    data = data[:scans]
    passes = []
    for tag in ("config2 warm", "config2"):
        base = start(dev)
        sess = SlamSession(cfg, laser, streaming=True, drain_every=96,
                           device=dev)
        r = wl.run_mapping(sess, data, tag, need_closure=bars, ate_bar=bars)
        if check_grids is not None:
            check_grids(tag, r["by_grid"])
        passes.append(dict(
            tag=tag, accepted=r["scans"], nodes=sess.mapper.solver.n_nodes,
            closures=r["closures"], ate=r["ate"], rate=r["rate"],
            wall=r["wall"], launches_by_grid=r["by_grid"],
            stages=wl.stage_times(sess), resources=report(tag, sess, base)))
        sess.close()    # the next pass starts with this one's memory freed
        del sess, r
    if bars and not passes[-1]["ate"] < 0.15:
        raise AssertionError(f"config2: ATE {passes[-1]['ate']} m, not "
                             f"below 0.15 m")
    return dict(config="config2", raw_scans=len(data), laps=laps,
                passes=passes, seconds=time.perf_counter() - t0)


VARIANTS = {
    # CONFIG3.json's steady_state_marginalized and reference_decay
    "marginalized": dict(ss_min=wl.SS_MIN, marginalize=True,
                         record="steady_state_marginalized"),
    "reference": dict(ss_min=0, marginalize=False,
                      record="reference_decay"),
}


def config3(dev, variant: str, laps: int = wl.WAREHOUSE_LAPS,
            scans=None, resolution: float = 0.01,
            beam_deg: float = 1.0 / 3, bars: bool = True) -> dict:
    """Config 3, one variant, over the first `scans` raw scans (all of
    them by default): every pose finite (lifelong_run), and where `bars`
    the marginalized variant's bars (lifelong_bars)."""
    v = VARIANTS[variant]
    t0 = time.perf_counter()
    (laser, data), sim_s = wl.timed_host(
        lambda: wl.warehouse_workload(laps, beam_deg))
    print(f"# config3: the warehouse's {laps} laps, {len(data)} raw scans "
          f"simulated in {sim_s} s", flush=True)
    cfg = wl.lifelong_cfg(v["marginalize"],
                          correlation_search_space_resolution=resolution)
    tag = f"config3 {variant}"
    base = start(dev)
    r = wl.lifelong_run(dev, data, cfg, laser, scans, ss_min=v["ss_min"],
                        tag=tag)
    res = report(tag, r["sess"], base)
    ref = reference("CONFIG3.json")["variants"][v["record"]]
    print(f"# {tag} against the JAX package's {v['record']} "
          f"(CONFIG3.json): final nodes {r['nodes']} and "
          f"{ref['final_nodes']}, survivors-ATE {r['ate']} and "
          f"{ref['survivors_ate_m']} m, online error p50 "
          f"{r['err']['p50']} and {ref['online_err_p50_m']} m, p95 "
          f"{r['err']['p95']} and {ref['online_err_p95_m']} m, max "
          f"{r['err']['max']} and {ref['online_err_max_m']} m; node "
          f"curves {json.dumps(r['curve'])} and "
          f"{json.dumps(ref['nodes_vs_scans'])}", flush=True)
    if bars and variant == "marginalized":
        wl.lifelong_bars(tag, r)
    keys = ("raw_scans", "accepted", "wall", "rate", "curve", "nodes",
            "growth", "ate", "ate_odo", "survivors", "err", "closures",
            "marg", "stages", "decay_ms")
    return dict(config="config3", variant=variant, laps=laps,
                **{k: r[k] for k in keys},
                launches_by_grid=r["by_grid"], resources=res,
                reference={k: ref.get(k) for k in (
                    "final_nodes", "survivors_ate_m", "online_err_p50_m",
                    "online_err_p95_m", "online_err_max_m")},
                seconds=time.perf_counter() - t0)


# what a cached prior is made by: the builder (workloads_torch), the
# simulator and the snapshot's format
PRIOR_SOURCES = ("workloads_torch.py", "slam_toolbox_tpu_torch/io/dataset.py",
                 "slam_toolbox_tpu_torch/io/serialization.py")


def prior_path(n_nodes: int, laser, cache=None) -> str:
    """Where config 4's prior of n_nodes lives: the cache directory (the
    temporary directory by default), named by its size, its beams and a
    hash of PRIOR_SOURCES, so a prior built by other code is not loaded."""
    h = hashlib.sha256()
    for name in PRIOR_SOURCES:
        with open(os.path.join(REPO, name), "rb") as f:
            h.update(f.read())
    root = cache or tempfile.gettempdir()
    return os.path.join(root, f"slam_torch_prior_{n_nodes}_{laser.n_beams}_"
                              f"{h.hexdigest()[:16]}.npz")


def config4(dev, n_prior: int = wl.PRIOR_NODES, scans=None,
            resolution: float = 0.01, beam_deg: float = 1.0 / 3,
            bars: bool = True, cache=None) -> dict:
    """Config 4: the prior built or found in the cache, then the tiled
    circuit localized against it; `scans` cuts the circuit."""
    t0 = time.perf_counter()
    laser = wl.suite_laser(beam_deg)
    snap = prior_path(n_prior, laser, cache)
    if os.path.exists(snap):
        world, build_s, save_s = wl.prior_world(n_prior), None, None
        print(f"# config4: the prior from the cache {snap}", flush=True)
    else:
        world, build_s, save_s = wl.build_prior_snapshot(
            snap, n_prior, laser, dev=dev)
    circuit, circ_s = wl.timed_host(lambda: wl.loc_circuit(world, laser))
    repeats = math.ceil(wl.LOCALIZED_SCANS / len(circuit))
    tiled = wl.repeat_circuit(circuit, repeats)[:scans]
    print(f"# config4 prior: {n_prior} nodes built in {build_s} s, saved in "
          f"{save_s} s, {os.path.getsize(snap)} bytes; circuit "
          f"{len(circuit)} scans ({wl.LOOP_ROWS} rows out and back) "
          f"simulated in {circ_s} s, tiled {repeats} times, {len(tiled)} "
          f"scans run", flush=True)
    cfg = wl.loc_cfg(correlation_search_space_resolution=resolution)
    base = start(dev)
    r = wl.localization_run("config4", dev, snap, tiled, laser, cfg,
                            n_prior, bars=bars)
    res = report("config4", r["sess"], base)
    ref = reference("CONFIG4.json")
    print(f"# config4 against the JAX package's record (CONFIG4.json, "
          f"{ref['prior_nodes']} nodes, {ref['scans_localized']} scans "
          f"localized): rmse {r['rmse']} and {ref['rmse_m']} m, p50 "
          f"{r['err']['p50']} and {ref['err_p50_m']} m, p95 "
          f"{r['err']['p95']} and {ref['err_p95_m']} m, max "
          f"{r['err']['max']} and {ref['err_max_m']} m", flush=True)
    if bars and r["localized"] < wl.LOCALIZED_SCANS:
        raise AssertionError(f"config4: {r['localized']} scans localized, "
                             f"fewer than {wl.LOCALIZED_SCANS}")
    keys = ("load_s", "prime_s", "wall", "rate", "rmse", "err", "localized",
            "nodes", "solves", "gates", "spec", "stages")
    return dict(config="config4", prior_nodes=n_prior, build_s=build_s,
                save_s=save_s, snapshot_bytes=os.path.getsize(snap),
                circuit=len(circuit), repeats=repeats, raw_scans=len(tiled),
                **{k: r[k] for k in keys}, launches_by_grid=r["by_grid"],
                resources=res,
                reference={k: ref.get(k) for k in (
                    "prior_nodes", "scans_localized", "rmse_m", "err_p50_m",
                    "err_p95_m", "err_max_m")},
                seconds=time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config", choices=("config2", "config3", "config4"))
    ap.add_argument("--variant", choices=tuple(VARIANTS),
                    default="marginalized", help="config3's decay")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--laps", type=int, default=None,
                    help="cut: config2's or config3's laps")
    ap.add_argument("--scans", type=int, default=None,
                    help="cut: the first N raw scans")
    ap.add_argument("--prior-nodes", type=int, default=wl.PRIOR_NODES,
                    help="cut: config4's prior")
    ap.add_argument("--resolution", type=float, default=0.01,
                    help="cut: the correlation search resolution (m)")
    ap.add_argument("--beam-deg", type=float, default=1.0 / 3,
                    help="cut: the beam spacing (degrees)")
    ap.add_argument("--cache", default=None,
                    help="config4: the prior snapshot's directory")
    args = ap.parse_args(argv)

    import torch

    from slam_toolbox_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    whole = (args.laps is None and args.scans is None
             and args.prior_nodes == wl.PRIOR_NODES
             and args.resolution == 0.01 and args.beam_deg == 1.0 / 3)
    card = wl.card_line() if dev.type == "cuda" else "cpu"
    held = "held" if whole else "not held (a cut run)"
    build_s = None
    if dev.type == "cuda":   # the kernels' build, apart from the run
        from slam_toolbox_tpu_torch.kernels import match_cuda as mc

        build_s = mc.build_kernels()
    print(f"# configs_torch {args.config} on {card}; torch "
          f"{torch.__version__}; bars {held}; kernels built in {build_s} s",
          flush=True)
    t0 = time.perf_counter()
    common = dict(resolution=args.resolution, beam_deg=args.beam_deg,
                  bars=whole)
    if args.config == "config2":
        out = config2(dev, args.laps or wl.APARTMENT_LAPS, args.scans,
                      **common)
    elif args.config == "config3":
        out = config3(dev, args.variant, args.laps or wl.WAREHOUSE_LAPS,
                      args.scans, **common)
    else:
        out = config4(dev, args.prior_nodes, args.scans, cache=args.cache,
                      **common)
    out.update(device=dict(
        type=dev.type, card=card, count=torch.cuda.device_count()
        if dev.type == "cuda" else 0), bars_held=whole,
        kernel_build_s=build_s,
        command_s=time.perf_counter() - t0,
        host_peak_rss_bytes=1024 * resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss)
    print(json.dumps(out, default=float))
    return 0


if __name__ == "__main__":
    # the script's own process keeps the host memory it frees (a caller
    # of main() in its own process keeps its allocator's settings)
    print(f"# freed host memory kept (mallopt): {wl.keep_freed_memory()}",
          flush=True)
    sys.exit(main())
