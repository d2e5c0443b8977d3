#!/usr/bin/env python3
"""BASELINE configurations 2 to 5 (BASELINE.md) run whole through the
PyTorch port's entry points: the port's counterpart of
scripts/bench_suite.py config2 / config3 / config4 and of
scripts/bench_merge500k.py (config 5).

    python3 configs_torch.py config2
    python3 configs_torch.py config3 --variant marginalized
    python3 configs_torch.py config3 --variant reference
    python3 configs_torch.py config4
    python3 configs_torch.py config5
    python3 configs_torch.py config5 --variant sessions

One configuration per call. On a card it first builds the kernels
(timed apart from the run). Each run prints `#` lines as it goes, then
one JSON line with its figures: the card's name and power limit, peak
device memory, the pack pool's growths and compactions, the program
captures by kind with the graphs' pool bytes, the K1-K3 launches by grid
side, the host stages, and the configuration's own figures beside the
JAX package's record where it has one (CONFIG3.json, CONFIG4.json,
MERGE500K.json: its counts and accuracy figures, read from the repo). It
writes no file into the repo.

  config2  the apartment's 40 laps (5,080 raw scans) through
           SlamSession(streaming=True, drain_every=96), a warm pass then
           a timed pass in new sessions; bars: ATE below 0.15 m, a
           closure.
  config3  the warehouse's 40 serpentine laps (19,241 raw scans) through
           SlamSession(lifelong=...), drains of 96, chains of at least
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
  config5  `merge` (the default): 8 serpentine sessions of 62,500 nodes
           at 61 beams (500,000 nodes), built as skeleton graphs (their
           aisles raycast in threads) and saved, one at a time, cached as
           config 4's prior is; loaded into a MapMerger on the card, each
           session auto-aligned against the one before (a 2 m search at
           0.05 m: G 441), merged at 0.1 m on both routes (bit-equal),
           then the joint graph (the chains and the cross-session edges,
           524,288 nodes padded) solved by distributed_lm_solve on a mesh
           of one (3 LM steps, 50 CG iterations, Schwarz blocks of 512
           nodes, f32), again replaying its programs (bit-equal), and by
           host_sparse_lm. Each stage's seconds, peak device memory and
           peak host memory. Bars: 500,000 nodes, 7 of 7 aligned, the
           grid [50005, 908], chi2 below its start and within 1.1 of
           MERGE500K.json's, every pose finite, within 1 cm of
           host_sparse_lm's solution. `sessions`: cmd_config5's three
           sessions mapped by SlamSession(streaming=True,
           drain_every=96) over bands of the warehouse's aisles, aligned
           against session 0 and merged at 0.05 m on both routes
           (bit-equal); each session's nodes and ATE.

It runs on the card unless `--device cpu` is given, and raises without
one. Run as a script it keeps the host memory it frees
(workloads_torch.keep_freed_memory: glibc neither trims the heap nor maps
the simulator's temporaries), which the prior's ray casts need where the
kernel's page faults are costly (the sandboxed H100 host of PERF.md).
The cut options (--laps, --scans, --prior-nodes, --sessions, --nodes-per,
--beams, --gn-steps, --resolution, --beam-deg) shrink a run for a
rehearsal on the CPU; the bars are held only on a whole run, and no rate
is asserted. It imports nothing of JAX and nothing of the JAX package.
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


# config 5's runs: scripts/bench_merge500k.py's merge (MERGE500K.json)
# and scripts/bench_suite.py cmd_config5's mapped sessions
C5_VARIANTS = ("merge", "sessions")
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


def sources_hash() -> str:
    """A hash of PRIOR_SOURCES: a cached snapshot's name holds it, so a
    snapshot built by other code is not loaded."""
    h = hashlib.sha256()
    for name in PRIOR_SOURCES:
        with open(os.path.join(REPO, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def prior_path(n_nodes: int, laser, cache=None) -> str:
    """Where config 4's prior of n_nodes lives: the cache directory (the
    temporary directory by default), named by its size, its beams and
    sources_hash()."""
    root = cache or tempfile.gettempdir()
    return os.path.join(root, f"slam_torch_prior_{n_nodes}_{laser.n_beams}_"
                              f"{sources_hash()}.npz")


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


def merge_paths(sessions: int, nodes_per: int, laser, cache=None) -> list:
    """Where config 5's session snapshots live: the cache directory (the
    temporary directory by default), named by the sessions, their nodes,
    the beams and sources_hash()."""
    root = cache or tempfile.gettempdir()
    stem = (f"slam_torch_merge_{sessions}x{nodes_per}_{laser.n_beams}_"
            f"{sources_hash()}")
    return [os.path.join(root, f"{stem}_s{s}.npz") for s in range(sessions)]


class Stages:
    """Each stage's host seconds (the card synchronized on both sides),
    its peak allocated device memory (the peak reset before it) and the
    process's peak resident host memory after it."""

    def __init__(self, dev):
        self.dev = dev
        self.seconds, self.peak_bytes, self.rss_bytes = {}, {}, {}

    def __call__(self, name: str, fn):
        import torch

        cuda = self.dev.type == "cuda"
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(self.dev)
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
            self.peak_bytes[name] = torch.cuda.max_memory_allocated(self.dev)
        self.seconds[name] = time.perf_counter() - t0
        self.rss_bytes[name] = 1024 * resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss
        return out

    def record(self) -> dict:
        return dict(seconds=self.seconds, peak_allocated_bytes=self.peak_bytes,
                    host_peak_rss_bytes=self.rss_bytes)


def merge_both_routes(tag: str, merger, resolution: float, st: Stages):
    """merger.merge on the device's own route (trace_beams on a card) and
    on the native host Bresenham (workloads_torch.occupancy_route), each
    timed as a stage, held bit-equal; returns the first grid's summary."""
    with wl.occupancy_route(False):
        card = st("merge_device_route",
                  lambda: merger.merge(resolution=resolution))
    with wl.occupancy_route(True):
        native = st("merge_native_route",
                    lambda: merger.merge(resolution=resolution))
    wl.same_grid(f"{tag} merge, native vs device route", native, card)
    out = wl.grid_summary(card)
    n_beams = sum(len(s.ranges) for sub in merger.submaps for s in sub)
    print(f"# {tag} merge: {len(merger.submaps)} sessions, "
          f"{sum(map(len, merger.submaps))} scans, {n_beams} beams at "
          f"{resolution} m, {json.dumps(out)}, device route "
          f"{st.seconds['merge_device_route']} s, native route "
          f"{st.seconds['merge_native_route']} s, bit-equal", flush=True)
    return out


def config5(dev, sessions: int = None, nodes_per: int = None,
            beams: int = None, gn_steps: int = 3, bars: bool = True,
            cache=None) -> dict:
    """Config 5 as scripts/bench_merge500k.py runs it: the sessions built
    (or found in the cache) and saved, loaded into a MapMerger on `dev`,
    each auto-aligned against the one before (a 2 m search at 0.05 m,
    min response 0.2), merged at 0.1 m on both routes (bit-equal), then
    the joint graph solved by distributed_lm_solve on a mesh of one
    (`gn_steps` LM steps, 50 CG iterations, Schwarz blocks of 512 nodes,
    f32) twice, the second replaying the first's programs (bit-equal),
    and by host_sparse_lm in the same LM steps (and, reported only, with
    SolverConfig's defaults). Every pose finite and chi2 below its start
    always; where `bars` MERGE500K.json's: 500,000 nodes, 7 of 7
    aligned, the grid [50005, 908], chi2 within 1.1 of its record's, and
    the distributed solution within 1 cm of the host's of the same LM
    steps. On a card every
    path kernel launched in the alignment."""
    import numpy as np

    from slam_toolbox_tpu_torch.api.merge import MapMerger
    from slam_toolbox_tpu_torch.core.params import SolverConfig
    from slam_toolbox_tpu_torch.device import upload
    from slam_toolbox_tpu_torch.dist import multihost
    from slam_toolbox_tpu_torch.dist.solver_dist import distributed_lm_solve
    from slam_toolbox_tpu_torch.kernels import match_cuda as mc
    from slam_toolbox_tpu_torch.solver import se2_solver as se2

    sessions = sessions or wl.MERGE_SESSIONS
    nodes_per = nodes_per or wl.MERGE_NODES_PER
    beams = beams or wl.MERGE_BEAMS
    t0 = time.perf_counter()
    st = Stages(dev)
    laser = wl.merge_laser(beams)
    rng = np.random.default_rng(7)
    paths = merge_paths(sessions, nodes_per, laser, cache)
    if all(os.path.exists(p) for p in paths):
        wl.skip_merge_noise(rng, sessions, nodes_per)
        print(f"# config5: {sessions} sessions from the cache "
              f"{os.path.dirname(paths[0])}", flush=True)
    else:
        os.makedirs(os.path.dirname(paths[0]), exist_ok=True)
        _, st.seconds["build"], st.seconds["save"] = (
            wl.build_merge_snapshots(paths, nodes_per, laser, rng))
    snap_bytes = sum(os.path.getsize(p) for p in paths)
    merger = MapMerger(device=dev)
    st("load", lambda: [merger.add_submap(p) for p in paths])
    nodes = sum(len(s) for s in merger.submaps)
    print(f"# config5 load: {nodes} nodes of {sessions} sessions "
          f"({snap_bytes} bytes) in {st.seconds['load']} s", flush=True)

    mc.reset_launch_counts()
    responses = st("align", lambda: [merger.auto_align(
        s - 1, s, search_size=2.0, resolution=0.05, min_response=0.2)
        for s in range(1, sessions)])
    by_grid = wl.launches_by_grid()
    aligned = sum(r is not None for r in responses)
    print(f"# config5 align: {aligned} of {sessions - 1} sessions aligned "
          f"in {st.seconds['align']} s, responses {responses}, launches by "
          f"grid {json.dumps(by_grid)}", flush=True)
    missing = [k for k in wl.PATH_KERNELS if not by_grid[k]]
    if missing and dev.type == "cuda":
        raise AssertionError(f"config5 align: kernels never launched: "
                             f"{missing}")
    grid = merge_both_routes("config5", merger, 0.1, st)

    g = st("joint_graph", lambda: wl.joint_graph(merger, rng))
    n, n_pad, e = g["n"], g["n_pad"], len(g["src"])
    print(f"# config5 joint graph: {n} nodes padded to {n_pad}, {e} edges "
          f"({g['n_chain']} chain, {g['n_cross']} across sessions) in "
          f"{st.seconds['joint_graph']} s", flush=True)
    mesh = multihost.global_mesh(dev)
    args = tuple(g[k] for k in ("poses", "src", "dst", "rel", "sqrt_info",
                                "emask", "free"))

    def solve():
        out, chi2 = distributed_lm_solve(
            mesh, *args, max_iterations=gn_steps, cg_iters=50, block=512)
        return out, chi2, list(distributed_lm_solve.last_cg_iters)

    t_args = [upload(np.asarray(a, t), dev) for a, t in zip(
        args[:5], (np.float32, np.int64, np.int64, np.float32, np.float32))]
    chi2_0 = float(se2.chi2_only(*t_args, upload(g["emask"], dev)))
    del t_args
    out, chi2, cg = st("solve", solve)
    out2, chi2_2, cg2 = st("solve_replayed", solve)
    if not (np.array_equal(out, out2) and chi2 == chi2_2 and cg == cg2):
        raise AssertionError("config5 solve: the replayed solve differs")
    def host_solve(iterations):
        return se2.host_sparse_lm(
            g["poses"][:n].astype(np.float64), g["src"], g["dst"], g["rel"],
            g["sqrt_info"], g["free"][:n].astype(np.float64),
            SolverConfig(max_iterations=iterations))

    def distance(host):
        d = out[:n].astype(np.float64) - host
        return (float(np.max(np.hypot(d[:, 0], d[:, 1]))),
                float(np.max(np.abs(np.arctan2(np.sin(d[:, 2]),
                                               np.cos(d[:, 2]))))))

    # the host solve of the same LM steps (the same damping schedule,
    # each step's system factored exactly), and with SolverConfig's
    # defaults (up to 50 LM steps): a few damped steps leave the
    # 62,500-node chains' slow bending modes far from converged, so that
    # one is only reported
    host, host_chi2, host_iters = st("host_solve",
                                     lambda: host_solve(gn_steps))
    dxy, dth = distance(host)
    full, full_chi2, full_iters = st(
        "host_solve_default",
        lambda: host_solve(SolverConfig().max_iterations))
    full_dxy, full_dth = distance(full)
    finite = bool(np.all(np.isfinite(out)))
    print(f"# config5 solve: chi2 {chi2_0} -> {chi2} in {len(cg)} LM steps, "
          f"CG iterations {cg}, {st.seconds['solve']} s with its capture "
          f"(peak {st.peak_bytes.get('solve')} bytes), "
          f"{st.seconds['solve_replayed']} s replayed (bit-equal); "
          f"host_sparse_lm of the same {gn_steps} LM steps: chi2 {host_chi2}, "
          f"{st.seconds['host_solve']} s, largest distance to it {dxy} m "
          f"{dth} rad; with SolverConfig's defaults ({full_iters} LM "
          f"steps, {st.seconds['host_solve_default']} s): chi2 {full_chi2}, "
          f"largest distance {full_dxy} m {full_dth} rad", flush=True)
    ref = reference("MERGE500K.json")
    if not finite:
        raise AssertionError("config5 solve: a pose is not finite")
    if not chi2 < chi2_0:
        raise AssertionError(f"config5 solve: chi2 {chi2_0} -> {chi2}")
    if bars:
        want = dict(nodes=(nodes, ref["total_nodes"]),
                    aligned=(aligned, ref["aligned"]),
                    grid=(grid["shape"], ref["grid_shape"]))
        for what, (got, rec) in want.items():
            if got != rec:
                raise AssertionError(f"config5: {what} {got}, not {rec}")
        if not chi2 <= 1.1 * ref["solve_chi2"]:
            raise AssertionError(f"config5: chi2 {chi2} past 1.1 times "
                                 f"{ref['solve_chi2']}")
        if not dxy < 0.01:
            raise AssertionError(f"config5: {dxy} m from host_sparse_lm")
    return dict(
        config="config5", variant="merge", sessions=sessions,
        nodes_per=nodes_per, beams=beams, snapshot_bytes=snap_bytes,
        nodes=nodes, n_pad=n_pad, edges=e, chain_edges=g["n_chain"],
        cross_edges=g["n_cross"], aligned=aligned, responses=responses,
        grid=grid, chi2_initial=chi2_0, chi2=chi2, cg_iters=cg,
        host_chi2=host_chi2, host_iters=host_iters, host_dxy=dxy,
        host_dth=dth, default_host_chi2=full_chi2,
        default_host_iters=full_iters, default_host_dxy=full_dxy,
        default_host_dth=full_dth, poses_finite=finite,
        launches_by_grid=by_grid,
        stages=st.record(), reference={k: ref.get(k) for k in (
            "sessions", "nodes_per", "total_nodes", "aligned", "grid_shape",
            "solve_chi2", "solve_cg_iters", "solve_devices")},
        seconds=time.perf_counter() - t0)


def config5_sessions(dev, sessions: int = 3, scans=None,
                     resolution: float = 0.01,
                     beam_deg: float = 1.0 / 3) -> dict:
    """Config 5 as scripts/bench_suite.py cmd_config5 runs it: each of
    `sessions` sessions maps a band of the warehouse's aisles (overlapping
    one aisle) through SlamSession(streaming=True, drain_every=96) and is
    serialized; the snapshots are loaded into a MapMerger on `dev`, each
    auto-aligned against session 0 at the default geometry and merged at
    0.05 m on both routes (bit-equal). Every pose finite; `scans` cuts
    each session's raw scans. No bar of the JAX package's: it has no
    record of this run."""
    import numpy as np

    from slam_toolbox_tpu_torch.api import SlamSession
    from slam_toolbox_tpu_torch.api.merge import MapMerger
    from slam_toolbox_tpu_torch.io.dataset import ate_rmse

    t0 = time.perf_counter()
    st = Stages(dev)
    laser, bands = wl.band_sessions(sessions, beam_deg)
    cfg = wl.suite_cfg(correlation_search_space_resolution=resolution)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for s, (a0, per, sim, wps) in enumerate(bands):
            data = sim.simulate(wps, step=0.3)[:scans]
            sess = SlamSession(cfg, laser, streaming=True, drain_every=96,
                               device=dev)
            tag = f"session{s}"
            est, gt, odo, _, _ = st(tag, lambda: wl.run_session(sess, data))
            traj = sess.trajectory
            if not np.all(np.isfinite(traj)):
                raise AssertionError(f"config5 {tag}: a pose is not finite")
            paths.append(os.path.join(tmp, f"{tag}.npz"))
            sess.serialize(paths[-1])
            runs.append(dict(aisles=[a0, a0 + per - 1], raw_scans=len(data),
                             nodes=sess.mapper.solver.n_nodes,
                             ate=ate_rmse(traj, gt), ate_odom=ate_rmse(odo,
                                                                       gt)))
            print(f"# config5 {tag}: aisles {runs[-1]['aisles']}, "
                  f"{len(data)} raw scans, {runs[-1]['nodes']} nodes, ATE "
                  f"{runs[-1]['ate']} m vs odometry {runs[-1]['ate_odom']} "
                  f"m, {st.seconds[tag]} s", flush=True)
            sess.close()
        merger = MapMerger(device=dev)
        st("load", lambda: [merger.add_submap(p) for p in paths])
    responses = st("align", lambda: [merger.auto_align(0, s)
                                     for s in range(1, sessions)])
    print(f"# config5 sessions align: responses {responses} in "
          f"{st.seconds['align']} s", flush=True)
    grid = merge_both_routes("config5 sessions", merger, 0.05, st)
    return dict(config="config5", variant="sessions", sessions=runs,
                responses=responses,
                aligned=sum(r is not None for r in responses), grid=grid,
                stages=st.record(), seconds=time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config", choices=("config2", "config3", "config4",
                                       "config5"))
    ap.add_argument("--variant", choices=tuple(VARIANTS) + C5_VARIANTS,
                    default=None, help="config3's decay (marginalized by "
                    "default) or config5's run (merge by default)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--laps", type=int, default=None,
                    help="cut: config2's or config3's laps")
    ap.add_argument("--scans", type=int, default=None,
                    help="cut: the first N raw scans (config5 sessions: "
                    "of each session)")
    ap.add_argument("--prior-nodes", type=int, default=wl.PRIOR_NODES,
                    help="cut: config4's prior")
    ap.add_argument("--sessions", type=int, default=None,
                    help="cut: config5's sessions")
    ap.add_argument("--nodes-per", type=int, default=None,
                    help="cut: config5's nodes a session")
    ap.add_argument("--beams", type=int, default=None,
                    help="cut: config5's beams")
    ap.add_argument("--gn-steps", type=int, default=3,
                    help="cut: config5's LM steps")
    ap.add_argument("--resolution", type=float, default=0.01,
                    help="cut: the correlation search resolution (m)")
    ap.add_argument("--beam-deg", type=float, default=1.0 / 3,
                    help="cut: the beam spacing (degrees)")
    ap.add_argument("--cache", default=None,
                    help="config4's prior snapshot's or config5's session "
                    "snapshots' directory")
    args = ap.parse_args(argv)

    import torch

    from slam_toolbox_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    variants = C5_VARIANTS if args.config == "config5" else tuple(VARIANTS)
    variant = args.variant or variants[0]
    if variant not in variants:
        ap.error(f"{args.config} has no variant {variant}")
    whole = (args.laps is None and args.scans is None
             and args.prior_nodes == wl.PRIOR_NODES
             and args.sessions is None and args.nodes_per is None
             and args.beams is None and args.gn_steps == 3
             and args.resolution == 0.01 and args.beam_deg == 1.0 / 3)
    card = wl.card_line() if dev.type == "cuda" else "cpu"
    held = "held" if whole else "not held (a cut run)"
    build_s = None
    if dev.type == "cuda":   # the kernels' build, apart from the run
        from slam_toolbox_tpu_torch.kernels import match_cuda as mc

        build_s = mc.build_kernels()
    name = (f"{args.config} {variant}" if args.config in ("config3",
                                                            "config5")
            else args.config)
    print(f"# configs_torch {name} on {card}; torch "
          f"{torch.__version__}; bars {held}; kernels built in {build_s} s",
          flush=True)
    t0 = time.perf_counter()
    common = dict(resolution=args.resolution, beam_deg=args.beam_deg)
    if args.config == "config2":
        out = config2(dev, args.laps or wl.APARTMENT_LAPS, args.scans,
                      bars=whole, **common)
    elif args.config == "config3":
        out = config3(dev, variant, args.laps or wl.WAREHOUSE_LAPS,
                      args.scans, bars=whole, **common)
    elif args.config == "config4":
        out = config4(dev, args.prior_nodes, args.scans, cache=args.cache,
                      bars=whole, **common)
    elif variant == "merge":
        out = config5(dev, args.sessions, args.nodes_per, args.beams,
                      args.gn_steps, bars=whole, cache=args.cache)
    else:
        out = config5_sessions(dev, args.sessions or 3, args.scans,
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
