"""One lifelong mapping session over lap after lap of a route: config 3's
deployment through SlamSession(lifelong=...), the scan decay running on
every drained scan.

Set-up opens the session first (a program whose SlamSession takes no
`lifelong` fails there, before anything else is done), simulates the
whole bag from the seed (the mix's route, `laps` laps), builds the kernels
and maps the first `setup_laps` laps through the session, which brings
the decay to its steady state and captures every program the session
meets. The window feeds the same session from the next lap on, scan by
scan, closed loop; it ends after the call that crosses its length, or at
the bag's end. finish() flushes the session, for the check only. The
spans (scan call, drain call, flush) and the record's keys are those of
runners/mapping.py, so its readers and the trace's breakdown read this
cell too; the record adds the Stats' self seconds (`stats_self_s`).

The runner watches each decay evaluation the session runs (it wraps the
session's LifelongMapper.evaluate_node_depreciation with one that calls
it): it notes the removed ids and, for a share FIT_SHARE of the scans
accepted in the window drawn from the seed, the poses the graph holds
for the scan and the `scan_buffer_size` scans before it when its commit
reaches the decay. Before `decay_snapshots.count`
evaluations of the window drawn from the seed among its first
`decay_snapshots.among`, it snapshots the graph (ref/decay.py's input)
and after them the program's decisions.

The check:
- unreturned (the configuration's guarantees): accepted scans whose
  process_scan pose is not finite, survivors whose pose after flush()
  is not finite, accepted scans neither surviving nor removed by the
  decay and survivors that were not accepted or were removed, and
  commits out of the accepted order;
- ate_ratio: the survivors' ATE against the simulator's truth over their
  odometry's (workloads_torch.lifelong_bars' bar);
- growth: nodes a raw scan over the window's second half, the slope of
  the node counts fitted by least squares (the same bar);
- decay_decisions_differ and decay_score_gap: each snapshot's evaluation
  recomputed by ref/decay.py in float64, against the program's;
- fit_gap: 128 scans accepted in the window, drawn from the seed, each
  at the pose the program gave it at its commit against its buffer at
  theirs (ref/fit.py); the 95th percentile of their gaps (a scan matched
  just before a closure's solve moved its buffer reads a wide gap at its
  commit, a transient the solve then corrects).
With `control`, ref/decay.py and ref/fit.py in bfloat16 take the
program's place: the decay's decisions and scores, and the sampled
scans' poses, are theirs.
"""
from __future__ import annotations

import math
import time

import numpy as np

from bench_port.gen import sim, worlds
from bench_port.ref import decay, fit
from bench_port.runners.mapping import SAMPLE, _by_grid, _geometries, _seed

FIT_SHARE = 0.1     # window scans whose commit poses are kept for fit_gap


def snapshot(sess, scan) -> dict:
    """The graph of the lifelong session `sess` just before the decay
    evaluates `scan`: ref/decay.py's input, less the scans' ranges (each
    node's id, corrected pose and score, every edge list the graph keeps
    by id, the anchors, and the order the program's candidate query
    visits)."""
    mapper = sess.mapper
    graph = mapper.graph
    scans = mapper.sensor_manager.get_all_scans()
    bb = scan.bounding_box
    radius = float(np.hypot(*(bb[1] - bb[0])) / 2.0)
    order = [s.unique_id for s in graph.find_near_linked_scans(scan, radius)]
    edges = {u: [(e.source.unique_id, e.target.unique_id) for e in es]
             for u, es in graph.adjacency.items()}
    return {"scan": scan.unique_id,
            "uid": np.array([s.unique_id for s in scans], np.int64),
            "pose": np.stack([s.corrected_pose for s in scans]),
            "edges": edges, "order": order,
            "score": dict(sess.lifelong.scores),
            "anchors": {k: np.array(v)
                        for k, v in sess.lifelong.anchors.items()}}


def decisions(sess, snap: dict, removed) -> dict:
    """The program's decisions of the evaluation `snap` was taken before,
    as ref/decay.evaluate returns its own."""
    ll = sess.lifelong
    return {"candidates": set(snap["order"]) - {snap["scan"]},
            "removed": list(removed), "scores": dict(ll.scores),
            "anchors": dict(ll.anchors)}


def stale_edges(snaps) -> int:
    """Edge entries of the snapshots' nodes whose other end is no node."""
    n = 0
    for snap, _ in snaps:
        ids = set(snap["uid"].tolist())
        for u in ids:
            n += sum(1 for a, b in snap["edges"].get(u, ())
                     if (b if a == u else a) not in ids)
    return n


class Lifelong:
    """One cell of the lifelong configurations: the harness's calls are
    setup(), window(), finish(), check() and records for the metrics."""

    def __init__(self, ctx):
        self.ctx = ctx
        cfg, mix = ctx.config, ctx.mix
        self.laser = sim.Laser(**cfg["laser"])
        self.mapper = cfg["mapper"]
        self.session = cfg["session"]
        self.lifelong = cfg["lifelong"]
        self.checks = {**cfg["checks"], **mix.get("checks", {})}
        self.spans = ctx.spans
        self.snap_cfg = cfg["decay_snapshots"]
        self.sess = None
        self.drain_s = []
        self.accepted = []       # raw index of each accepted scan
        self.bad_returns = 0     # accepted scans with a non-finite pose
        self.removed = []        # every id the decay removed
        self.order_faults = 0    # commits out of the accepted order
        self.next_uid = 0
        self.blocks = {}         # window scan id -> its block's poses
        self.snaps = []          # (snapshot, the program's decisions)
        self.watch_s = 0.0       # seconds spent in the blocks and snapshots
        self.snap_s = 0.0        # of which in the snapshots
        self.window_uid0 = None
        self.evals = 0           # the window's evaluations so far
        self.nodes = []          # graph nodes after each window call
        self.scans = 0

    # -- the program ---------------------------------------------------
    def _open(self):
        from slam_toolbox_tpu_torch.api import SlamSession
        from slam_toolbox_tpu_torch.core.params import MapperConfig
        from slam_toolbox_tpu_torch.core.scan import LaserConfig
        from slam_toolbox_tpu_torch.mapper.lifelong import LifelongConfig

        if self.session.get("dtype", "float32") != "float32":
            raise ValueError("the lifelong runner maps in float32")
        sess = SlamSession(
            MapperConfig(**self.mapper), LaserConfig(**self.ctx.config[
                "laser"]), streaming=bool(self.session["streaming"]),
            drain_every=self.session["drain_every"], device=self.ctx.device,
            lifelong=LifelongConfig(**self.lifelong))
        sess.stats.enabled = True
        ll = sess.lifelong
        evaluate = ll.evaluate_node_depreciation

        def watched(scan):
            return self._observe(evaluate, scan)

        ll.evaluate_node_depreciation = watched
        return sess

    def _observe(self, evaluate, scan):
        """One decay evaluation, watched: the scan's commit poses, a
        snapshot where drawn, the removals."""
        uid = scan.unique_id
        if uid != self.next_uid:
            self.order_faults += 1
        self.next_uid = uid + 1
        take = None
        if self.window_uid0 is not None and uid >= self.window_uid0:
            t = time.perf_counter()
            if self.keep.random() < FIT_SHARE:
                self._commit_block(scan)
            e = self.evals
            self.evals += 1
            t1 = time.perf_counter()
            if e in self.pick:
                take = snapshot(self.sess, scan)
            t2 = time.perf_counter()
            self.watch_s += t2 - t
            self.snap_s += t2 - t1
        removed = evaluate(scan)
        self.removed.extend(removed)
        if take is not None:
            t = time.perf_counter()
            self.snaps.append((take, decisions(self.sess, take, removed)))
            dt = time.perf_counter() - t
            self.watch_s += dt
            self.snap_s += dt
        return removed

    def _commit_block(self, scan) -> None:
        buf = self.mapper["scan_buffer_size"]
        sm = self.sess.mapper.sensor_manager
        uid = scan.unique_id
        ids = list(range(max(0, uid - buf), uid + 1))
        got = [sm.get_scan_by_unique_id(u) for u in ids]
        if all(s is not None for s in got):
            self.blocks[uid] = np.stack([s.corrected_pose for s in got])

    def _feed(self, i: int):
        """process_scan of raw scan i; returns (t0, t1, drained)."""
        counts = self.sess.stats.counts
        n0 = counts.get("batch_dispatch", 0)
        t0 = time.perf_counter()
        out = self.sess.process_scan(self.bag.ranges[i], self.bag.odom[i],
                                     time=0.1 * i)
        t1 = time.perf_counter()
        if out is not None:
            self.accepted.append(i)
            if not np.all(np.isfinite(out[0])):
                self.bad_returns += 1
        return t0, t1, counts.get("batch_dispatch", 0) != n0

    # -- the harness's calls ---------------------------------------------
    def setup(self, seconds: float) -> None:
        """Open the session, simulate the bag, build the kernels and map
        the set-up laps."""
        import torch

        dev = self.ctx.device
        t0 = time.perf_counter()
        self.sess = self._open()
        mix = self.ctx.mix
        gen_dev = dev if torch.device(dev).type == "cuda" else None
        world = worlds.world(mix["world"])
        wps = worlds.route(mix["route"], mix["world"])
        self.bag = sim.simulate(world, self.laser, wps, mix["step"],
                                mix["range_noise"], mix["odom_noise"],
                                _seed(self.ctx.seed, 0), device=gen_dev)
        one = worlds.route(dict(mix["route"], laps=1), mix["world"])
        lap = len(sim.trajectory_from_waypoints(
            np.concatenate([one, one[:1]]), mix["step"])) - 1
        self.setup_end = min(lap * int(mix["setup_laps"]), len(self.bag))
        t1 = time.perf_counter()
        if torch.device(dev).type == "cuda":
            from slam_toolbox_tpu_torch.kernels import match_cuda as mc

            mc.build_kernels()
        t2 = time.perf_counter()
        for i in range(self.setup_end):
            self._feed(i)
        self.ctx.log(
            f"set-up: a bag of {len(self.bag)} raw scans ({lap} a lap) "
            f"simulated in {t1 - t0:.3f} s, kernels {t2 - t1:.3f} s, "
            f"{self.setup_end} raw scans mapped in "
            f"{time.perf_counter() - t2:.3f} s to "
            f"{self.sess.mapper.solver.n_nodes} nodes")

    def window(self, seconds: float) -> None:
        from slam_toolbox_tpu_torch.kernels import match_cuda as mc

        rng = np.random.default_rng(_seed(self.ctx.seed, 11))
        among = int(self.snap_cfg["among"])
        self.pick = set(rng.choice(among, min(int(self.snap_cfg["count"]),
                                              among), replace=False).tolist())
        self.keep = np.random.default_rng(_seed(self.ctx.seed, 13))
        self.window_uid0 = len(self.accepted)
        self.sess.stats.reset()
        mc.reset_launch_counts()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        solver = self.sess.mapper.solver
        i = self.setup_end
        while i < len(self.bag):
            a, b, drained = self._feed(i)
            self.spans.add("drain call" if drained else "scan call", a, b)
            if drained:
                self.drain_s.append(b - a)
            self.nodes.append(solver.n_nodes)
            i += 1
            if b >= deadline:
                break
        self.t0, self.t1 = t0, time.perf_counter()
        self.raw_end = i
        self.window_watch_s = self.watch_s
        self.window_snap_s = self.snap_s
        self.scans = len(self.accepted) - self.window_uid0
        st = self.sess.stats
        self.stats_s = dict(st.seconds)
        self.stats_self_s = dict(st.self_seconds)
        self.stats_n = dict(st.counts)
        self.launches = {k: dict(v) for k, v in _by_grid(mc).items()}
        self.ctx.log(
            f"window: raw scans {self.setup_end}-{i}, {self.scans} "
            f"accepted, {self.nodes[-1] if self.nodes else 0} nodes, "
            f"{self.stats_n.get('decay_evals', 0)} decays "
            f"{self.stats_s.get('decay', 0.0):.3f} s, "
            f"{self.stats_n.get('decay_removed', 0)} removed, "
            f"{len(self.snaps)} snapshots {self.window_snap_s:.4f} s, the "
            f"runner's watch {self.window_watch_s:.4f} s; "
            f"{stale_edges(self.snaps)} "
            f"edges to removed nodes in the snapshots")

    def finish(self) -> None:
        """Flush the session (for the check), keep its survivors and
        close it."""
        sess = self.sess
        sess.flush()
        self.survivors = {s.unique_id: np.array(s.corrected_pose)
                          for s in sess.mapper.all_processed_scans()}
        sess.close()
        self.sess = None

    def record(self) -> dict:
        ok = self.bag.ranges[self.setup_end:self.raw_end]
        beams = float(np.sum(
            np.isfinite(ok) & (ok >= self.laser.min_range)
            & (ok <= self.laser.range_threshold), axis=1).mean()) if len(
            ok) else 0.0
        return dict(window_s=self.t1 - self.t0, scans=self.scans,
                    drain_s=list(self.drain_s), stats_s=self.stats_s,
                    stats_self_s=self.stats_self_s, stats_n=self.stats_n,
                    launches=self.launches,
                    geometries=_geometries(self.mapper,
                                           self.laser.range_threshold),
                    beams=beams, watch_s=self.window_watch_s,
                    snapshot_s=self.window_snap_s,
                    snapshots=len(self.snaps), t0=self.t0, t1=self.t1)

    def attempted(self):
        return self.scans, self._unreturned()

    def _unreturned(self) -> int:
        removed = set(self.removed)
        want = set(range(len(self.accepted))) - removed
        have = set(self.survivors)
        bad = sum(1 for p in self.survivors.values()
                  if not np.all(np.isfinite(p)))
        return (self.bad_returns + bad + len(want ^ have)
                + len(removed & have) + self.order_faults)

    def _ate_ratio(self) -> float:
        ids = sorted(u for u in self.survivors if u < len(self.accepted))
        if not ids:
            return math.inf
        raw = np.asarray(self.accepted)[ids]
        est = np.stack([self.survivors[u] for u in ids])
        ate = fit.ate_rmse(est, self.bag.truth[raw])
        odo = fit.ate_rmse(self.bag.odom[raw], self.bag.truth[raw])
        return ate / odo if odo > 0 else math.inf

    def _growth(self) -> float:
        """Nodes a raw scan over the window's second half: the slope of
        the node count after each call, fitted by least squares (the
        count swings by tens of nodes within a lap as the robot passes
        covered and uncovered ground, so a difference of two counts
        reads that swing)."""
        half = np.asarray(self.nodes[len(self.nodes) // 2:], np.float64)
        if len(half) < 2:
            return math.inf
        return float(np.polyfit(np.arange(len(half)), half, 1)[0])

    def check(self, device, control: bool = False) -> dict:
        """{name: (value, limit)}; a value above its limit fails."""
        import torch

        lim = self.checks
        out = {"unreturned": (self._unreturned(), lim["unreturned"]),
               "ate_ratio": (self._ate_ratio(), lim["ate_ratio"]),
               "growth": (self._growth(), lim["growth"])}
        differ, gap = self.decay_check(torch.bfloat16 if control else None)
        out["decay_decisions_differ"] = (differ,
                                         lim["decay_decisions_differ"])
        out["decay_score_gap"] = (gap, lim["decay_score_gap"])
        worst, gaps = self.fit_gaps(device, torch.bfloat16 if control
                                    else None)
        p95 = float(np.percentile(gaps, 95)) if gaps else math.inf
        out["fit_gap"] = (p95, lim["fit_gap"])
        if gaps:
            n = len(self.nodes)
            self.ctx.log(
                f"fit gaps: median {float(np.median(gaps))}, p95 {p95}, "
                f"max {worst}; nodes at the window's half and end "
                f"{self.nodes[n // 2]}, {self.nodes[-1]}")
        return out

    def decay_check(self, control=None) -> tuple:
        """(evaluations whose decisions differ, the widest score gap)
        over the snapshots, the program's against ref/decay.py in
        float64; with `control` (a dtype), the reference in that
        precision in the program's place. No snapshot: (1, inf)."""
        import torch

        if not self.snaps:
            return 1, math.inf
        cfg = self.mapper
        args = (self.laser, self.lifelong, cfg["scan_buffer_size"],
                cfg["loop_match_minimum_chain_size"],
                bool(cfg.get("marginalize_on_removal", False)))
        raw = np.asarray(self.accepted)
        differ, gap = 0, 0.0
        for snap, prog in self.snaps:
            snap = dict(snap, ranges=self.bag.ranges[raw[snap["uid"]]])
            ref = decay.evaluate(snap, *args, dtype=torch.float64)
            if control is not None:
                prog = decay.evaluate(snap, *args, dtype=control)
            d, g = decay.compare(prog, ref)
            differ += d
            gap = max(gap, g)
        return differ, gap

    def sample(self) -> list:
        """Scan ids accepted in the window, drawn from the seed among
        those whose commit poses were kept."""
        buf = self.mapper["scan_buffer_size"]
        pool = sorted(u for u in self.blocks
                      if len(self.blocks[u]) == buf + 1)
        if not pool:
            return []
        rng = np.random.default_rng(_seed(self.ctx.seed, 7))
        pick = rng.choice(len(pool), size=min(SAMPLE, len(pool)),
                          replace=False)
        return [pool[j] for j in sorted(pick)]

    def fit_gaps(self, device, control=None):
        """The widest response gap of the sampled scans' commit poses
        against their buffers, and each gap; `control` (a dtype) judges
        instead the poses the reference in that precision gives them."""
        import torch

        buf = self.mapper["scan_buffer_size"]
        sigma = self.mapper["correlation_search_space_smear_deviation"]
        raw = np.asarray(self.accepted)
        gaps = []
        for u in self.sample():
            ids = raw[u - buf:u + 1]
            pts = fit.scan_points(self.bag.ranges[ids], self.laser)
            poses = self.blocks[u]
            if control is not None:
                poses = poses.copy()
                poses[buf] = fit.control_pose(pts, self.blocks[u],
                                              self.bag.odom[ids], buf, buf,
                                              self.laser, sigma, device,
                                              control)
            gaps.append(fit.gap(pts, poses, buf, buf, self.laser, sigma,
                                device, torch.float32))
        return (max(gaps) if gaps else math.inf), gaps


RUNNER = Lifelong
