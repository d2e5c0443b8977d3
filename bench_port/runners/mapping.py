"""Offline mapping of simulated bags through SlamSession's streaming path.

Set-up simulates the mix's `bags` bags and one more bag from another
seed, then maps that one whole, which builds every kernel, captures the
step graph and the verify and chain programs of the buckets a bag meets,
and warms the allocator. The window feeds the bags back to back, closed
loop, in turn and again from the first once all are fed: each bag fed is
a new SlamSession, fed scan by scan, flushed and closed; the window ends
after the call that crosses its length. The bag it cuts is flushed after
the window, for the check only.

The check (ref/fit.py): every accepted scan of every bag has a finite
pose after flush(); each bag's ATE against the simulator's true poses is
under the configuration's bar; and the poses of a sample of scans drawn
from the seed fit their running buffers as well as the plain reference
can make them (the response gap).
"""
from __future__ import annotations

import math
import time

import numpy as np

from bench_port.gen import sim, worlds
from bench_port.ref import fit

SAMPLE = 128         # scans of the window's bags the reference judges


def _seed(seed: int, *key: int) -> int:
    return int(np.random.SeedSequence([seed, *key]).generate_state(1)[0])


def _bags(mix: dict, laser, seed: int, keys, device) -> list:
    """The bags of `keys`, each from its own seed drawn from `seed`."""
    world = worlds.world(mix["world"])
    wps = worlds.route(mix["route"], mix["world"])
    return [sim.simulate(world, laser, wps, mix["step"], mix["range_noise"],
                         mix["odom_noise"], _seed(seed, i), device=device)
            for i in keys]


class Mapping:
    """One cell of the mapping configurations: the harness's calls are
    setup(), window(), finish(), check() and records for the metrics."""

    def __init__(self, ctx):
        self.ctx = ctx
        cfg, mix = ctx.config, ctx.mix
        self.laser = sim.Laser(**cfg["laser"])
        self.mapper = cfg["mapper"]
        self.session = cfg["session"]
        self.checks = {**cfg["checks"], **mix.get("checks", {})}
        self.spans = ctx.spans
        self.bags = []
        self.runs = []       # per bag fed: dict(bag, accepted, traj, ...)
        self.drain_s = []
        self.stats_s = {}
        self.stats_n = {}
        self.scans = 0

    # -- the program ---------------------------------------------------
    def _port(self):
        from slam_toolbox_tpu_torch.api import SlamSession
        from slam_toolbox_tpu_torch.core.params import MapperConfig
        from slam_toolbox_tpu_torch.core.scan import LaserConfig

        return SlamSession, MapperConfig(**self.mapper), LaserConfig(
            **self.ctx.config["laser"])

    def _feed(self, bag, deadline=None, record=True):
        """Feed `bag` to a new session; returns its run record. Stops
        after the call that passes `deadline` (the bag is then cut)."""
        session_cls, mcfg, laser = self._cls
        spans = self.spans if record else None
        t = time.perf_counter()
        sess = session_cls(mcfg, laser, streaming=True,
                           drain_every=self.session["drain_every"],
                           device=self.ctx.device)
        sess.stats.enabled = True
        counts = sess.stats.counts
        if spans:
            spans.add("new session", t, time.perf_counter())
        accepted, cut = [], False
        for i in range(len(bag)):
            n0 = counts.get("batch_dispatch", 0)
            t0 = time.perf_counter()
            out = sess.process_scan(bag.ranges[i], bag.odom[i],
                                    time=0.1 * i)
            t1 = time.perf_counter()
            drained = counts.get("batch_dispatch", 0) != n0
            if record:
                spans.add("drain call" if drained else "scan call", t0, t1)
                if drained:
                    self.drain_s.append(t1 - t0)
            if out is not None:
                accepted.append(i)
            if deadline is not None and t1 >= deadline:
                cut = True
                break
        run = dict(bag=bag, accepted=accepted, cut=cut, sess=sess, t0=t)
        if not cut:
            self._finish_bag(run, record)
        elif record:
            self._add_stats(sess)
        return run

    def _add_stats(self, sess) -> None:
        for k, v in sess.stats.seconds.items():
            self.stats_s[k] = self.stats_s.get(k, 0.0) + v
        for k, v in sess.stats.counts.items():
            self.stats_n[k] = self.stats_n.get(k, 0) + v

    def _finish_bag(self, run, record):
        sess = run["sess"]
        if record:
            st = sess.stats
            self.ctx.log(
                f"bag: {len(run['accepted'])} scans in "
                f"{time.perf_counter() - run['t0']:.3f} s, "
                f"{st.counts.get('batch_dispatch', 0)} drains, "
                f"{st.counts.get('solve', 0)} solves "
                f"{st.seconds.get('solve', 0.0):.3f} s, commit_bookkeep "
                f"{st.seconds.get('commit_bookkeep', 0.0):.3f} s")
        counts = sess.stats.counts
        n0 = counts.get("batch_dispatch", 0)
        t0 = time.perf_counter()
        sess.flush()
        t1 = time.perf_counter()
        if record:
            self.spans.add("flush", t0, t1)
            if counts.get("batch_dispatch", 0) != n0:
                self.drain_s.append(t1 - t0)
            self._add_stats(sess)
        run["traj"] = np.array(sess.trajectory, dtype=np.float64)
        t2 = time.perf_counter()
        sess.close()
        run["sess"] = None
        if record:
            self.spans.add("close", t2, time.perf_counter())

    # -- the harness's calls ---------------------------------------------
    def setup(self, seconds: float) -> None:
        """Simulate the bags, build the kernels and map one whole bag."""
        import torch

        dev = self.ctx.device
        gen_dev = dev if torch.device(dev).type == "cuda" else None
        t0 = time.perf_counter()
        self.bags = _bags(self.ctx.mix, self.laser, self.ctx.seed,
                          range(self.ctx.mix["bags"]), gen_dev)
        warm = _bags(self.ctx.mix, self.laser, self.ctx.seed,
                     [1 << 30], gen_dev)[0]
        t1 = time.perf_counter()
        if torch.device(dev).type == "cuda":
            from slam_toolbox_tpu_torch.kernels import match_cuda as mc

            mc.build_kernels()
        self._cls = self._port()
        t2 = time.perf_counter()
        self._feed(warm, record=False)
        self.ctx.log(f"set-up: {len(self.bags) + 1} bags of "
                     f"{len(self.bags[0])} scans "
                     f"simulated in {t1 - t0:.3f} s, kernels {t2 - t1:.3f} "
                     f"s, the warm bag mapped in "
                     f"{time.perf_counter() - t2:.3f} s")

    def window(self, seconds: float) -> None:
        from slam_toolbox_tpu_torch.kernels import match_cuda as mc

        mc.reset_launch_counts()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        i = 0
        while True:
            run = self._feed(self.bags[i % len(self.bags)], deadline)
            self.runs.append(run)
            self.scans += len(run["accepted"])
            i += 1
            if run["cut"] or time.perf_counter() >= deadline:
                break
        self.t0, self.t1 = t0, time.perf_counter()
        self.launches = {k: dict(v) for k, v in _by_grid(mc).items()}

    def finish(self) -> None:
        """Flush the cut bag (for the check) and free the sessions."""
        for run in self.runs:
            if run.get("sess") is not None:
                self._finish_bag(run, record=False)

    def record(self) -> dict:
        geoms = _geometries(self.mapper, self.laser.range_threshold)
        beams = float(np.mean([np.sum(
            np.isfinite(b.ranges) & (b.ranges >= self.laser.min_range)
            & (b.ranges <= self.laser.range_threshold), axis=1).mean()
            for b in {id(r["bag"]): r["bag"] for r in self.runs}.values()]))
        return dict(window_s=self.t1 - self.t0, scans=self.scans,
                    drain_s=list(self.drain_s), stats_s=dict(self.stats_s),
                    stats_n=dict(self.stats_n), launches=self.launches,
                    geometries=geoms, beams=beams, t0=self.t0, t1=self.t1)

    def attempted(self):
        att = sum(len(r["accepted"]) for r in self.runs)
        return att, self._unreturned()

    def _unreturned(self) -> int:
        bad = 0
        for r in self.runs:
            traj = r.get("traj")
            n = len(r["accepted"])
            if traj is None or len(traj) != n:
                bad += n if traj is None else abs(n - len(traj))
            else:
                bad += int(np.sum(~np.isfinite(traj).all(axis=1)))
        return bad

    def sample(self):
        """(run index, scan index in its accepted list) pairs drawn from
        the seed among the scans with a full buffer."""
        buf = self.mapper["scan_buffer_size"]
        pool = [(ri, k) for ri, r in enumerate(self.runs)
                for k in range(buf, len(r["accepted"]))]
        if not pool:
            return []
        rng = np.random.default_rng(_seed(self.ctx.seed, 7))
        pick = rng.choice(len(pool), size=min(SAMPLE, len(pool)),
                          replace=False)
        return [pool[j] for j in sorted(pick)]

    def check(self, device, control: bool = False) -> dict:
        """{name: (value, limit)}; a value above its limit fails. With
        `control`, the response gap judges instead the control in the
        program's place: the reference in bfloat16, the precision below
        the configuration's float32, at the sampled scans."""
        import torch

        out = {"unreturned": (self._unreturned(),
                              self.checks["unreturned"])}
        if "ate_rmse_m" in self.checks:
            ate = 0.0
            for r in self.runs:
                traj, acc = r.get("traj"), r["accepted"]
                if traj is not None and len(traj) == len(acc) and len(acc):
                    ate = max(ate, fit.ate_rmse(traj, r["bag"].truth[acc]))
            out["ate_rmse_m"] = (ate, self.checks["ate_rmse_m"])
        gap = self.fit_gaps(device, torch.bfloat16 if control else None)[0]
        out["fit_gap"] = (gap, self.checks["fit_gap"])
        return out

    def fit_gaps(self, device, control=None):
        """The widest response gap of the sampled scans' poses, and each
        gap. `control` (a dtype) judges instead the poses the reference
        in that precision gives those scans in the program's place."""
        import torch

        buf = self.mapper["scan_buffer_size"]
        sigma = self.mapper["correlation_search_space_smear_deviation"]
        gaps, pts, last = [], None, None
        for ri, k in self.sample():
            r = self.runs[ri]
            traj = r.get("traj")
            if traj is None or len(traj) != len(r["accepted"]):
                return math.inf, []
            if ri != last:      # the sample is in run order
                pts, last = fit.scan_points(
                    r["bag"].ranges[r["accepted"]], self.laser), ri
            poses = traj
            if control is not None:
                odom = r["bag"].odom[r["accepted"]]
                poses = traj.copy()
                poses[k] = fit.control_pose(pts, traj, odom, k, buf,
                                            self.laser, sigma, device,
                                            control)
            gaps.append(fit.gap(pts, poses, k, buf, self.laser, sigma,
                                device, torch.float32))
        return (max(gaps) if gaps else math.inf), gaps


def _by_grid(mc) -> dict:
    out = {}
    for (name, G), n in sorted(mc.GRID_LAUNCHES.items()):
        out.setdefault(name, {})[int(G)] = n
    return out


def _geometries(mapper: dict, range_threshold: float) -> dict:
    from bench_port.gen import roofline

    return roofline.mapper_geometries(mapper, range_threshold)


RUNNER = Mapping
