"""The multi-session merge's joint pose-graph solve, repeated.

Set-up makes the joint graph from the seed (gen/merge_graph.py) and runs
one solve, which captures the CG loop's programs. The window runs
distributed_lm_solve on a mesh of one back to back from the same initial
poses, closed loop; the solve the window's end cuts is finished and
counted as the fraction of it that lay inside the window.

The check (ref/lm.py): the plain float64 LM with exact sparse solves
takes the same LM steps from the same poses; every solve's poses are
held to it (the widest xy distance and heading gap over the nodes).
chi2 is not compared: the program returns float32 poses, whose rounding
at the merged map's 4.9 km of extent alone moves chi2 by tens of
percent.
"""
from __future__ import annotations

import math
import time

import numpy as np

from bench_port.gen import merge_graph
from bench_port.ref import lm

ARGS = ("poses", "src", "dst", "rel", "sqrt_info", "emask", "free")


class JointSolve:
    def __init__(self, ctx):
        self.ctx = ctx
        cfg = ctx.config
        self.graph_cfg = cfg["graph"]
        self.solve_cfg = cfg["solve"]
        self.checks = {**cfg["checks"], **ctx.mix.get("checks", {})}
        self.spans = ctx.spans
        self.outs = []          # (poses, chi2) of each solve in the window
        self.cg = []

    def _solve(self):
        from slam_toolbox_tpu_torch.dist.solver_dist import (
            distributed_lm_solve,
        )

        s = self.solve_cfg
        out, chi2 = distributed_lm_solve(
            self.mesh, *self.args, max_iterations=s["lm_steps"],
            cg_iters=s["cg_iters"], block=s["block"],
            dtype=np.dtype(s["dtype"]))
        return out, float(chi2), list(distributed_lm_solve.last_cg_iters)

    def setup(self, seconds: float) -> None:
        import torch

        from slam_toolbox_tpu_torch.dist import multihost

        g = self.graph_cfg
        t0 = time.perf_counter()
        self.g = merge_graph.joint_graph(g["sessions"], g["nodes_per"],
                                         self.ctx.seed)
        self.args = tuple(self.g[k] for k in ARGS)
        t1 = time.perf_counter()
        if torch.device(self.ctx.device).type == "cuda":
            from slam_toolbox_tpu_torch.kernels import match_cuda as mc

            mc.build_kernels()
        self.mesh = multihost.global_mesh(self.ctx.device)
        t2 = time.perf_counter()
        self._solve()
        self.ctx.log(f"set-up: graph of {self.g['n']} nodes in "
                     f"{t1 - t0:.3f} s, kernels {t2 - t1:.3f} s, the first "
                     f"solve {time.perf_counter() - t2:.3f} s")

    def window(self, seconds: float) -> None:
        t0 = time.perf_counter()
        deadline = t0 + seconds
        done = 0.0
        while True:
            ts = time.perf_counter()
            out, chi2, cg = self._solve()
            te = time.perf_counter()
            self.spans.add("solve", ts, te)
            self.ctx.log(f"solve: {te - ts:.3f} s, CG {cg}")
            self.outs.append((out, chi2))
            self.cg.append(cg)
            if te >= deadline:
                done += (deadline - ts) / (te - ts)
                break
            done += 1.0
        self.t0, self.t1, self.solves = t0, deadline, done

    def finish(self) -> None:
        pass

    def record(self) -> dict:
        s = self.solve_cfg
        return dict(window_s=self.t1 - self.t0, solves=self.solves,
                    cg_iters=[sum(c) for c in self.cg],
                    lm_steps=[len(c) for c in self.cg],
                    n_pad=self.g["n_pad"], n_edges=len(self.g["src"]),
                    block=s["block"], t0=self.t0, t1=self.t1)

    def attempted(self):
        bad = sum(1 for out, chi2 in self.outs
                  if not (np.isfinite(out).all() and math.isfinite(chi2)))
        return len(self.outs), bad

    def reference(self, products=None):
        g, s = self.g, self.solve_cfg
        return lm.lm_solve(g["poses"], g["src"], g["dst"], g["rel"],
                           g["sqrt_info"], g["free"], s["lm_steps"],
                           products=products)

    def gaps(self, outs, ref) -> dict:
        """The widest gaps over the nodes of the solves `outs` [(poses,
        chi2)] against the reference's poses: xy distance (m), the same
        beyond one float32 spacing of the node's coordinates (the
        program returns float32 poses), heading (rad)."""
        n = self.g["n"]
        ref_p = ref[0][:n]
        spacing = np.spacing(np.abs(ref_p[:, :2]).max(axis=1)
                             .astype(np.float32)).astype(np.float64)
        out_g = {"pose_gap_m": 0.0, "pose_excess_m": 0.0,
                 "heading_gap_rad": 0.0}
        for out, chi2 in outs:
            out = np.asarray(out, np.float64)[:n]
            if not (np.isfinite(out).all() and math.isfinite(chi2)):
                return {k: math.inf for k in out_g}
            xy = np.hypot(*(out[:, :2] - ref_p[:, :2]).T)
            d = out[:, 2] - ref_p[:, 2]
            for k, v in (("pose_gap_m", xy.max()),
                         ("pose_excess_m", np.maximum(xy - spacing, 0).max()),
                         ("heading_gap_rad", np.abs(np.arctan2(
                             np.sin(d), np.cos(d))).max())):
                out_g[k] = max(out_g[k], float(v))
        return out_g

    def check(self, device, control: bool = False) -> dict:
        """{name: (value, limit)}; a value above its limit fails. With
        `control`, the gaps judge instead the control in the program's
        place: the reference with its products, factors and solves
        rounded to TF32, the precision below the configuration's float32,
        its poses returned in float32 as the program's are."""
        ref = self.reference()
        outs = self.outs
        if control:
            ctl, chi2 = self.reference("tf32")
            outs = [(np.asarray(ctl, np.float32), chi2)]
        got = self.gaps(outs, ref)
        return {k: (got[k], self.checks[k]) for k in self.checks}


RUNNER = JointSolve
