"""SE(2) pose-graph optimizer: Levenberg-Marquardt on the SE(2) residual.

PyTorch counterpart of slam_toolbox_tpu/solver/se2_solver.py, the
replacement for the Ceres plugin (solvers/ceres_solver.cpp of
slam_toolbox). The measurement model matches PoseGraph2dErrorTerm
(ceres_utils.h:74-121):

    r = sqrt_info · [ R(yaw_a)^T (p_b - p_a) - p_ab ;
                      normalize(yaw_b - yaw_a - yaw_ab) ]

with sqrt_information the upper-triangular Cholesky factor of the inverse
edge covariance (ceres_solver.cpp:364-376), and the first node held constant
as the gauge (ceres_solver.cpp:228-241). The API mirrors the abstract
ScanSolver interface (Mapper.h:954-1066): AddNode / AddConstraint /
RemoveNode / RemoveConstraint / Compute / GetCorrections / ModifyNode /
Clear / Reset / GetGraph.

Tiers: the native host block-sparse Cholesky (host_sparse_lm,
native/graph_ops.cpp; the default, since host_sparse_min_nodes = 0); the
LM loop (lm_solve) in f32 on the solver's device, with a dense Cholesky
step up to DENSE_MAX_NODES and past it a PCG step preconditioned by the
odometry chain (solver/chain_precond.py: parallel cyclic reduction from
4,096 padded nodes, the block Thomas sweeps below), on a card its LM and
CG loops CUDA-graph WHILE nodes with one host read a solve; and, when a process
group of more than one rank is up and the graph has dist_edge_threshold
edges, the edge-sharded distributed solve (dist/solver_dist.py), which
every rank runs in lockstep on the same graph.
"""
from __future__ import annotations

import functools
import math
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from slam_toolbox_tpu_torch.device import resolve_device, world_size
from slam_toolbox_tpu_torch.kernels import match_cuda as mc
from slam_toolbox_tpu_torch.solver import chain_precond as cp
from slam_toolbox_tpu_torch.utils.metrics import count, stage_timer

_F32 = torch.float32


def _pad_pow2(n: int, floor: int = 16) -> int:
    p = floor
    while p < n:
        p <<= 1
    return p


def edge_residual(poses, src, dst, rel, sqrt_info, emask=None):
    """Whitened residuals (E,3) for all edges; rows where `emask` is False
    are zero."""
    pa = poses[src]  # (E,3)
    pb = poses[dst]
    ca, sa = torch.cos(pa[:, 2]), torch.sin(pa[:, 2])
    dx = pb[:, 0] - pa[:, 0]
    dy = pb[:, 1] - pa[:, 1]
    rx = ca * dx + sa * dy - rel[:, 0]
    ry = -sa * dx + ca * dy - rel[:, 1]
    dth = pb[:, 2] - pa[:, 2] - rel[:, 2]
    rth = torch.atan2(torch.sin(dth), torch.cos(dth))
    r = torch.stack([rx, ry, rth], dim=-1)
    r = torch.einsum("eij,ej->ei", sqrt_info, r)
    if emask is None:
        return r
    return torch.where(emask[:, None], r, 0.0)


def edge_jacobians(poses, src, dst, sqrt_info, emask=None):
    """Whitened Jacobian blocks (E,3,3) wrt pose a and pose b; blocks
    where `emask` is False are zero."""
    pa = poses[src]
    pb = poses[dst]
    ca, sa = torch.cos(pa[:, 2]), torch.sin(pa[:, 2])
    dx = pb[:, 0] - pa[:, 0]
    dy = pb[:, 1] - pa[:, 1]
    z = torch.zeros_like(ca)
    o = torch.ones_like(ca)
    # d r_xy / d theta_a : derivative of R(ha)^T applied to (pb-pa)
    dr_xy_dha_x = -sa * dx + ca * dy
    dr_xy_dha_y = -ca * dx - sa * dy
    ja = torch.stack(
        [
            torch.stack([-ca, -sa, dr_xy_dha_x], -1),
            torch.stack([sa, -ca, dr_xy_dha_y], -1),
            torch.stack([z, z, -o], -1),
        ],
        dim=-2,
    )  # (E,3,3)
    jb = torch.stack(
        [
            torch.stack([ca, sa, z], -1),
            torch.stack([-sa, ca, z], -1),
            torch.stack([z, z, o], -1),
        ],
        dim=-2,
    )
    ja = torch.einsum("eij,ejk->eik", sqrt_info, ja)
    jb = torch.einsum("eij,ejk->eik", sqrt_info, jb)
    if emask is None:
        return ja, jb
    m = emask[:, None, None]
    return torch.where(m, ja, 0.0), torch.where(m, jb, 0.0)


def build_normal_blocks(poses, src, dst, rel, sqrt_info):
    """Gauss-Newton normal equation pieces:
    diag blocks (N,3,3), per-edge off-diagonal blocks (E,3,3) = Ja^T Jb,
    gradient b = -J^T r (N,3), chi2."""
    n = poses.shape[0]
    r = edge_residual(poses, src, dst, rel, sqrt_info)
    ja, jb = edge_jacobians(poses, src, dst, sqrt_info)
    haa = torch.einsum("eji,ejk->eik", ja, ja)
    hbb = torch.einsum("eji,ejk->eik", jb, jb)
    hab = torch.einsum("eji,ejk->eik", ja, jb)
    diag = poses.new_zeros((n, 3, 3))
    cp.scatter_add(diag, src, haa)
    cp.scatter_add(diag, dst, hbb)
    grad = poses.new_zeros((n, 3))
    cp.scatter_add(grad, src, -torch.einsum("eji,ej->ei", ja, r))
    cp.scatter_add(grad, dst, -torch.einsum("eji,ej->ei", jb, r))
    chi2 = torch.sum(r * r)
    return diag, hab, grad, chi2


def chi2_only(poses, src, dst, rel, sqrt_info, emask=None):
    r = edge_residual(poses, src, dst, rel, sqrt_info, emask)
    return torch.sum(r * r)


def _hx(x, diag_damped, hab, src, dst, free):
    """H @ x with the gauge row/col projected out."""
    x = x * free[:, None]
    out = torch.einsum("nij,nj->ni", diag_damped, x)
    cp.scatter_add(out, src, torch.einsum("eij,ej->ei", hab, x[dst]))
    cp.scatter_add(out, dst, torch.einsum("eji,ej->ei", hab, x[src]))
    return out * free[:, None]


def _damped(diag, lam):
    eye = torch.eye(3, dtype=diag.dtype, device=diag.device)
    damp = lam * torch.einsum("nii->n", diag)[:, None, None] * eye / 3.0
    return diag + damp + 1e-8 * eye


# CG iterations per chunk, the CG loop's body. It divides 64 and 32, the
# restart periods of lm_solve's PCG step and the distributed solve, so
# while the loop runs a restart falls at the last iteration of a chunk
CG_CHUNK = 8
# CGLoop of solve_pcg and of the distributed solve per route, cg_iters and
# its inputs' shapes, dtypes and devices (lm_solve's is its LMLoop's)
_CG_LOOPS: Dict[tuple, "CGLoop"] = {}


def _host_read(t):
    """t's value on the host: the one way the CG and LM loops read the
    device (a sync)."""
    return t.tolist()


def _pick(cond, a, b):
    """a() where `cond`, else b(): `cond` a Python bool (only that branch
    runs) or a bool tensor (both run, selected elementwise)."""
    if cond is True:
        return a()
    if cond is False:
        return b()
    return torch.where(cond, a(), b())


class CGLoop:
    """Preconditioned CG on static buffers in chunks of CG_CHUNK masked
    iterations, the counterpart of the JAX package's lax.while_loop.

    `inputs` are the loop's per-solve tensors: the right-hand side `b`,
    the stop threshold `stop` on r·r, and what `ops(buffers)` reads; `ops`
    returns (mv, prec) built on the buffers: copies of `inputs`' shapes
    that run() fills (LMLoop's head fills them with _load). The init sets x = 0, r = b - mv(x), p = prec(r), rz = r·p,
    i = 0 and `status`; each chunk runs CG_CHUNK iterations, each
    computing `active = (i < cg_iters) & (r·r > stop)` (and rz > 0 under
    `stall`) on the device and keeping the old state where it is False,
    and writes (i, active) to `status`. Inactivity is absorbing, so while
    the loop runs iteration j of chunk c is iteration c·CG_CHUNK + j, and
    the true-residual restart every `period` iterations (r = b - mv(x),
    p = z) falls at the last iteration of a chunk. Under `stall` the
    restart is the distributed solve's stagnation probe: i jumps to
    cg_iters when a period bought less than a 2x reduction of r·r.

    Two routes. With `device_loop` (se2_solver's loops) a chunk chooses
    its restart on the device, (i % period) == period - 1, so one body
    serves every chunk: on a card run() is one match_cuda.WhileProgram
    (K10: the init, then a WHILE node on status[1] around the chunk) and
    one host read of (i, chunks) at its end; on the CPU the same two
    functions run from a Python loop that reads status[1] before each
    chunk. Without it (the distributed solve, whose NCCL calls may not sit
    in a conditional body) run() replays the init and a program per
    restart position (match_cuda.StatefulProgram, CUDA graphs on a card),
    reading status once per chunk. run_eager() runs that second route's
    functions eagerly on any device: the reference both are held to bit
    for bit."""

    def __init__(self, inputs: dict, ops, cg_iters: int, period=None,
                 stall: bool = False, device_loop: bool = False):
        if period is not None and period % CG_CHUNK:
            raise ValueError(f"chunk {CG_CHUNK} does not divide period "
                             f"{period}")
        self.inp = {name: torch.empty_like(v) for name, v in inputs.items()}
        self.mv, self.prec = ops(self.inp)
        b = self.inp["b"]
        i64 = dict(dtype=torch.int64, device=b.device)
        self.state = dict(
            i=torch.zeros((), **i64), x=torch.zeros_like(b),
            r=torch.zeros_like(b), p=torch.zeros_like(b), rz=b.new_zeros(()),
            status=torch.zeros(2, **i64), chunks=torch.zeros((), **i64))
        if stall:
            self.state["rr_ckpt"] = b.new_zeros(())
        self.cg_iters, self.period, self.stall = cg_iters, period, stall
        self.device_loop = device_loop
        self.fns = (self._init, lambda st: self._chunk(st, False),
                    lambda st: self._chunk(st, True))
        # the device loop's two functions, one object each (WhileProgram
        # keys its tallies by them)
        self.init_fn = functools.partial(self._init, self.state)
        self.body_fn = functools.partial(self._chunk, self.state, None)
        # 0, 1, 2: indices into fns -> StatefulProgram; "while":
        # WhileProgram; on a card
        self.programs = {}
        self.lock = threading.Lock()
        self.chunks = 0      # chunks the last run ran

    def _init(self, st):
        b = self.inp["b"]
        x = torch.zeros_like(b)
        r = b - self.mv(x)
        p = self.prec(r)
        st["x"].copy_(x)
        st["r"].copy_(r)
        st["p"].copy_(p)
        st["rz"].copy_(torch.sum(r * p))
        st["i"].zero_()
        st["chunks"].zero_()
        if self.stall:
            st["rr_ckpt"].copy_(torch.sum(r * r))
        st["status"].copy_(torch.stack([
            st["i"], self._active(st["i"], st["r"], st["rz"]).to(
                torch.int64)]))

    def _active(self, i, r, rz):
        act = (i < self.cg_iters) & (torch.sum(r * r) > self.inp["stop"])
        return act & (rz > 0) if self.stall else act

    def _chunk(self, st, restart_last):
        """One chunk; its last iteration restarts if `restart_last` is
        True, never if False, and where (i % period) == period - 1 if
        None (chosen on the device)."""
        mv, prec, b = self.mv, self.prec, self.inp["b"]
        i, x, r, p, rz = (st[name] for name in ("i", "x", "r", "p", "rz"))
        ckpt = st.get("rr_ckpt")
        for j in range(CG_CHUNK):
            act = self._active(i, r, rz)
            hp = mv(p)
            alpha = rz / torch.clamp_min(torch.sum(p * hp), 1e-30)
            x_n = x + alpha * p
            restart = False
            if j == CG_CHUNK - 1 and self.period is not None:
                restart = ((i % self.period) == self.period - 1
                           if restart_last is None else restart_last)
            r_n = _pick(restart, lambda: b - mv(x_n), lambda: r - alpha * hp)
            i_n = i + 1
            if self.stall and restart is not False:
                rr = torch.sum(r_n * r_n)
                jump, probe = rr > 0.25 * ckpt, act
                if restart is not True:
                    jump, probe = jump & restart, act & restart
                i_n = torch.where(jump, self.cg_iters, i_n)
                ckpt = torch.where(probe, rr, ckpt)
            z = prec(r_n)
            rz_n = torch.sum(r_n * z)
            p_n = _pick(restart, lambda: z,
                        lambda: z + rz_n / torch.clamp_min(rz, 1e-30) * p)
            i, x, r, p, rz = (torch.where(act, new, old) for new, old in (
                (i_n, i), (x_n, x), (r_n, r), (p_n, p), (rz_n, rz)))
        go = self._active(i, r, rz)
        for name, v in (("i", i), ("x", x), ("r", r), ("p", p), ("rz", rz)):
            st[name].copy_(v)
        if ckpt is not None:
            st["rr_ckpt"].copy_(ckpt)
        st["chunks"].add_(1)
        st["status"].copy_(torch.stack([i, go.to(torch.int64)]))

    def _program(self, idx: int):
        prog = self.programs.get(idx)
        if prog is None:
            prog = self.programs[idx] = mc.StatefulProgram(self.fns[idx],
                                                           self.state)
        return prog

    def _load(self, inputs):
        for name, v in inputs.items():
            self.inp[name].copy_(v)

    def _drive(self, inputs, step):
        self._load(inputs)
        step(0)
        c = 0
        while True:
            c += 1
            last = (self.period is not None
                    and c * CG_CHUNK % self.period == 0)
            step(2 if last else 1)
            i, go = _host_read(self.state["status"])
            if not go:
                self.chunks = c
                return self.state["x"].clone(), i

    def plan(self) -> list:
        """The device loop as a WhileProgram plan."""
        return [self.init_fn,
                ("while", self.state["status"][1:], [self.body_fn])]

    def _run_device_loop(self, inputs):
        self._load(inputs)
        st = self.state
        prog = None
        if mc._on_cuda(st["x"].device):
            prog = self.programs.get("while")
            if prog is None:
                prog = self.programs["while"] = mc.WhileProgram(
                    self.plan(), st["x"].device)
            prog.launch()
        else:
            self.init_fn()
            while _host_read(st["status"][1]):
                self.body_fn()
        i, self.chunks = _host_read(torch.stack([st["i"], st["chunks"]]))
        if prog is not None:
            mc.count_replay(prog.tally[self.init_fn])
            mc.count_replay(prog.tally[self.body_fn], self.chunks)
        return st["x"].clone(), i

    def run(self, inputs):
        """(x, CG iterations) on `inputs` by the loop's route; x is a
        copy."""
        with self.lock:
            if self.device_loop:
                return self._run_device_loop(inputs)
            return self._drive(inputs, lambda idx: self._program(idx).run())

    def run_eager(self, inputs):
        """The chunked route's functions launched eagerly: the
        reference."""
        with self.lock:
            return self._drive(inputs, lambda idx: self.fns[idx](self.state))


def cg_loop(route: tuple, inputs: dict, ops, cg_iters: int,
            **kw) -> CGLoop:
    """The CGLoop of `route` (which must fix what `ops` closes over
    besides its buffers) for inputs of these shapes, dtypes and devices,
    made at first use and kept for the process."""
    key = (route, cg_iters, tuple(sorted(
        (name, tuple(v.shape), v.dtype, str(v.device))
        for name, v in inputs.items())))
    with mc.capture_lock:
        loop = _CG_LOOPS.get(key)
        if loop is None:
            loop = _CG_LOOPS[key] = CGLoop(inputs, ops, cg_iters, **kw)
    return loop


def _mv_of(t):
    def mv(x):
        return _hx(x, t["diag_d"], t["hab"], t["src"], t["dst"], t["free"])

    return mv


def solve_pcg(diag, hab, grad, src, dst, free, lm_lambda, cg_iters: int,
              cg_tol):
    """Block-Jacobi preconditioned CG on (H + λ·diagH) x = b, as a CGLoop
    on the device loop (one host read a solve on a card), left in
    solve_pcg.last_loop."""
    eye = torch.eye(3, dtype=diag.dtype, device=diag.device)
    diag_d = _damped(diag, lm_lambda)
    b = grad * free[:, None]
    inputs = dict(
        diag_d=diag_d, hab=hab, src=src, dst=dst, free=free, b=b,
        stop=cg_tol * torch.clamp_min(torch.sum(b * b), 1e-30),
        # preconditioner: inverse of damped diagonal blocks
        minv=torch.linalg.inv(diag_d + 1e-6 * eye))

    def ops(t):
        def prec(r):
            return torch.einsum("nij,nj->ni", t["minv"], r) * t["free"][:, None]

        return _mv_of(t), prec

    loop = solve_pcg.last_loop = cg_loop(("jacobi",), inputs, ops, cg_iters,
                                         device_loop=True)
    return loop.run(inputs)[0]


def _pcg_ops(n: int):
    """(route, ops) of the PCG step's CG at n nodes: the odometry chain's
    preconditioner by parallel cyclic reduction from 4,096 nodes, else by
    the block Thomas sweeps (K9)."""
    if n >= 4096:
        steps = int(math.ceil(math.log2(n))) + 1

        def ops(t):
            def prec(r):
                return cp.pcr_solve(t["diag_d"], t["U"], r, t["free"], steps)

            return _mv_of(t), prec

        return ("pcr", steps), ops

    def ops(t):
        def prec(r):
            return cp.chain_apply(t["Sinv"], t["T"], t["W"], r, t["free"])

        return _mv_of(t), prec

    return ("thomas",), ops


def _pcg_inputs(diag, hab, grad, src, dst, free, lam, cg_tol) -> dict:
    """The inputs of lm_solve's step past the dense ceiling, CG on the
    damped normal equations preconditioned by the odometry chain, which
    it solves exactly, so CG iterates only on the loop-closure coupling
    (_pcg_ops; LMLoop's CGLoop recomputes the true residual every 64
    iterations against f32 recurrence drift): the damped blocks, b, the
    stop on r·r and the chain preconditioner's U (PCR) or its
    factorization (Thomas, by K9, reused across the CG iterations)."""
    n = diag.shape[0]
    diag_d = _damped(diag, lam)
    b = grad * free[:, None]
    U = cp.build_chain_offdiag(hab, src, dst, n, free)
    inputs = dict(diag_d=diag_d, hab=hab, src=src, dst=dst, free=free, b=b,
                  stop=cg_tol * torch.clamp_min(torch.sum(b * b), 1e-30))
    if n >= 4096:
        inputs["U"] = U
    else:
        inputs.update(zip(("Sinv", "T", "W"),
                          cp.chain_factorize(diag_d, U, free)))
    return inputs


def dense_step(diag, hab, grad, src, dst, free, lam):
    """Exact damped-normal-equations solve via dense Cholesky. Where the
    factorization fails (H not positive definite, or not finite) the step
    is NaN, as the JAX package's jnp.linalg.cholesky makes it, and the LM
    loop rejects it; nothing is read back, so the step can be captured."""
    n = diag.shape[0]
    diag_d = _damped(diag, lam)
    ii = torch.arange(3, device=diag.device)
    H = diag.new_zeros((3 * n, 3 * n))
    nidx = torch.arange(n, device=diag.device)
    # block-diagonal: rows 3k+i, cols 3k+j
    cp.scatter_add(
        H, ((nidx[:, None, None] * 3 + ii[None, :, None]).expand(n, 3, 3),
            (nidx[:, None, None] * 3 + ii[None, None, :]).expand(n, 3, 3)),
        diag_d)
    e = src.shape[0]
    rs = (src[:, None, None] * 3 + ii[None, :, None]).expand(e, 3, 3)
    cd = (dst[:, None, None] * 3 + ii[None, None, :]).expand(e, 3, 3)
    rd = (dst[:, None, None] * 3 + ii[None, :, None]).expand(e, 3, 3)
    cs = (src[:, None, None] * 3 + ii[None, None, :]).expand(e, 3, 3)
    # off-diagonal blocks hab at (src, dst) and habT at (dst, src)
    cp.scatter_add(H, (rs, cd), hab)
    cp.scatter_add(H, (rd, cs), hab.transpose(1, 2))
    free3 = free.repeat_interleave(3)
    # gauge: project fixed rows/cols out, unit diagonal keeps H SPD
    H = H * free3[:, None] * free3[None, :] + torch.diag(1.0 - free3)
    b = (grad * free[:, None]).reshape(-1, 1)
    # cholesky_ex leaves its error in `info` on the device (no sync); the
    # two triangular solves are cuBLAS trsm (MAGMA's cholesky_solve
    # allocates under capture)
    L, info = torch.linalg.cholesky_ex(H, check_errors=False)
    y = torch.linalg.solve_triangular(L, b, upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)[:, 0]
    x = torch.where(info == 0, x, torch.nan)
    return (x * free3).reshape(n, 3)


# lm_solve's loop of the last bucket (tier, nodes, edges, dtype, device,
# max_iterations, cg_iters) of each tier. A loop's program keeps its
# buffers in the captured graphs' pools (the dense tier's H and its
# factor, (3n)^2 each: 151 MB each at 2,048 nodes in f32), so a tier keeps
# one loop and a new bucket closes the one it replaces
_LM_LOOPS: Dict[str, "LMLoop"] = {}


def _tier(n: int) -> str:
    """lm_solve's step at n (padded) nodes: dense Cholesky up to
    DENSE_MAX_NODES, then PCG with the chain preconditioner by the Thomas
    sweeps, from 4,096 nodes by PCR."""
    if n <= DENSE_MAX_NODES:
        return "dense"
    return "pcr" if n >= 4096 else "thomas"


class LMLoop:
    """lm_solve's Levenberg-Marquardt loop for one bucket on static
    buffers, the counterpart of the JAX package's lax.while_loop: init
    (the poses, chi2, lambda), then while (it < max_iterations) & ~done
    the head (normal blocks, damping, and the dense step, or the CG's
    inputs with K9's factorization and the CG init), the CG loop (PCG
    tiers: CGLoop's device-restart chunk while its status says so) and
    the tail (the step, chi2, accept, lambda, done). The acceptance and
    termination rules are the JAX package's.

    On a card run() is one WhileProgram (K10; the CG loop a WHILE node
    nested in the LM loop's) and one host read at the end of the poses,
    chi2, iterations and CG counts together; on the CPU, and in
    run_eager() on any device, the same functions run from a Python loop
    that reads each loop's flag before each pass. last_stats names the
    tier, the route, the host reads and the CG iterations and chunks of
    each LM step."""

    def __init__(self, tier: str, n: int, e: int, dtype, device,
                 max_iterations: int, cg_iters: int):
        self.key = (tier, n, e, dtype, str(device), max_iterations, cg_iters)
        f = dict(dtype=dtype, device=device)
        i64 = dict(dtype=torch.int64, device=device)

        def z(*shape):
            return torch.zeros(shape, **f)

        self.inp = dict(poses=z(n, 3), src=torch.zeros(e, **i64),
                        dst=torch.zeros(e, **i64), rel=z(e, 3),
                        sqrt_info=z(e, 3, 3), free=z(n), lam0=z(), ftol=z(),
                        gtol=z(), ptol=z(), cg_tol=z())
        logs = max(max_iterations, 1)
        self.st = dict(
            poses=z(n, 3), chi2=z(), lam=z(), gnorm=z(), step=z(n, 3),
            it=torch.zeros((), **i64),
            done=torch.zeros((), dtype=torch.bool, device=device),
            go=torch.zeros(1, **i64), cg_log=torch.zeros(logs, **i64),
            chunk_log=torch.zeros(logs, **i64))
        self.tier, self.max_iterations = tier, max_iterations
        self.cg = None
        if tier != "dense":
            _, ops = _pcg_ops(n)
            bufs = dict(diag_d=z(n, 3, 3), hab=z(e, 3, 3),
                        src=self.inp["src"], dst=self.inp["dst"],
                        free=self.inp["free"], b=z(n, 3), stop=z())
            if tier == "pcr":
                bufs["U"] = z(n - 1, 3, 3)
            else:
                bufs.update(Sinv=z(n, 3, 3), T=z(n - 1, 3, 3),
                            W=z(n - 1, 3, 3))
            self.cg = CGLoop(bufs, ops, cg_iters, period=64,
                             device_loop=True)
        self.program = None
        self.lock = threading.Lock()
        self.last_stats: dict = {}
        self._reads = 0

    def _chi2(self, poses):
        t = self.inp
        return torch.sum(edge_residual(poses, t["src"], t["dst"], t["rel"],
                                       t["sqrt_info"]) ** 2)

    def _go(self):
        s = self.st
        s["go"].copy_(((s["it"] < self.max_iterations) & ~s["done"]).to(
            torch.int64))

    def _init(self):
        t, s = self.inp, self.st
        s["poses"].copy_(t["poses"])
        s["chi2"].copy_(self._chi2(s["poses"]))
        s["lam"].copy_(t["lam0"])
        for name in ("it", "done", "cg_log", "chunk_log"):
            s[name].zero_()
        self._go()

    def _head(self):
        t, s = self.inp, self.st
        src, dst, free = t["src"], t["dst"], t["free"]
        diag, hab, grad, _ = build_normal_blocks(s["poses"], src, dst,
                                                 t["rel"], t["sqrt_info"])
        s["gnorm"].copy_(torch.max(torch.abs(grad * free[:, None])))
        if self.cg is None:
            s["step"].copy_(dense_step(diag, hab, grad, src, dst, free,
                                       s["lam"]))
            return
        cg = self.cg
        cg._load(_pcg_inputs(diag, hab, grad, src, dst, free, s["lam"],
                             t["cg_tol"]))
        cg.init_fn()

    def _tail(self):
        t, s = self.inp, self.st
        poses, chi2, lam = s["poses"], s["chi2"], s["lam"]
        step = s["step"] if self.cg is None else self.cg.state["x"]
        new_poses = poses + step
        new_poses[:, 2] = torch.atan2(
            torch.sin(new_poses[:, 2]), torch.cos(new_poses[:, 2]))
        new_chi2 = self._chi2(new_poses)
        accept = new_chi2 <= chi2
        rel_dec = (chi2 - new_chi2) / torch.clamp_min(chi2, 1e-30)
        step_norm = torch.max(torch.abs(step))
        lam_n = torch.where(accept, torch.clamp_min(lam * 0.3, 1e-9),
                            torch.clamp_max(lam * 10.0, 1e6))
        done = (
            (s["gnorm"] < t["gtol"])
            | (accept & (rel_dec < t["ftol"]))
            | (accept & (step_norm < t["ptol"] * 1e-2))
            | ((~accept) & (lam_n >= 1e6))
        )
        if self.cg is not None:
            at = s["it"].view(1)
            s["cg_log"].index_copy_(0, at, self.cg.state["i"].view(1))
            s["chunk_log"].index_copy_(0, at,
                                       self.cg.state["chunks"].view(1))
        poses.copy_(torch.where(accept, new_poses, poses))
        chi2.copy_(torch.where(accept, new_chi2, chi2))
        lam.copy_(lam_n)
        s["done"].copy_(s["done"] | done)
        s["it"].add_(1)
        self._go()

    def _read(self, t):
        self._reads += 1
        return _host_read(t)

    def plan(self) -> list:
        """The LM loop as a WhileProgram plan."""
        body = [self._head]
        if self.cg is not None:
            cs = self.cg.state
            body.append(("while", cs["status"][1:], [self.cg.body_fn]))
        body.append(self._tail)
        return [self._init, ("while", self.st["go"], body)]

    def _python_loop(self):
        self._init()
        while self._read(self.st["go"])[0]:
            self._head()
            if self.cg is not None:
                while self._read(self.cg.state["status"][1]):
                    self.cg.body_fn()
            self._tail()

    def _run(self, inputs, graphed: bool):
        self._reads = 0
        for name, v in inputs.items():
            if isinstance(v, torch.Tensor):
                self.inp[name].copy_(v)
            else:
                self.inp[name].fill_(v)
        prog = None
        if graphed:
            prog = self.program
            if prog is None:
                prog = self.program = mc.WhileProgram(
                    self.plan(), self.st["poses"].device)
            prog.launch()
        else:
            self._python_loop()
        s = self.st
        n = s["poses"].shape[0]
        vals = self._read(torch.cat([
            v.reshape(-1).to(torch.float64) for v in (
                s["poses"], s["chi2"], s["it"], s["cg_log"],
                s["chunk_log"])]))
        dtype = s["poses"].dtype
        poses = torch.tensor(vals[:3 * n], dtype=dtype).reshape(n, 3)
        chi2 = torch.tensor(vals[3 * n], dtype=dtype)
        it = int(vals[3 * n + 1])
        logs = len(s["cg_log"])
        pcg = self.cg is not None
        cg = [int(c) for c in vals[3 * n + 2:3 * n + 2 + it]] if pcg else []
        chunks = ([int(c) for c in vals[3 * n + 2 + logs:][:it]]
                  if pcg else [])
        if prog is not None:
            mc.count_replay(prog.tally[self._init])
            mc.count_replay(prog.tally[self._head], it)
            mc.count_replay(prog.tally[self._tail], it)
            if pcg:
                mc.count_replay(prog.tally[self.cg.body_fn], sum(chunks))
        self.last_stats = {
            "tier": self.tier,
            "route": "device loop" if graphed else "host loop",
            "host_reads": self._reads, "cg_iters": cg, "cg_chunks": chunks}
        return poses, chi2, it

    def run(self, inputs: dict):
        """(poses, chi2, iterations) on the host from `inputs` (lm_solve's
        arrays and scalars) by the loop's route."""
        with self.lock:
            return self._run(inputs,
                             mc._on_cuda(self.st["poses"].device))

    def run_eager(self, inputs: dict):
        """run() by the Python loop on any device: the reference the
        device loop is held to bit for bit."""
        with self.lock:
            return self._run(inputs, False)

    def close(self) -> None:
        """Lets the programs (this loop's and its CG loop's) and their
        pools go; a later run() captures again."""
        with self.lock:
            progs = [self.program] + (list(self.cg.programs.values())
                                      if self.cg is not None else [])
            for prog in progs:
                if prog is not None:
                    prog.close()
            self.program = None
            if self.cg is not None:
                self.cg.programs = {}


def lm_loop(tier: str, n: int, e: int, dtype, device, max_iterations: int,
            cg_iters: int) -> LMLoop:
    """The LMLoop of this bucket, made at first use and kept until a
    bucket of another shape comes to the same tier, which closes it."""
    key = (tier, n, e, dtype, str(device), max_iterations, cg_iters)
    with mc.capture_lock:
        old = loop = _LM_LOOPS.get(tier)
        if loop is None or loop.key != key:
            loop = _LM_LOOPS[tier] = LMLoop(tier, n, e, dtype, device,
                                            max_iterations, cg_iters)
        else:
            old = None
    # outside capture_lock: a run of the old loop may hold its lock and
    # wait for capture_lock
    if old is not None:
        old.close()
    return loop


def lm_solve(
    poses, src, dst, rel, sqrt_info, free,
    initial_lambda: float, function_tolerance: float,
    gradient_tolerance: float, parameter_tolerance: float,
    max_iterations: int, cg_tol: float = 1e-8, cg_iters: int = 200,
):
    """Levenberg-Marquardt in the dtype and on the device of `poses`:
    dense-Cholesky steps up to DENSE_MAX_NODES nodes, chain-preconditioned
    PCG steps (at most cg_iters iterations to cg_tol) past it, the chain
    solved by the Thomas sweeps (K9) below 4,096 nodes and by PCR from
    there (_tier). Same acceptance and termination rules as the JAX
    package's lm_solve, and like it one program a bucket: on a card the LM
    loop and its CG loop run as CUDA-graph WHILE nodes (LMLoop, K10) with
    one host read a call; on the CPU from a Python loop. Returns (poses,
    chi2, iterations), on the host; lm_solve.last_stats names the tier,
    the route, the host reads and the CG iterations of each LM step."""
    n, e = poses.shape[0], src.shape[0]
    loop = lm_loop(_tier(n), n, e, poses.dtype, poses.device,
                   max_iterations, cg_iters)
    out = loop.run(dict(
        poses=poses, src=src, dst=dst, rel=rel, sqrt_info=sqrt_info,
        free=free, lam0=initial_lambda, ftol=function_tolerance,
        gtol=gradient_tolerance, ptol=parameter_tolerance, cg_tol=cg_tol))
    lm_solve.last_stats = loop.last_stats
    return out


# ---------------------------------------------------------------------------
# Host sparse path (the default tier; mandatory past the dense ceiling).
#
# The native normal-equation assembly (native/graph_ops.cpp
# se2_normal_blocks, se2_chi2: one pass over the edges, bit-identical to
# the NumPy twins _np_normal_blocks and _np_chi2, which the tests hold it
# against) + the native block-sparse Cholesky (sparse_chol_* — min-degree
# ordering, 3x3 block up-looking factorization). This is the Ceres
# SPARSE_NORMAL_CHOLESKY analog (README.md:164 recommended config): at
# n > ~2k the dense factorization is O(n^3), while the sparse factor of a
# SLAM graph stays near-linear. Entirely host-side.


def _np_normal_blocks(poses, src, dst, rel, sqrt_info):
    """f64 NumPy twin of build_normal_blocks (unpadded); the plain version
    native.normal_blocks is held bit-equal to."""
    pa, pb = poses[src], poses[dst]
    ca, sa = np.cos(pa[:, 2]), np.sin(pa[:, 2])
    dx = pb[:, 0] - pa[:, 0]
    dy = pb[:, 1] - pa[:, 1]
    rx = ca * dx + sa * dy - rel[:, 0]
    ry = -sa * dx + ca * dy - rel[:, 1]
    dth = pb[:, 2] - pa[:, 2] - rel[:, 2]
    rth = np.arctan2(np.sin(dth), np.cos(dth))
    r = np.einsum("eij,ej->ei", sqrt_info, np.stack([rx, ry, rth], -1))
    z = np.zeros_like(ca)
    o = np.ones_like(ca)
    ja = np.stack(
        [
            np.stack([-ca, -sa, -sa * dx + ca * dy], -1),
            np.stack([sa, -ca, -ca * dx - sa * dy], -1),
            np.stack([z, z, -o], -1),
        ],
        axis=-2,
    )
    jb = np.stack(
        [
            np.stack([ca, sa, z], -1),
            np.stack([-sa, ca, z], -1),
            np.stack([z, z, o], -1),
        ],
        axis=-2,
    )
    ja = np.einsum("eij,ejk->eik", sqrt_info, ja)
    jb = np.einsum("eij,ejk->eik", sqrt_info, jb)
    n = len(poses)
    diag = np.zeros((n, 3, 3))
    np.add.at(diag, src, np.einsum("eji,ejk->eik", ja, ja))
    np.add.at(diag, dst, np.einsum("eji,ejk->eik", jb, jb))
    hab = np.einsum("eji,ejk->eik", ja, jb)
    grad = np.zeros((n, 3))
    np.add.at(grad, src, -np.einsum("eji,ej->ei", ja, r))
    np.add.at(grad, dst, -np.einsum("eji,ej->ei", jb, r))
    return diag, hab, grad, float(np.sum(r * r))


def _np_chi2(poses, src, dst, rel, sqrt_info):
    pa, pb = poses[src], poses[dst]
    ca, sa = np.cos(pa[:, 2]), np.sin(pa[:, 2])
    dx = pb[:, 0] - pa[:, 0]
    dy = pb[:, 1] - pa[:, 1]
    rx = ca * dx + sa * dy - rel[:, 0]
    ry = -sa * dx + ca * dy - rel[:, 1]
    dth = pb[:, 2] - pa[:, 2] - rel[:, 2]
    rth = np.arctan2(np.sin(dth), np.cos(dth))
    r = np.einsum("eij,ej->ei", sqrt_info, np.stack([rx, ry, rth], -1))
    return float(np.sum(r * r))


def _edge_trig(poses, src, dst, rel):
    """NumPy's cos and sin of each edge's source heading and its wrapped
    heading residual, the values _np_normal_blocks computes, for the
    native assembly (native.normal_blocks, native.chi2)."""
    th = poses[:, 2]
    ta, tb = th[src], th[dst]
    dth = tb - ta - rel[:, 2]
    return np.cos(ta), np.sin(ta), np.arctan2(np.sin(dth), np.cos(dth))


def host_sparse_lm(poses, src, dst, rel, sqrt_info, free, cfg):
    """Levenberg-Marquardt on the host with the native sparse Cholesky and
    the native assembly, bit-identical to the NumPy twins. Same
    acceptance/termination logic as lm_solve. Returns (poses, chi2,
    iters) or None if the native lib is unavailable."""
    from slam_toolbox_tpu_torch import native

    if native.get_lib() is None:
        return None
    free_b = free.astype(bool)
    # edges fully interior to the free set keep their off-diagonal block;
    # edges touching the gauge node only contribute to diag/grad, which
    # the row/col projection zeroes on the fixed side
    keep = free_b[src] & free_b[dst]
    # symbolic analysis (ordering + etree + pattern) once; only the
    # damped values change across LM iterations
    with stage_timer(None, "solve_analyze"):
        chol = native.SparseCholesky(len(poses), src[keep], dst[keep])
    lam = cfg.initial_lm_lambda
    # each pose set's trig serves its chi2 and, once accepted, the next
    # step's assembly
    with stage_timer(None, "solve_assemble"):
        trig = _edge_trig(poses, src, dst, rel)
        chi2 = native.chi2(poses, src, dst, rel, sqrt_info, trig)
    iters = 0
    eye = np.eye(3)
    for _ in range(cfg.max_iterations):
        with stage_timer(None, "solve_assemble"):
            diag, hab, grad, _ = native.normal_blocks(
                poses, src, dst, rel, sqrt_info, trig
            )
        grad[~free_b] = 0.0
        gnorm = np.max(np.abs(grad)) if len(grad) else 0.0
        if gnorm < cfg.gradient_tolerance:
            break
        damp = lam * np.einsum("nii->n", diag)[:, None, None] * eye / 3.0
        diag_d = diag + damp + 1e-8 * eye
        diag_d[~free_b] = eye
        with stage_timer(None, "solve_factor"):
            x = chol.factor_solve(diag_d, hab[keep], grad)
        if x is None:
            return None
        step = x * free_b[:, None]
        new_poses = poses + step
        new_poses[:, 2] = np.arctan2(
            np.sin(new_poses[:, 2]), np.cos(new_poses[:, 2])
        )
        with stage_timer(None, "solve_assemble"):
            new_trig = _edge_trig(new_poses, src, dst, rel)
            new_chi2 = native.chi2(
                new_poses, src, dst, rel, sqrt_info, new_trig
            )
        iters += 1
        accept = new_chi2 <= chi2
        if accept:
            rel_dec = (chi2 - new_chi2) / max(chi2, 1e-30)
            step_norm = float(np.max(np.abs(step)))
            poses, chi2, trig = new_poses, new_chi2, new_trig
            lam = max(lam * 0.3, 1e-9)
            if (
                rel_dec < cfg.function_tolerance
                or step_norm < cfg.parameter_tolerance * 1e-2
            ):
                break
        else:
            lam = min(lam * 10.0, 1e6)
            if lam >= 1e6:
                break
    return poses, chi2, iters



# below this node count the normal equations are solved densely (one
# Cholesky per LM step; Ceres similarly prefers dense solvers for small
# problems); past it lm_solve runs the chain-preconditioned PCG
DENSE_MAX_NODES = 2048


def _sqrt_info_3x3(cov):
    """info = 0.5·(inv(cov) + inv(cov)^T), sqrt_info = chol(info)^T
    (upper factor, U^T U = info — ceres_solver.cpp:364-376), in closed
    form: the per-edge LAPACK inv+cholesky round trip cost ~35 us on the
    drain bookkeeping path (one call per graph edge). Falls back to the
    LAPACK path on any degenerate input (non-finite, non-SPD)."""
    (a, b, c), (d, e, f), (g, h, i) = cov.tolist()
    # adjugate inverse
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    if det > 0.0 and math.isfinite(det):
        inv_det = 1.0 / det
        m00 = A * inv_det
        m01 = -(b * i - c * h) * inv_det
        m02 = (b * f - c * e) * inv_det
        m10 = B * inv_det
        m11 = (a * i - c * g) * inv_det
        m12 = -(a * f - c * d) * inv_det
        m20 = C * inv_det
        m21 = -(a * h - b * g) * inv_det
        m22 = (a * e - b * d) * inv_det
        # symmetrize, then lower Cholesky (returned transposed = upper)
        s01 = 0.5 * (m01 + m10)
        s02 = 0.5 * (m02 + m20)
        s12 = 0.5 * (m12 + m21)
        if m00 > 0.0:
            l00 = math.sqrt(m00)
            l10 = s01 / l00
            l20 = s02 / l00
            t11 = m11 - l10 * l10
            if t11 > 0.0:
                l11 = math.sqrt(t11)
                l21 = (s12 - l20 * l10) / l11
                t22 = m22 - l20 * l20 - l21 * l21
                if t22 > 0.0 and math.isfinite(t22):
                    l22 = math.sqrt(t22)
                    return np.array([
                        [l00, l10, l20],
                        [0.0, l11, l21],
                        [0.0, 0.0, l22],
                    ])
    info = np.linalg.inv(cov)
    info = 0.5 * (info + info.T)
    return np.linalg.cholesky(info).T


def _grow(a: np.ndarray, need: int) -> np.ndarray:
    """`a`, or a copy with twice the rows (or `need`), its rows kept."""
    if need <= len(a):
        return a
    out = np.zeros((max(need, 2 * len(a)),) + a.shape[1:], a.dtype)
    out[:len(a)] = a
    return out


class PoseGraphSolver:
    """Incremental SE(2) pose-graph solver (ScanSolver-equivalent).

    The problem lives in flat arrays across solves. Node row i holds node
    `_ids[i]` at `_poses[i]`. Edge row k holds the constraint from node
    row `_src[k]` to `_dst[k]`, its relative pose `_rel[k]` and whitening
    `_sqrt_info[k]`, while `_alive[k]`. `_edge_row` maps each live
    (id1, id2) key to its row, in the order a dict of the edges would
    hold them: a new key appends a row, an existing one is overwritten in
    place, a removed one leaves a dead row. An order-preserving compaction
    takes the dead rows out when they are more than half, or before a
    full solve, so solves read slices and sum in the edges' order.
    `_node_edges[i]` lists the live keys at node row i, which remove_node
    rewrites when it moves the last row into a freed one."""

    def __init__(self, config=None, device=None):
        from slam_toolbox_tpu_torch.core.params import SolverConfig

        self.config = config or SolverConfig()
        self.device = resolve_device(device)
        self._ids: List[int] = []
        self._id_to_idx: Dict[int, int] = {}
        self._node_edges: List[List[Tuple[int, int]]] = []
        self._poses = np.zeros((64, 3))
        self._edge_row: Dict[Tuple[int, int], int] = {}
        self._ne = 0  # edge rows in use, dead ones included
        self._n_dead = 0
        self._src = np.zeros(128, np.int64)
        self._dst = np.zeros(128, np.int64)
        self._rel = np.zeros((128, 3))
        self._sqrt_info = np.zeros((128, 3, 3))
        self._alive = np.zeros(128, bool)
        self._first_id: Optional[int] = None
        self.corrections: List[Tuple[int, np.ndarray]] = []

    # -- ScanSolver API (Mapper.h:954-1066) ---------------------------------
    def add_node(self, node_id: int, pose) -> None:
        if node_id in self._id_to_idx:
            return
        if self._first_id is None:
            self._first_id = node_id  # gauge (ceres_solver.cpp:317-336)
        i = len(self._ids)
        self._poses = _grow(self._poses, i + 1)
        self._poses[i] = pose
        self._id_to_idx[node_id] = i
        self._ids.append(node_id)
        self._node_edges.append([])

    def add_constraint(
        self, id1: int, id2: int, rel_pose, covariance
    ) -> bool:
        """Edge with relative pose (in frame of node id1) and its covariance;
        information = cov^-1, whitening by its upper Cholesky factor
        (ceres_solver.cpp:364-376)."""
        if id1 not in self._id_to_idx or id2 not in self._id_to_idx:
            return False
        # the graph layer dedupes on the normal path, but merge /
        # deserialize feed the solver directly: a reversed duplicate
        # (id2,id1) would silently double-count the constraint
        if (id2, id1) in self._edge_row:
            return False
        sqrt_info = _sqrt_info_3x3(np.asarray(covariance, np.float64))
        key = (id1, id2)
        k = self._edge_row.get(key)
        if k is None:
            k = self._ne
            if k == len(self._alive):
                for name in ("_src", "_dst", "_rel", "_sqrt_info", "_alive"):
                    setattr(self, name, _grow(getattr(self, name), k + 1))
            self._ne = k + 1
            self._edge_row[key] = k
            a, b = self._id_to_idx[id1], self._id_to_idx[id2]
            self._src[k], self._dst[k], self._alive[k] = a, b, True
            for i in {a, b}:
                self._node_edges[i].append(key)
        self._rel[k] = rel_pose
        self._sqrt_info[k] = sqrt_info
        return True

    def remove_node(self, node_id: int) -> None:
        """O(1) swap-with-last removal (the reference keeps Ceres
        enable_fast_removal for the same reason, ceres_solver.cpp:183-186;
        localization evicts one node per scan, so an O(n) reindex here is
        quadratic against BASELINE config-4's 100k-node graphs): the last
        row moves into the freed one, and its edges' rows follow it. Index
        order is not semantic: compute() maps ids through _id_to_idx and
        the host-sparse path reorders internally (the device chain
        preconditioner merely catches fewer consecutive-index edges after
        removals, costing CG iterations, never correctness). Constraints
        still at the node go with it (the graph removes them first)."""
        idx = self._id_to_idx.pop(node_id, None)
        if idx is None:
            return
        for key in list(self._node_edges[idx]):
            self._drop_edge(key)
        last = len(self._ids) - 1
        if idx != last:
            moved = self._ids[last]
            self._ids[idx] = moved
            self._poses[idx] = self._poses[last]
            self._id_to_idx[moved] = idx
            for key in self._node_edges[last]:
                k = self._edge_row[key]
                if self._src[k] == last:
                    self._src[k] = idx
                if self._dst[k] == last:
                    self._dst[k] = idx
            self._node_edges[idx] = self._node_edges[last]
        self._ids.pop()
        self._node_edges.pop()
        if node_id == self._first_id:
            self._first_id = self._ids[0] if self._ids else None

    def remove_constraint(self, id1: int, id2: int) -> None:
        for key in ((id1, id2), (id2, id1)):
            if key in self._edge_row:
                self._drop_edge(key)

    def _drop_edge(self, key) -> None:
        k = self._edge_row.pop(key)
        self._alive[k] = False
        for i in {int(self._src[k]), int(self._dst[k])}:
            self._node_edges[i].remove(key)
        self._n_dead += 1
        if 2 * self._n_dead > self._ne:
            self._compact()

    def _compact(self) -> None:
        """Take the dead edge rows out, the live ones kept in order
        (counted as solve_compact)."""
        count(None, "solve_compact")
        live = self._alive[:self._ne]
        m = len(self._edge_row)
        for a in (self._src, self._dst, self._rel, self._sqrt_info):
            a[:m] = a[:self._ne][live]
        self._alive[:m] = True
        self._alive[m:self._ne] = False
        self._ne, self._n_dead = m, 0
        self._edge_row = dict(zip(self._edge_row, range(m)))

    def modify_node(self, node_id: int, pose) -> None:
        """Manually move a node (loop_closure_assistant manual closure);
        note the reference *adds* the given yaw to the stored yaw
        (ceres_solver.cpp:451-461)."""
        if node_id not in self._id_to_idx:
            return
        cur = self._poses[self._id_to_idx[node_id]]
        pose = np.asarray(pose, dtype=np.float64)
        cur[:] = [pose[0], pose[1], cur[2] + pose[2]]

    def get_node_pose(self, node_id: int) -> np.ndarray:
        return self._poses[self._id_to_idx[node_id]].copy()

    def set_node_pose(self, node_id: int, pose) -> None:
        self._poses[self._id_to_idx[node_id]] = pose

    def get_graph(self):
        """(nodes dict id->pose, edge list) for visualization."""
        nodes = dict(zip(self._ids, self._poses[:len(self._ids)].copy()))
        return nodes, list(self._edge_row)

    def clear(self) -> None:
        self.corrections = []

    def reset(self) -> None:
        self.__init__(self.config, self.device)

    @property
    def n_nodes(self) -> int:
        return len(self._ids)

    @property
    def n_edges(self) -> int:
        return len(self._edge_row)

    # -- the arrays a solve reads ---------------------------------------------
    def _edge_slices(self):
        """The live edges' (src, dst, rel, sqrt_info), slices of the
        resident arrays once the dead rows are compacted away."""
        if self._n_dead:
            self._compact()
        e = self._ne
        return (self._src[:e], self._dst[:e], self._rel[:e],
                self._sqrt_info[:e])

    def _free(self, n_pad: int, dtype) -> np.ndarray:
        """1 on each node row that moves: not the gauge, not padding."""
        free = np.zeros(n_pad, dtype)
        free[:len(self._ids)] = 1.0
        g = self._id_to_idx.get(self._first_id)
        if g is not None:
            free[g] = 0.0
        return free

    def _padded(self, n_pad: int, e_pad: int, dtype):
        """The problem padded for the device routes: f32 poses, src and
        dst (padding edges on the last padded node), rel and sqrt_info in
        `dtype` (padding zero, so weightless)."""
        n = len(self._ids)
        src, dst, rel, sqrt_info = self._edge_slices()
        e = len(src)
        poses = np.zeros((n_pad, 3), np.float32)
        poses[:n] = self._poses[:n]
        src_p = np.full(e_pad, n_pad - 1, np.int64)
        dst_p = np.full(e_pad, n_pad - 1, np.int64)
        src_p[:e], dst_p[:e] = src, dst
        rel_p = np.zeros((e_pad, 3), dtype)
        si_p = np.zeros((e_pad, 3, 3), dtype)
        rel_p[:e], si_p[:e] = rel, sqrt_info
        return poses, src_p, dst_p, rel_p, si_p

    def _commit(self, result: np.ndarray):
        """A full solve's poses (n, 3), an array of the solve's own, written
        back in one assignment; corrections are rows of `result`, never of
        the resident arrays the next solve overwrites."""
        self._poses[:len(self._ids)] = result
        self.corrections = list(zip(self._ids, result))
        return self.corrections

    # -- Compute (ceres_solver.cpp:214-269 analog) --------------------------
    def compute(self) -> List[Tuple[int, np.ndarray]]:
        n, e = self.n_nodes, self.n_edges
        if n == 0 or e == 0:
            return self._commit(self._poses[:n].copy())

        # large graphs under a process group of several ranks take the
        # edge-sharded distributed solve (dist/solver_dist.py); a fault
        # there raises rather than falling through
        if e >= self.config.dist_edge_threshold and world_size() > 1:
            return self._compute_distributed(n, e)

        import time as _time

        # native host sparse Cholesky (see host_sparse_lm): the default
        # everywhere (host_sparse_min_nodes=0) and the first choice past
        # the dense ceiling; the device path serves the rest and the case
        # where the native lib is unavailable
        if n >= self.config.host_sparse_min_nodes or n > DENSE_MAX_NODES:
            res = self._compute_host_sparse(n, e)
            if res is not None:
                return res

        t0 = _time.perf_counter()
        cfg = self.config
        dev = self.device
        # padded as the JAX package pads (generous powers of two: nodes
        # from 256, edges from 512), so one LMLoop serves a bucket of graph
        # sizes; past the dense ceiling that is at least 4,096 nodes (the
        # PCR chain preconditioner). Padding nodes are not free and padding
        # edges have zero weight
        n_pad, e_pad = _pad_pow2(n, 256), _pad_pow2(e, 512)
        poses, src, dst, rel, sqrt_info = self._padded(
            n_pad, e_pad, np.float32)
        free = self._free(n_pad, np.float32)

        def t(a):
            return torch.from_numpy(a).to(dev)

        poses_out, chi2, iters = lm_solve(
            t(poses), t(src), t(dst), t(rel), t(sqrt_info), t(free),
            float(np.float32(cfg.initial_lm_lambda)),
            float(np.float32(cfg.function_tolerance)),
            float(np.float32(cfg.gradient_tolerance)),
            float(np.float32(cfg.parameter_tolerance)),
            cfg.max_iterations,
            cg_tol=float(np.float32(cfg.cg_tolerance)),
            cg_iters=cfg.cg_max_iterations,
        )
        result = poses_out[:n].cpu().numpy().astype(np.float64)
        self.last_stats = {
            "n": n, "e": e, "lm_iters": iters, "chi2": float(chi2),
            "device_ms": round(1e3 * (_time.perf_counter() - t0), 2),
            "tier": "dense" if n_pad <= DENSE_MAX_NODES else "pcg",
            "loop": lm_solve.last_stats,
            "host_reads": lm_solve.last_stats["host_reads"],
        }
        return self._commit(result)

    def compute_window(self, active_ids):
        """Windowed elastic solve: only `active_ids` move; every node
        they share an edge with (the window boundary) is held as a
        FIXED anchor, and the rest of the graph does not even enter the
        subproblem. Returns corrections for active nodes only (or None
        when the native sparse path is unavailable — callers fall back
        to the full compute()).

        Rationale (BASELINE config 4): an accepted localization closure
        against a converged 100k-node prior triggered a 2.9 s full
        elastic solve + a 100k-scan correction writeback — while the
        correction outside the query's neighborhood is ~zero (it decays
        exponentially with graph distance through well-constrained
        odometry chains). The boundary anchors make the window a strict
        approximation of the full solve; tests/test_windowed_solve.py
        bounds the in-window disagreement. No reference counterpart
        (Ceres always solves the whole problem, ceres_solver.cpp:214) —
        documented in PARITY.md §Known; radius 0 disables.

        The subproblem's edges are one mask over the edge rows (live and
        touching the window), so dead rows need no compaction here."""
        import time as _time

        t0 = _time.perf_counter()
        n_all = len(self._ids)
        act_ids = [i for i in active_ids if i in self._id_to_idx]
        act_idx = [self._id_to_idx[i] for i in act_ids]
        if not act_idx or n_all == 0:
            return []
        # a dead row may still name a freed node row, within capacity
        in_act = np.zeros(len(self._poses), bool)
        in_act[act_idx] = True
        ne = self._ne
        src, dst = self._src[:ne], self._dst[:ne]
        sel = self._alive[:ne] & (in_act[src] | in_act[dst])
        if not sel.any():
            return []
        es, ed = src[sel], dst[sel]
        order = np.unique(np.concatenate([act_idx, es, ed]))
        m = len(order)
        l_of = np.full(n_all, -1, np.int64)
        l_of[order] = np.arange(m)
        free = in_act[order].astype(np.float64)
        if free.min() > 0.0:
            # window swallowed its whole component: gauge-fix one node
            g = self._id_to_idx.get(self._first_id)
            free[l_of[g] if g is not None and l_of[g] >= 0 else 0] = 0.0
        res = host_sparse_lm(
            self._poses[order], l_of[es], l_of[ed], self._rel[:ne][sel],
            self._sqrt_info[:ne][sel], free, self.config)
        if res is None:
            return None
        poses_out, chi2, iters = res
        moved = free.astype(bool)
        self._poses[order[moved]] = poses_out[moved]
        self.corrections = list(zip(act_ids, poses_out[l_of[act_idx]]))
        self.last_stats = {
            "n": m, "n_active": len(act_idx), "e": len(es),
            "lm_iters": iters, "chi2": chi2, "window": True,
            "host_sparse_ms": round(
                1e3 * (_time.perf_counter() - t0), 2),
        }
        return self.corrections

    def _compute_host_sparse(self, n: int, e: int):
        """Unpadded f64 host LM with the native block-sparse Cholesky."""
        import time as _time

        t0 = _time.perf_counter()
        with stage_timer(None, "solve_pack"):
            src, dst, rel, sqrt_info = self._edge_slices()
            poses = self._poses[:n].copy()
            free = self._free(n, np.float64)
        with stage_timer(None, "solve_lm"):
            res = host_sparse_lm(
                poses, src, dst, rel, sqrt_info, free, self.config
            )
        if res is None:
            return None
        poses_out, chi2, iters = res
        self.last_stats = {
            "n": n, "e": e, "lm_iters": iters, "chi2": chi2,
            "host_sparse_ms": round(1e3 * (_time.perf_counter() - t0), 2),
        }
        return self._commit(poses_out)

    def _compute_distributed(self, n: int, e: int):
        """Edge-sharded solve over the process group's ranks; every rank
        calls it on the same graph and ends with the same poses."""
        from slam_toolbox_tpu_torch.dist import multihost
        from slam_toolbox_tpu_torch.dist.solver_dist import (
            distributed_lm_solve,
        )

        cfg = self.config
        mesh = multihost.global_mesh(self.device)
        n_dev = mesh.size
        # every rank's node slice a power of two, so the Schwarz block
        # (512 nodes, or the whole slice below that) divides it at any
        # rank count; on a power-of-two group past 16 nodes, _pad_pow2(n)
        n_pad = _pad_pow2(-(-n // n_dev), 1) * n_dev
        e_pad = ((_pad_pow2(e) + n_dev - 1) // n_dev) * n_dev
        poses, src, dst, rel, sqrt_info = self._padded(
            n_pad, e_pad, np.float64)
        emask = np.zeros(e_pad, bool)
        emask[:e] = True
        out, chi2 = distributed_lm_solve(
            mesh, poses, src, dst, rel, sqrt_info, emask,
            self._free(n_pad, np.float32),
            max_iterations=cfg.max_iterations,
            initial_lambda=cfg.initial_lm_lambda,
            function_tolerance=cfg.function_tolerance,
            cg_iters=cfg.cg_max_iterations,
        )
        self.last_stats = {
            "n": n, "e": e, "chi2": chi2, "ranks": n_dev,
            "cg_iters": list(distributed_lm_solve.last_cg_iters),
        }
        return self._commit(np.array(out[:n], dtype=np.float64))
