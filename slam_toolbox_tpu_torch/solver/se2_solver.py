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

Tiers: the native host block-sparse Cholesky (host_sparse_lm, numpy +
native/graph_ops.cpp; the default, since host_sparse_min_nodes = 0); the
LM loop (lm_solve) in f32 on the solver's device, with a dense Cholesky
step up to DENSE_MAX_NODES and past it a PCG step preconditioned by the
odometry chain (solver/chain_precond.py: parallel cyclic reduction from
4,096 padded nodes, the block Thomas sweeps below); and, when a process
group of more than one rank is up and the graph has dist_edge_threshold
edges, the edge-sharded distributed solve (dist/solver_dist.py), which
every rank runs in lockstep on the same graph.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from slam_toolbox_tpu_torch.device import resolve_device, world_size
from slam_toolbox_tpu_torch.solver import chain_precond as cp

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
    diag.index_add_(0, src, haa)
    diag.index_add_(0, dst, hbb)
    grad = poses.new_zeros((n, 3))
    grad.index_add_(0, src, -torch.einsum("eji,ej->ei", ja, r))
    grad.index_add_(0, dst, -torch.einsum("eji,ej->ei", jb, r))
    chi2 = torch.sum(r * r)
    return diag, hab, grad, chi2


def chi2_only(poses, src, dst, rel, sqrt_info, emask=None):
    r = edge_residual(poses, src, dst, rel, sqrt_info, emask)
    return torch.sum(r * r)


def _hx(x, diag_damped, hab, src, dst, free):
    """H @ x with the gauge row/col projected out."""
    x = x * free[:, None]
    out = torch.einsum("nij,nj->ni", diag_damped, x)
    out = out.index_add(0, src, torch.einsum("eij,ej->ei", hab, x[dst]))
    out = out.index_add(0, dst, torch.einsum("eji,ej->ei", hab, x[src]))
    return out * free[:, None]


def _damped(diag, lam):
    eye = torch.eye(3, dtype=diag.dtype, device=diag.device)
    damp = lam * torch.einsum("nii->n", diag)[:, None, None] * eye / 3.0
    return diag + damp + 1e-8 * eye


def solve_pcg(diag, hab, grad, src, dst, free, lm_lambda, cg_iters: int,
              cg_tol):
    """Block-Jacobi preconditioned CG on (H + λ·diagH) x = b. The stop
    test reads one device scalar per iteration."""
    eye = torch.eye(3, dtype=diag.dtype, device=diag.device)
    diag_d = _damped(diag, lm_lambda)
    # preconditioner: inverse of damped diagonal blocks
    minv = torch.linalg.inv(diag_d + 1e-6 * eye)
    b = grad * free[:, None]

    def mv(x):
        return _hx(x, diag_d, hab, src, dst, free)

    def prec(r):
        return torch.einsum("nij,nj->ni", minv, r) * free[:, None]

    x = torch.zeros_like(b)
    r = b - mv(x)
    p = prec(r)
    rz = torch.sum(r * p)
    stop = cg_tol * torch.clamp_min(torch.sum(b * b), 1e-30)
    i = 0
    while i < cg_iters and bool(torch.sum(r * r) > stop):
        hp = mv(p)
        alpha = rz / torch.clamp_min(torch.sum(p * hp), 1e-30)
        x = x + alpha * p
        r = r - alpha * hp
        z = prec(r)
        rz_new = torch.sum(r * z)
        p = z + rz_new / torch.clamp_min(rz, 1e-30) * p
        rz = rz_new
        i += 1
    return x


def pcg_step(diag, hab, grad, src, dst, free, lam, cg_iters: int, cg_tol):
    """lm_solve's step past the dense ceiling: CG on the damped normal
    equations preconditioned by the odometry chain, which it solves
    exactly, so CG iterates only on the loop-closure coupling. From
    4,096 nodes parallel cyclic reduction, below them the block Thomas
    factorization (reused across CG iterations). The true residual is
    recomputed every 64 iterations against f32 recurrence drift; the stop
    test reads one device scalar per iteration."""
    n = diag.shape[0]
    diag_d = _damped(diag, lam)
    b = grad * free[:, None]

    def mv(x):
        return _hx(x, diag_d, hab, src, dst, free)

    U = cp.build_chain_offdiag(hab, src, dst, n, free)
    if n >= 4096:
        steps = int(math.ceil(math.log2(n))) + 1

        def prec(r):
            return cp.pcr_solve(diag_d, U, r, free, steps)
    else:
        Sinv, T, W = cp.factorize(diag_d, U, free)

        def prec(r):
            return cp.apply(Sinv, T, W, r, free)

    x = torch.zeros_like(b)
    r = b - mv(x)
    p = prec(r)
    rz = torch.sum(r * p)
    stop = cg_tol * torch.clamp_min(torch.sum(b * b), 1e-30)
    i = 0
    while i < cg_iters and bool(torch.sum(r * r) > stop):
        hp = mv(p)
        alpha = rz / torch.clamp_min(torch.sum(p * hp), 1e-30)
        x = x + alpha * p
        restart = i % 64 == 63
        r = b - mv(x) if restart else r - alpha * hp
        z = prec(r)
        rz_new = torch.sum(r * z)
        p = z if restart else z + rz_new / torch.clamp_min(rz, 1e-30) * p
        rz = rz_new
        i += 1
    pcg_step.last_cg_iters = i
    return x


def dense_step(diag, hab, grad, src, dst, free, lam):
    """Exact damped-normal-equations solve via dense Cholesky."""
    n = diag.shape[0]
    diag_d = _damped(diag, lam)
    ii = torch.arange(3, device=diag.device)
    H = diag.new_zeros((3 * n, 3 * n))
    nidx = torch.arange(n, device=diag.device)
    # block-diagonal: rows 3k+i, cols 3k+j
    H.index_put_(
        ((nidx[:, None, None] * 3 + ii[None, :, None]).expand(n, 3, 3),
         (nidx[:, None, None] * 3 + ii[None, None, :]).expand(n, 3, 3)),
        diag_d, accumulate=True,
    )
    e = src.shape[0]
    rs = (src[:, None, None] * 3 + ii[None, :, None]).expand(e, 3, 3)
    cd = (dst[:, None, None] * 3 + ii[None, None, :]).expand(e, 3, 3)
    rd = (dst[:, None, None] * 3 + ii[None, :, None]).expand(e, 3, 3)
    cs = (src[:, None, None] * 3 + ii[None, None, :]).expand(e, 3, 3)
    # off-diagonal blocks hab at (src, dst) and habT at (dst, src)
    H.index_put_((rs, cd), hab, accumulate=True)
    H.index_put_((rd, cs), hab.transpose(1, 2), accumulate=True)
    free3 = free.repeat_interleave(3)
    # gauge: project fixed rows/cols out, unit diagonal keeps H SPD
    H = H * free3[:, None] * free3[None, :] + torch.diag(1.0 - free3)
    b = (grad * free[:, None]).reshape(-1, 1)
    L = torch.linalg.cholesky(H)
    x = torch.cholesky_solve(b, L)[:, 0]
    return (x * free3).reshape(n, 3)


def lm_solve(
    poses, src, dst, rel, sqrt_info, free,
    initial_lambda: float, function_tolerance: float,
    gradient_tolerance: float, parameter_tolerance: float,
    max_iterations: int, cg_tol: float = 1e-8, cg_iters: int = 200,
):
    """Levenberg-Marquardt in the dtype and on the device of `poses`:
    dense-Cholesky steps up to DENSE_MAX_NODES nodes, chain-preconditioned
    PCG steps (pcg_step, at most cg_iters iterations to cg_tol) past it.
    Same acceptance and termination rules as the JAX package's lm_solve;
    the loop runs on the host, one device sync per iteration for its
    termination test."""
    def chi2_of(p):
        return torch.sum(edge_residual(p, src, dst, rel, sqrt_info) ** 2)

    def solve_step(diag, hab, grad, lam):
        if poses.shape[0] <= DENSE_MAX_NODES:
            return dense_step(diag, hab, grad, src, dst, free, lam)
        return pcg_step(diag, hab, grad, src, dst, free, lam, cg_iters,
                        cg_tol)

    chi2 = chi2_of(poses)
    lam = torch.tensor(initial_lambda, dtype=poses.dtype,
                       device=poses.device)
    it = 0
    while it < max_iterations:
        diag, hab, grad, _ = build_normal_blocks(
            poses, src, dst, rel, sqrt_info)
        gnorm = torch.max(torch.abs(grad * free[:, None]))
        step = solve_step(diag, hab, grad, lam)
        new_poses = poses + step
        new_poses[:, 2] = torch.atan2(
            torch.sin(new_poses[:, 2]), torch.cos(new_poses[:, 2]))
        new_chi2 = chi2_of(new_poses)
        accept = new_chi2 <= chi2
        rel_dec = (chi2 - new_chi2) / torch.clamp_min(chi2, 1e-30)
        step_norm = torch.max(torch.abs(step))
        poses = torch.where(accept, new_poses, poses)
        chi2 = torch.where(accept, new_chi2, chi2)
        lam = torch.where(accept, torch.clamp_min(lam * 0.3, 1e-9),
                          torch.clamp_max(lam * 10.0, 1e6))
        done = (
            (gnorm < gradient_tolerance)
            | (accept & (rel_dec < function_tolerance))
            | (accept & (step_norm < parameter_tolerance * 1e-2))
            | ((~accept) & (lam >= 1e6))
        )
        it += 1
        if bool(done):
            break
    return poses, chi2, it


# ---------------------------------------------------------------------------
# Host sparse path (the default tier; mandatory past the dense ceiling).
#
# NumPy normal-equation assembly + the native block-sparse Cholesky
# (native/graph_ops.cpp sparse_block_solve — min-degree ordering, 3x3
# block up-looking factorization). This is the Ceres
# SPARSE_NORMAL_CHOLESKY analog (README.md:164 recommended config): at
# n > ~2k the dense factorization is O(n^3), while the sparse factor of a
# SLAM graph stays near-linear. Entirely host-side.


def _np_normal_blocks(poses, src, dst, rel, sqrt_info):
    """f64 NumPy twin of build_normal_blocks (unpadded)."""
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


def host_sparse_lm(poses, src, dst, rel, sqrt_info, free, cfg):
    """Levenberg-Marquardt on the host with the native sparse Cholesky.
    Same acceptance/termination logic as lm_solve. Returns (poses, chi2,
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
    chol = native.SparseCholesky(len(poses), src[keep], dst[keep])
    lam = cfg.initial_lm_lambda
    chi2 = _np_chi2(poses, src, dst, rel, sqrt_info)
    iters = 0
    eye = np.eye(3)
    for _ in range(cfg.max_iterations):
        diag, hab, grad, _ = _np_normal_blocks(
            poses, src, dst, rel, sqrt_info
        )
        grad[~free_b] = 0.0
        gnorm = np.max(np.abs(grad)) if len(grad) else 0.0
        if gnorm < cfg.gradient_tolerance:
            break
        damp = lam * np.einsum("nii->n", diag)[:, None, None] * eye / 3.0
        diag_d = diag + damp + 1e-8 * eye
        diag_d[~free_b] = eye
        x = chol.factor_solve(diag_d, hab[keep], grad)
        if x is None:
            return None
        step = x * free_b[:, None]
        new_poses = poses + step
        new_poses[:, 2] = np.arctan2(
            np.sin(new_poses[:, 2]), np.cos(new_poses[:, 2])
        )
        new_chi2 = _np_chi2(new_poses, src, dst, rel, sqrt_info)
        iters += 1
        accept = new_chi2 <= chi2
        if accept:
            rel_dec = (chi2 - new_chi2) / max(chi2, 1e-30)
            step_norm = float(np.max(np.abs(step)))
            poses, chi2 = new_poses, new_chi2
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


class PoseGraphSolver:
    """Incremental SE(2) pose-graph solver (ScanSolver-equivalent)."""

    def __init__(self, config=None, device=None):
        from slam_toolbox_tpu_torch.core.params import SolverConfig

        self.config = config or SolverConfig()
        self.device = resolve_device(device)
        self._ids: List[int] = []
        self._id_to_idx: Dict[int, int] = {}
        self._poses: List[np.ndarray] = []
        self._edges: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]] = {}
        self._first_id: Optional[int] = None
        self.corrections: List[Tuple[int, np.ndarray]] = []

    # -- ScanSolver API (Mapper.h:954-1066) ---------------------------------
    def add_node(self, node_id: int, pose) -> None:
        if node_id in self._id_to_idx:
            return
        if self._first_id is None:
            self._first_id = node_id  # gauge (ceres_solver.cpp:317-336)
        self._id_to_idx[node_id] = len(self._ids)
        self._ids.append(node_id)
        self._poses.append(np.asarray(pose, dtype=np.float64).copy())

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
        if (id2, id1) in self._edges:
            return False
        sqrt_info = _sqrt_info_3x3(np.asarray(covariance, np.float64))
        self._edges[(id1, id2)] = (
            np.asarray(rel_pose, dtype=np.float64).copy(),
            sqrt_info,
        )
        return True

    def remove_node(self, node_id: int) -> None:
        """O(1) swap-with-last removal (the reference keeps Ceres
        enable_fast_removal for the same reason, ceres_solver.cpp:183-186;
        localization evicts one node per scan, so an O(n) reindex here is
        quadratic against BASELINE config-4's 100k-node graphs). Index
        order is not semantic: compute() maps ids through _id_to_idx and
        the host-sparse path reorders internally (the device chain
        preconditioner merely catches fewer consecutive-index edges after
        removals, costing CG iterations, never correctness)."""
        idx = self._id_to_idx.pop(node_id, None)
        if idx is None:
            return
        last = len(self._ids) - 1
        if idx != last:
            self._ids[idx] = self._ids[last]
            self._poses[idx] = self._poses[last]
            self._id_to_idx[self._ids[idx]] = idx
        self._ids.pop()
        self._poses.pop()
        if node_id == self._first_id:
            self._first_id = self._ids[0] if self._ids else None

    def remove_constraint(self, id1: int, id2: int) -> None:
        self._edges.pop((id1, id2), None)
        self._edges.pop((id2, id1), None)

    def modify_node(self, node_id: int, pose) -> None:
        """Manually move a node (loop_closure_assistant manual closure);
        note the reference *adds* the given yaw to the stored yaw
        (ceres_solver.cpp:451-461)."""
        if node_id not in self._id_to_idx:
            return
        cur = self._poses[self._id_to_idx[node_id]]
        pose = np.asarray(pose, dtype=np.float64)
        self._poses[self._id_to_idx[node_id]] = np.array(
            [pose[0], pose[1], cur[2] + pose[2]]
        )

    def get_node_pose(self, node_id: int) -> np.ndarray:
        return self._poses[self._id_to_idx[node_id]]

    def set_node_pose(self, node_id: int, pose) -> None:
        self._poses[self._id_to_idx[node_id]] = np.asarray(
            pose, dtype=np.float64
        ).copy()

    def get_graph(self):
        """(nodes dict id->pose, edge list) for visualization."""
        nodes = {i: p.copy() for i, p in zip(self._ids, self._poses)}
        return nodes, list(self._edges.keys())

    def clear(self) -> None:
        self.corrections = []

    def reset(self) -> None:
        self.__init__(self.config, self.device)

    @property
    def n_nodes(self) -> int:
        return len(self._ids)

    @property
    def n_edges(self) -> int:
        return len(self._edges)

    # -- Compute (ceres_solver.cpp:214-269 analog) --------------------------
    def compute(self) -> List[Tuple[int, np.ndarray]]:
        n, e = len(self._ids), len(self._edges)
        if n == 0 or e == 0:
            self.corrections = [
                (i, p.copy()) for i, p in zip(self._ids, self._poses)
            ]
            return self.corrections

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
        # past the dense ceiling the PCG tier runs on padded arrays, as the
        # JAX package pads them: nodes to a power of two from 256 (so at
        # least 4,096 here, and the chain preconditioner is the PCR),
        # edges from 512; padding nodes are not free and padding edges
        # have zero weight
        pad = n > DENSE_MAX_NODES
        n_pad, e_pad = (_pad_pow2(n, 256), _pad_pow2(e, 512)) if pad else (n, e)
        poses = np.zeros((n_pad, 3), np.float32)
        poses[:n] = np.stack(self._poses)
        src = np.full(e_pad, n_pad - 1, np.int64)
        dst = np.full(e_pad, n_pad - 1, np.int64)
        rel = np.zeros((e_pad, 3), np.float32)
        sqrt_info = np.zeros((e_pad, 3, 3), np.float32)
        for k, ((i1, i2), (rp, si)) in enumerate(self._edges.items()):
            src[k] = self._id_to_idx[i1]
            dst[k] = self._id_to_idx[i2]
            rel[k] = rp
            sqrt_info[k] = si
        free = np.ones(n_pad, np.float32)
        free[n:] = 0.0
        if self._first_id in self._id_to_idx:
            free[self._id_to_idx[self._first_id]] = 0.0

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
            "tier": "pcg" if pad else "dense",
        }
        self.corrections = [
            (node_id, result[i].copy()) for i, node_id in enumerate(self._ids)
        ]
        for i in range(n):
            self._poses[i] = result[i].copy()
        return self.corrections

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
        documented in PARITY.md §Known; radius 0 disables."""
        import time as _time

        t0 = _time.perf_counter()
        n_all = len(self._ids)
        act_idx = [
            self._id_to_idx[i] for i in active_ids
            if i in self._id_to_idx
        ]
        if not act_idx or n_all == 0:
            return []
        in_act = np.zeros(n_all, bool)
        in_act[act_idx] = True
        sub_edges = []
        sub_nodes = set(act_idx)
        for (i1, i2), (rp, si) in self._edges.items():
            a, b = self._id_to_idx[i1], self._id_to_idx[i2]
            if in_act[a] or in_act[b]:
                sub_edges.append((a, b, rp, si))
                sub_nodes.add(a)
                sub_nodes.add(b)
        if not sub_edges:
            return []
        order = sorted(sub_nodes)
        l_of = {g: k for k, g in enumerate(order)}
        m = len(order)
        poses = np.stack([self._poses[g] for g in order])
        e = len(sub_edges)
        src = np.fromiter((l_of[a] for a, _, _, _ in sub_edges),
                          np.int64, e)
        dst = np.fromiter((l_of[b] for _, b, _, _ in sub_edges),
                          np.int64, e)
        rel = np.stack([rp for _, _, rp, _ in sub_edges])
        si = np.stack([s for _, _, _, s in sub_edges])
        free = np.fromiter((in_act[g] for g in order), np.float64, m)
        if free.min() > 0.0:
            # window swallowed its whole component: gauge-fix one node
            gk = (l_of[self._id_to_idx[self._first_id]]
                  if self._first_id in self._id_to_idx
                  and self._id_to_idx[self._first_id] in l_of
                  else 0)
            free[gk] = 0.0
        res = host_sparse_lm(poses, src, dst, rel, si, free, self.config)
        if res is None:
            return None
        poses_out, chi2, iters = res
        free_b = free.astype(bool)
        for k, g in enumerate(order):
            if free_b[k]:
                self._poses[g] = poses_out[k].copy()
        self.corrections = [
            (self._ids[g], poses_out[l_of[g]].copy())
            for g in act_idx
        ]
        self.last_stats = {
            "n": m, "n_active": len(act_idx), "e": e,
            "lm_iters": iters, "chi2": chi2, "window": True,
            "host_sparse_ms": round(
                1e3 * (_time.perf_counter() - t0), 2),
        }
        return self.corrections

    def _compute_host_sparse(self, n: int, e: int):
        """Unpadded f64 host LM with the native block-sparse Cholesky."""
        import time as _time

        t0 = _time.perf_counter()
        poses = np.stack(self._poses)
        src = np.zeros(e, np.int64)
        dst = np.zeros(e, np.int64)
        rel = np.zeros((e, 3))
        sqrt_info = np.zeros((e, 3, 3))
        for k, ((i1, i2), (rp, si)) in enumerate(self._edges.items()):
            src[k] = self._id_to_idx[i1]
            dst[k] = self._id_to_idx[i2]
            rel[k] = rp
            sqrt_info[k] = si
        free = np.ones(n, np.float64)
        if self._first_id in self._id_to_idx:
            free[self._id_to_idx[self._first_id]] = 0.0
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
        self.corrections = [
            (nid, poses_out[i].copy()) for i, nid in enumerate(self._ids)
        ]
        for i in range(n):
            self._poses[i] = poses_out[i].copy()
        return self.corrections

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
        poses = np.zeros((n_pad, 3), np.float32)
        poses[:n] = np.stack(self._poses)
        src = np.full(e_pad, n_pad - 1, np.int64)
        dst = np.full(e_pad, n_pad - 1, np.int64)
        rel = np.zeros((e_pad, 3), np.float64)
        sqrt_info = np.zeros((e_pad, 3, 3), np.float64)
        emask = np.zeros(e_pad, bool)
        for k, ((i1, i2), (rp, si)) in enumerate(self._edges.items()):
            src[k] = self._id_to_idx[i1]
            dst[k] = self._id_to_idx[i2]
            rel[k] = rp
            sqrt_info[k] = si
            emask[k] = True
        free = np.ones(n_pad, np.float32)
        free[n:] = 0.0
        if self._first_id in self._id_to_idx:
            free[self._id_to_idx[self._first_id]] = 0.0
        out, chi2 = distributed_lm_solve(
            mesh, poses, src, dst, rel, sqrt_info, emask, free,
            max_iterations=cfg.max_iterations,
            initial_lambda=cfg.initial_lm_lambda,
            function_tolerance=cfg.function_tolerance,
            cg_iters=cfg.cg_max_iterations,
        )
        self.last_stats = {
            "n": n, "e": e, "chi2": chi2, "ranks": n_dev,
            "cg_iters": list(distributed_lm_solve.last_cg_iters),
        }
        result = np.asarray(out[:n], dtype=np.float64)
        self.corrections = [
            (nid, result[i].copy()) for i, nid in enumerate(self._ids)
        ]
        for i in range(n):
            self._poses[i] = result[i].copy()
        return self.corrections
