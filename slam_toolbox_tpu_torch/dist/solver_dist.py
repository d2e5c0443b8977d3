"""Distributed SE(2) pose-graph solve over the ranks of a process group.

PyTorch counterpart of slam_toolbox_tpu/dist/solver_dist.py. Edges of the
pose graph are sharded across ranks (one rank per device), each rank
builds its shard's contribution to the Gauss-Newton normal equations, the
block diagonal and gradient are summed with all_reduce (JAX's psum), and
the PCG iteration runs with a distributed Hx product (local off-diagonal
scatter + one all_reduce per product). Poses are replicated: at SLAM sizes
the pose vector is tiny; it is the per-edge work that shards.

Every rank runs the same host loop on the same full arrays and slices its
own edge shard from them, so every rank makes the same collectives in the
same order. The loops' branches (CG stop and stagnation tests, LM accept
and stop) read only values that are all-reduced or computed from
all-reduced values by the same operations on every rank, so the ranks
never diverge.

The dense factors (the Schwarz blocks and the coarse operator) are
factored and solved with torch.linalg.cholesky / torch.cholesky_solve, as
the JAX package uses its linear-algebra library outside any kernel.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from slam_toolbox_tpu_torch.solver import chain_precond as cp
from slam_toolbox_tpu_torch.solver.se2_solver import (
    edge_jacobians, edge_residual,
)


def _local_normal(poses, src, dst, rel, sqrt_info, emask, n_nodes):
    """This shard's diag blocks (N,3,3), per-edge off-diagonal blocks
    (E,3,3), gradient (N,3) and chi2."""
    r = edge_residual(poses, src, dst, rel, sqrt_info, emask)
    ja, jb = edge_jacobians(poses, src, dst, sqrt_info, emask)
    haa = torch.einsum("eji,ejk->eik", ja, ja)
    hbb = torch.einsum("eji,ejk->eik", jb, jb)
    hab = torch.einsum("eji,ejk->eik", ja, jb)
    diag = poses.new_zeros((n_nodes, 3, 3))
    diag.index_add_(0, src, haa)
    diag.index_add_(0, dst, hbb)
    grad = poses.new_zeros((n_nodes, 3))
    grad.index_add_(0, src, -torch.einsum("eji,ej->ei", ja, r))
    grad.index_add_(0, dst, -torch.einsum("eji,ej->ei", jb, r))
    return diag, hab, grad, torch.sum(r * r)


def make_distributed_gn_step(
    mesh, n_nodes: int, cg_iters: int = 50, schwarz: bool = True,
    block: int = 512, cblock: int = 64, cg_rtol: float = None,
    max_coarse: int = 2048,
):
    """Returns a function computing one damped GN step on this rank.

    Inputs: poses (N,3) and free (N,) replicated tensors on mesh.device;
    src/dst (E_s,), rel (E_s,3), sqrt_info (E_s,3,3), emask (E_s,) bool
    and plocal (E_s,) bool this rank's edge shard; lm_lambda a float.
    Output: (new_poses (N,3), chi2 tensor, cg iterations used), the same
    on every rank.

    Preconditioner (schwarz=True, the default): two-level Schwarz. Level
    1 is block-Jacobi over fixed-size contiguous node blocks (`block`
    nodes; a rank owns n/(size*block) blocks and batch-Cholesky-factors
    them once per GN step); every intra-block loop edge is inside the
    factor (`plocal` marks them). Level 2 is a coarse-space correction
    with one rigid-body aggregate of cb nodes per coarse block (the
    pose-graph Hessian's near-null space is the global rigid motions),
    its Galerkin operator assembled from the edge shards (one all_reduce)
    and factored on every rank. The two levels are applied as a
    symmetrized V-cycle (fine, coarse, fine), which is SPD, so CG theory
    holds; iteration counts stay bounded independent of graph size and
    of rank count. With schwarz=False: the odometry-chain preconditioner
    (the chain's coupling blocks all-reduced, then the same parallel
    cyclic reduction on every rank)."""
    n_dev = mesh.size
    nb = n_nodes // n_dev
    assert nb * n_dev == n_nodes, "pad nodes to a multiple of the mesh size"
    block = min(block, nb)
    assert nb % block == 0, "block size must divide the per-rank slice"
    bpd = nb // block  # blocks per rank
    start = mesh.rank * nb

    def step(poses, src, dst, rel, sqrt_info, emask, plocal, free,
             lm_lambda):
        dt, dev = poses.dtype, poses.device
        diag, hab, grad, chi2 = _local_normal(
            poses, src, dst, rel, sqrt_info, emask, n_nodes)
        # reduce the block diagonal, gradient and chi2 over the shards
        mesh.all_reduce(diag)
        mesh.all_reduce(grad)
        chi2 = mesh.all_reduce(chi2.reshape(1))[0]

        eye = torch.eye(3, dtype=dt, device=dev)
        damp = (lm_lambda * torch.einsum("nii->n", diag)[:, None, None]
                * eye / 3.0)
        diag_d = diag + damp + 1e-8 * eye
        b = grad * free[:, None]

        def mv(x):
            x = x * free[:, None]
            local = torch.zeros_like(x)
            local.index_add_(0, src, torch.einsum("eij,ej->ei", hab, x[dst]))
            local.index_add_(0, dst, torch.einsum("eji,ej->ei", hab, x[src]))
            # off-diagonal contributions live on edge shards -> all_reduce;
            # the (replicated) damped diagonal is applied once
            out = torch.einsum("nij,nj->ni", diag_d, x) + mesh.all_reduce(
                local)
            return out * free[:, None]

        if schwarz:
            # this rank's block-diagonal dense factors: intra-block
            # off-diagonal edge blocks scattered into (bpd, block, block,
            # 3, 3) (block index bpd is the sink for crossing and foreign
            # edges), each block's diagonal overwritten with the reduced
            # damped diagonal, then one batched Cholesky
            rel_s = src - start
            rel_d = dst - start
            blk = torch.where(plocal, torch.div(rel_s, block,
                                                rounding_mode="floor"), bpd)
            s_off = torch.where(plocal, rel_s % block, 0)
            d_off = torch.where(plocal, rel_d % block, 0)
            H5 = poses.new_zeros((bpd + 1, block, block, 3, 3))
            H5.index_put_((blk, s_off, d_off), hab, accumulate=True)
            H5.index_put_((blk, d_off, s_off), hab.transpose(1, 2),
                          accumulate=True)
            H5 = H5[:bpd]
            rng = torch.arange(block, device=dev)
            H5[:, rng, rng] = diag_d[start:start + nb].reshape(
                bpd, block, 3, 3)
            free_l = free[start:start + nb].reshape(bpd, block)
            # fixed/padding nodes: identity rows/cols keep each factor SPD
            H5 = (H5 * free_l[:, :, None, None, None]
                  * free_l[:, None, :, None, None])
            H5[:, rng, rng] += eye * (1.0 - free_l)[:, :, None, None]
            Hd = H5.permute(0, 1, 3, 2, 4).reshape(bpd, block * 3,
                                                     block * 3)
            del H5
            chol = torch.linalg.cholesky(Hd)   # batched over blocks
            del Hd

            # coarse space: per-aggregate rigid-body modes. At node i of
            # an aggregate with centroid c the prolongation is
            # P_i = [[1,0,-(py-cy)], [0,1,px-cx], [0,0,1]]; the Galerkin
            # A_c = P^T F A F P takes its off-diagonal part from the edge
            # shards (all_reduce) and folds the replicated damped diagonal
            # in locally. max_coarse caps the aggregate count so the
            # replicated dense coarse factor stays cheap
            cb = cblock
            while n_nodes // cb > max_coarse:
                cb *= 2
            cb = min(cb, n_nodes)
            while n_nodes % cb:
                cb *= 2
            NB = n_nodes // cb
            blk_of = torch.div(torch.arange(n_nodes, device=dev), cb,
                               rounding_mode="floor")
            w_node = free  # fixed/padding nodes excluded from the space
            # per-aggregate centroid of free nodes (poses are replicated,
            # so every rank computes the same centroids)
            cent_n = poses.new_zeros((NB, 2)).index_add_(
                0, blk_of, poses[:, :2] * w_node[:, None])
            cent_d = poses.new_zeros((NB,)).index_add_(0, blk_of, w_node)
            cent = cent_n / torch.clamp_min(cent_d, 1.0)[:, None]
            rel_xy = poses[:, :2] - cent[blk_of]
            z0 = torch.zeros_like(rel_xy[:, 0])
            o1 = torch.ones_like(z0)
            P_all = torch.stack([
                torch.stack([o1, z0, -rel_xy[:, 1]], -1),
                torch.stack([z0, o1, rel_xy[:, 0]], -1),
                torch.stack([z0, z0, o1], -1),
            ], -2)                                       # (n, 3, 3)
            wfree = (free[src] * free[dst]) * emask.to(dt)
            # edge contribution: P_s^T hab P_d into aggregate pair (bs, bd)
            hab_c = torch.einsum("eji,ejk,ekl->eil", P_all[src], hab,
                                 P_all[dst]) * wfree[:, None, None]
            cbs = torch.where(emask, torch.div(src, cb,
                                               rounding_mode="floor"), NB)
            cbd = torch.where(emask, torch.div(dst, cb,
                                               rounding_mode="floor"), NB)
            Ac = poses.new_zeros((NB + 1, NB + 1, 3, 3))
            Ac.index_put_((cbs, cbd), hab_c, accumulate=True)
            Ac.index_put_((cbd, cbs), hab_c.transpose(1, 2),
                          accumulate=True)
            Ac = mesh.all_reduce(Ac[:NB, :NB].contiguous())
            diag_c = torch.einsum("nji,njk,nkl->nil", P_all, diag_d,
                                  P_all) * w_node[:, None, None]
            Ac.index_put_((blk_of, blk_of), diag_c, accumulate=True)
            Acd = Ac.permute(0, 2, 1, 3).reshape(NB * 3, NB * 3)
            # tiny Tikhonov keeps empty/fixed-only aggregates SPD
            Acd = Acd + torch.eye(NB * 3, dtype=dt, device=dev) * (
                1e-8 * torch.trace(Acd) / (NB * 3) + 1e-12)
            chol_c = torch.linalg.cholesky(Acd)
            free_nb = free_l.reshape(nb)[:, None]

            def fine(r):
                r_l = r[start:start + nb].reshape(bpd, block * 3, 1)
                z_l = torch.cholesky_solve(r_l, chol)
                z = torch.zeros_like(r)
                z[start:start + nb] = z_l.reshape(nb, 3) * free_nb
                return mesh.all_reduce(z) * free[:, None]

            def coarse(r):
                # restrict: rc[b] = sum_{i in b} P_i^T r_i (free only)
                rn = torch.einsum("nji,nj->ni", P_all, r * w_node[:, None])
                rc = poses.new_zeros((NB, 3)).index_add_(0, blk_of, rn)
                zc = torch.cholesky_solve(rc.reshape(NB * 3, 1),
                                          chol_c).reshape(NB, 3)
                # prolong: z_i = P_i zc[b(i)]
                z = torch.einsum("nij,nj->ni", P_all, zc[blk_of])
                return z * w_node[:, None]

            def prec(r):
                # symmetrized multiplicative two-level V-cycle (fine ->
                # coarse -> fine); a one-sided sweep is not symmetric and
                # breaks CG's recurrences
                z1 = fine(r)
                z2 = z1 + coarse(r - mv(z1))
                return z2 + fine(r - mv(z2))
        else:
            U = mesh.all_reduce(
                cp.build_chain_offdiag(hab, src, dst, n_nodes, free)
                .contiguous())
            pcr_steps = int(math.ceil(math.log2(max(n_nodes, 2)))) + 1

            def prec(r):
                return cp.pcr_solve(diag_d, U, r, free, pcr_steps)

        x = torch.zeros_like(b)
        r = b - mv(x)
        p = prec(r)
        rz = torch.sum(r * p)
        # relative termination, dtype-aware: r stops being resolvable in
        # f32 around 1e-5 * ||b|| (1e-11 in f64)
        rtol = cg_rtol if cg_rtol is not None else (
            1e-11 if dt == torch.float64 else 1e-5)
        rr_stop = torch.tensor(rtol * rtol, dtype=dt, device=dev) * torch.sum(
            b * b)
        rr_ckpt = torch.sum(r * r)
        i = 0
        # rz <= 0 means the preconditioned residual is at the dtype's
        # noise floor (prec is SPD analytically)
        while i < cg_iters and bool((torch.sum(r * r) > rr_stop) & (rz > 0)):
            hp = mv(p)
            alpha = rz / torch.clamp_min(torch.sum(p * hp), 1e-30)
            x = x + alpha * p
            # periodic true-residual restart against recurrence drift; it
            # doubles as a stagnation probe: if a whole restart period
            # bought less than a 2x residual reduction, the dtype's floor
            # is reached: stop
            restart = i % 32 == 31
            r = b - mv(x) if restart else r - alpha * hp
            stalled = False
            if restart:
                rr = torch.sum(r * r)
                stalled = bool(rr > 0.25 * rr_ckpt)
                rr_ckpt = rr
            z = prec(r)
            rz_new = torch.sum(r * z)
            p = z if restart else z + rz_new / torch.clamp_min(rz, 1e-30) * p
            rz = rz_new
            i = cg_iters if stalled else i + 1

        new_poses = poses + x
        new_poses[:, 2] = torch.atan2(torch.sin(new_poses[:, 2]),
                                      torch.cos(new_poses[:, 2]))
        return new_poses, chi2, i

    return step


def make_distributed_chi2(mesh):
    """Replicated chi2 from the edge shards (one all_reduce): the LM
    accept/reject probe, far cheaper than a full GN step."""

    def f(poses, src, dst, rel, sqrt_info, emask):
        r = edge_residual(poses, src, dst, rel, sqrt_info, emask)
        return mesh.all_reduce(torch.sum(r * r).reshape(1))[0]

    return f


def partition_edges(src, dst, rel, sqrt_info, emask, n_dev: int, nb: int,
                    block: int):
    """Edges grouped by owning rank (the node slice of their lower
    endpoint), each rank's group in input order, padded to the largest
    group (`shard_e`): (src, dst, rel, sqrt_info, emask, plocal), each of
    shard_e * n_dev rows, rank d's shard at rows [d * shard_e, (d + 1) *
    shard_e). plocal marks the edges inside one Schwarz block; crossing
    edges stay in their lower endpoint's shard and enter only Hx."""
    n_pad = n_dev * nb
    src = np.asarray(src).astype(np.int64)
    dst = np.asarray(dst).astype(np.int64)
    emask = np.asarray(emask, bool)
    owner = np.where(emask, np.minimum(src, dst) // nb, 0).astype(np.int64)
    plocal = emask & ((src // block) == (dst // block))
    live = np.flatnonzero(emask)
    counts = np.bincount(owner[live], minlength=n_dev)
    shard_e = int(max(1, counts.max()))
    # position of each live edge: its owner's base + its rank among the
    # owner's edges in input order
    order = live[np.argsort(owner[live], kind="stable")]
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = np.arange(len(order)) - first[owner[order]]
    pos = owner[order] * shard_e + within
    e2 = shard_e * n_dev
    src2 = np.full(e2, n_pad - 1, np.int64)
    dst2 = np.full(e2, n_pad - 1, np.int64)
    rel2 = np.zeros((e2, 3), rel.dtype)
    si2 = np.zeros((e2, 3, 3), sqrt_info.dtype)
    em2 = np.zeros(e2, bool)
    pl2 = np.zeros(e2, bool)
    src2[pos], dst2[pos] = src[order], dst[order]
    rel2[pos] = rel[order]
    si2[pos] = sqrt_info[order]
    em2[pos] = True
    pl2[pos] = plocal[order]
    return (src2, dst2, rel2, si2, em2, pl2), shard_e


def distributed_lm_solve(
    mesh,
    poses: np.ndarray,       # (N,3)
    src: np.ndarray, dst: np.ndarray,
    rel: np.ndarray, sqrt_info: np.ndarray, emask: np.ndarray,
    free: np.ndarray,
    max_iterations: int = 50,
    initial_lambda: float = 1e-4,
    function_tolerance: float = 1e-3,
    cg_iters: int = 200,
    block: int = 512,
    cblock: int = None,
    cg_rtol: float = None,
    dtype=np.float32,
    max_coarse: int = None,
    schwarz: bool = True,
):
    """Host LM loop over the distributed GN step; every rank calls it with
    the same full arrays (every process builds the same graph
    deterministically) and takes its own edge shard. Edge arrays must be
    padded to a multiple of the mesh size, nodes too.

    cg_iters is a bounded budget: the two-level Schwarz preconditioner
    keeps the iteration count bounded independent of n and of the rank
    count. dtype=np.float64 runs the whole solve (residuals, reductions,
    CG recurrences) in f64 for sub-mm parity with the host solver.
    Returns (poses (N,3) numpy in `dtype`, chi2); the CG iterations of
    each LM step are left in distributed_lm_solve.last_cg_iters."""
    n_dev = mesh.size
    f64 = np.dtype(dtype) == np.float64
    if cblock is None:
        # f64 runs CG to rtol 1e-11: the extra decades of convergence need
        # a richer coarse space (16-node aggregates) to stay flat; f32's
        # resolvability floor never exercises them, so 64 stays there
        cblock = 16 if f64 else 64
    if max_coarse is None:
        # f64: let the 16-node aggregates survive to ~64k nodes; f32 keeps
        # the cheap 2048 cap
        max_coarse = 4096 if f64 else 2048
    e = len(src)
    assert e % n_dev == 0, "pad edges to a multiple of the mesh size"
    n_pad = len(poses)
    assert n_pad % n_dev == 0, "pad nodes to a multiple of the mesh size"
    nb = n_pad // n_dev
    block_g = min(block, nb)

    step = make_distributed_gn_step(
        mesh, n_pad, cg_iters=cg_iters, schwarz=schwarz, block=block_g,
        cblock=cblock, cg_rtol=cg_rtol, max_coarse=max_coarse,
    )
    (src2, dst2, rel2, si2, em2, pl2), shard_e = partition_edges(
        src, dst, rel, sqrt_info, emask, n_dev, nb, block_g)
    lo, hi = mesh.rank * shard_e, (mesh.rank + 1) * shard_e
    dev = mesh.device
    tdt = torch.float64 if f64 else torch.float32

    def put(a, dt=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=dev, dtype=dt)

    poses_t = put(poses, tdt)
    args = (put(src2[lo:hi]), put(dst2[lo:hi]), put(rel2[lo:hi], tdt),
            put(si2[lo:hi], tdt), put(em2[lo:hi]))
    plocal = put(pl2[lo:hi])
    free_t = put(free, tdt)

    chi2_fn = make_distributed_chi2(mesh)
    lam = initial_lambda
    chi2 = None
    cg_iter_log = []
    for _ in range(max_iterations):
        new_poses, cur_chi2, cg_used = step(
            poses_t, *args, plocal, free_t, lam)
        cg_iter_log.append(int(cg_used))
        if chi2 is None:
            chi2 = float(cur_chi2)
        # evaluate the proposal with the cheap chi2-only collective
        new_chi2 = float(chi2_fn(new_poses, *args))
        if new_chi2 <= chi2:
            rel_dec = (chi2 - new_chi2) / max(chi2, 1e-30)
            poses_t = new_poses
            chi2 = new_chi2
            lam = max(lam * 0.3, 1e-9)
            if rel_dec < function_tolerance:
                break
        else:
            lam = min(lam * 10.0, 1e6)
            if lam >= 1e6:
                break
    distributed_lm_solve.last_cg_iters = cg_iter_log
    return poses_t.cpu().numpy(), chi2
