"""Block-tridiagonal (odometry-chain) preconditioner for the pose-graph
normal equations.

PyTorch counterpart of slam_toolbox_tpu/solver/chain_precond.py. With a
block-Jacobi preconditioner, CG propagates information roughly one graph
hop per iteration, so chain-like pose graphs need O(n) iterations for a
loop closure to traverse the chain. Pose graphs are odometry chains plus
sparse loop edges, so the tridiagonal part of H (consecutive-node
couplings + the damped diagonal) is an excellent preconditioner: it
solves the chain exactly, leaving CG to handle only the loop edges.

Two solvers of the block-tridiagonal system:
  - chain_factorize / chain_apply: a block Thomas (LDL^T) factorization
    and its two sweeps, sequential over the n 3x3 blocks. On a card each
    call is one launch of K9 (csrc/chain_thomas.cu); their plain versions,
    factorize / apply (Python loops of small tensor ops), run for CPU
    tensors. lm_solve's PCG step uses them below 4,096 (padded) nodes,
    which PoseGraphSolver.compute never reaches: it pads past the dense
    ceiling to at least 4,096.
  - pcr_solve: parallel cyclic reduction, O(log n) steps of batched 3x3
    block ops; the large-graph preconditioner and the distributed solve's
    chain preconditioner (dist/solver_dist.py, schwarz=False).
"""
from __future__ import annotations

import torch

from slam_toolbox_tpu_torch.kernels import match_cuda as mc


def _inv3(m):
    """Explicit batched 3x3 inverse (adjugate / det) of (..., 3, 3), with
    |det| below 1e-20 clamped to 1e-20 as the JAX package clamps it."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = torch.where(det.abs() < 1e-20, torch.full_like(det, 1e-20), det)
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), (b * f - c * e)], -1),
        torch.stack([B, (a * i - c * g), -(a * f - c * d)], -1),
        torch.stack([C, -(a * h - b * g), (a * e - b * d)], -1),
    ], -2)
    return adj / det[..., None, None]


def scatter_add(out, index, values):
    """out[index] += values in place, index a tensor or a tuple of them;
    returns out. The solvers' one scatter sum: index_put_ with accumulate
    sorts the indices on a card and adds in that order (index_add_ adds
    with float atomics in the order threads reach them), so a solve
    repeats bit for bit; on the CPU it sums as index_add_ does."""
    if not isinstance(index, tuple):
        index = (index,)
    return out.index_put_(index, values, accumulate=True)


def build_chain_offdiag(hab, src, dst, n_nodes: int, free):
    """U (n-1, 3, 3): coupling H[i, i+1] restricted to consecutive solver
    indices; edges touching gauge-fixed nodes are dropped so the
    preconditioner respects the projection."""
    e_free = free[src] * free[dst]  # (E,)
    fwd = dst == src + 1
    bwd = src == dst + 1
    sink = n_nodes - 1   # one past U's last row: dropped
    U = hab.new_zeros((n_nodes, 3, 3))
    scatter_add(U, torch.where(fwd, src, sink),
                hab * (fwd * e_free)[:, None, None])
    scatter_add(U, torch.where(bwd, dst, sink),
                hab.transpose(-1, -2) * (bwd * e_free)[:, None, None])
    return U[:sink]


def factorize(diag_damped, U, free):
    """Block Thomas factorization. Returns (Sinv (n,3,3), T (n-1,3,3),
    W (n-1,3,3)) where S_i = D_i - U_{i-1}^T Sinv_{i-1} U_{i-1},
    T_i = U_i^T Sinv_i (forward sweep operator), W_i = Sinv_i U_i."""
    eye = torch.eye(3, dtype=diag_damped.dtype, device=diag_damped.device)
    # project fixed nodes to identity rows
    D = torch.where(free[:, None, None] > 0, diag_damped, eye)
    Sinv = [_inv3(D[0])]
    for k in range(U.shape[0]):
        u = U[k]
        Sinv.append(_inv3(D[k + 1] - u.T @ Sinv[-1] @ u))
    Sinv = torch.stack(Sinv)
    T = U.transpose(1, 2) @ Sinv[:-1]
    W = Sinv[:-1] @ U
    return Sinv, T, W


def pcr_solve(D, U, r, free, n_steps: int):
    """Parallel cyclic reduction solve of the block-tridiagonal system
    (D_i diagonal blocks, U_i = M[i, i+1]): O(log n) depth with batched
    3x3 block ops, against the O(n) span of the Thomas sweeps.

    a_i z_{i-1} + b_i z_i + c_i z_{i+1} = r_i with a_i = U_{i-1}^T,
    c_i = U_i; each PCR step eliminates neighbors at distance 2^k.
    """
    n = D.shape[0]
    dev, dt = D.device, D.dtype
    eye = torch.eye(3, dtype=dt, device=dev)
    B = torch.where(free[:, None, None] > 0, D, eye)
    zero_blk = D.new_zeros((1, 3, 3))
    A = torch.cat([zero_blk, U.transpose(1, 2)], 0)  # (n,3,3) sub-diagonal
    C = torch.cat([U, zero_blk], 0)                   # super-diagonal
    R = r * free[:, None]
    idx = torch.arange(n, device=dev)

    def shift_up(x, s):  # x[i - s], zero-padded
        return torch.cat([x.new_zeros((s,) + x.shape[1:]), x[:n - s]], 0)

    def shift_down(x, s):  # x[i + s], zero-padded
        return torch.cat([x[s:], x.new_zeros((s,) + x.shape[1:])], 0)

    for k in range(n_steps):
        s = 1 << k
        if s >= n:
            break
        # the neighbors' diagonal blocks, out-of-range ones the identity,
        # inverted: the shifted inverses of B (one _inv3 per step; the
        # identity inverts to itself exactly)
        Binv = _inv3(B)
        Bm_inv = shift_up(Binv, s) + torch.where(
            (idx < s)[:, None, None], eye, 0.0)
        Bp_inv = shift_down(Binv, s) + torch.where(
            (idx >= n - s)[:, None, None], eye, 0.0)
        Am, Cp = shift_up(A, s), shift_down(C, s)
        Rm, Rp = shift_up(R, s), shift_down(R, s)
        Cm, Ap = shift_up(C, s), shift_down(A, s)
        alpha = -(A @ Bm_inv)
        gamma = -(C @ Bp_inv)
        B = B + alpha @ Cm + gamma @ Ap
        R = R + (alpha @ Rm[..., None])[..., 0] + (gamma @ Rp[..., None])[..., 0]
        A = alpha @ Am
        C = gamma @ Cp

    z = (_inv3(B) @ R[..., None])[..., 0]
    return z * free[:, None]


def apply(Sinv, T, W, r, free):
    """Solve M z = r with the factorization (two sequential sweeps)."""
    r = r * free[:, None]
    n = r.shape[0]
    y = [r[0]]
    for i in range(1, n):
        y.append(r[i] - T[i - 1] @ y[-1])
    w = (Sinv @ torch.stack(y)[..., None])[..., 0]
    z = [w[n - 1]]
    for i in range(n - 2, -1, -1):
        z.append(w[i] - W[i] @ z[-1])
    return torch.stack(z[::-1]) * free[:, None]


def _check_chain(name, t, shape, like):
    mc._check(t, name, like.dtype, shape, like.device)


def _dbl(t) -> int:
    if t.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"chain_thomas: dtype {t.dtype}, expected float32 "
                        f"or float64")
    return int(t.dtype == torch.float64)


def chain_factorize(D, U, free):
    """factorize (Sinv, T, W) of D (n,3,3), U (n-1,3,3) and free (n,), f32
    or f64, any n >= 1: one launch of K9 (csrc/chain_thomas.cu) for CUDA
    tensors, the plain version for CPU ones."""
    n = D.shape[0]
    dbl = _dbl(D)
    _check_chain("D", D, (n, 3, 3), D)
    _check_chain("U", U, (n - 1, 3, 3), D)
    _check_chain("free", free, (n,), D)
    if not mc._on_cuda(D.device):
        return factorize(D, U, free)
    lib = mc._lib("chain_thomas")
    Sinv = torch.empty_like(D)
    T = torch.empty_like(U)
    W = torch.empty_like(U)
    mc._raise_if(lib.chain_factorize(
        D.data_ptr(), U.data_ptr(), free.data_ptr(), n, dbl, Sinv.data_ptr(),
        T.data_ptr(), W.data_ptr(), mc._stream()), "chain_factorize")
    mc._count("chain_thomas", n)
    return Sinv, T, W


def chain_apply(Sinv, T, W, r, free):
    """apply (z = M^-1 r, masked by free) with chain_factorize's factors,
    r (n,3): one launch of K9 for CUDA tensors, the plain version for CPU
    ones."""
    n = Sinv.shape[0]
    dbl = _dbl(Sinv)
    _check_chain("Sinv", Sinv, (n, 3, 3), Sinv)
    _check_chain("T", T, (n - 1, 3, 3), Sinv)
    _check_chain("W", W, (n - 1, 3, 3), Sinv)
    _check_chain("r", r, (n, 3), Sinv)
    _check_chain("free", free, (n,), Sinv)
    if not mc._on_cuda(Sinv.device):
        return apply(Sinv, T, W, r, free)
    lib = mc._lib("chain_thomas")
    z = torch.empty_like(r)
    mc._raise_if(lib.chain_apply(
        Sinv.data_ptr(), T.data_ptr(), W.data_ptr(), r.data_ptr(),
        free.data_ptr(), n, dbl, z.data_ptr(), mc._stream()), "chain_apply")
    mc._count("chain_thomas", n)
    return z
