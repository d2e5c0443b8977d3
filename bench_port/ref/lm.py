"""The plain reference of the joint pose-graph solve.

Levenberg-Marquardt on SE(2) in float64 with NumPy and SciPy: the
whitened residual of each edge, its Jacobians, the sparse normal
equations over the free nodes, and each damped step solved exactly by a
sparse LU factorization (no preconditioner, no conjugate gradients). The
damping and the accept, reject and stop rules are the ones the program's
configuration states for its LM loop: lambda from 1e-4, each node's 3x3
diagonal block damped by lambda times its trace over 3 (and 1e-8), a step
kept when chi2 does not rise (lambda times 0.3, at least 1e-9; stop under
a relative decrease of 1e-3), else lambda times 10 (stop at 1e6).

Imports numpy and scipy only; nothing of the program.
"""
from __future__ import annotations

import numpy as np


def residuals(poses, src, dst, rel, si):
    """Whitened residuals (E, 3)."""
    pa, pb = poses[src], poses[dst]
    c, s = np.cos(pa[:, 2]), np.sin(pa[:, 2])
    dx, dy = pb[:, 0] - pa[:, 0], pb[:, 1] - pa[:, 1]
    dth = pb[:, 2] - pa[:, 2] - rel[:, 2]
    r = np.stack([c * dx + s * dy - rel[:, 0], -s * dx + c * dy - rel[:, 1],
                  np.arctan2(np.sin(dth), np.cos(dth))], axis=1)
    return np.einsum("eij,ej->ei", si, r)


def chi2(poses, src, dst, rel, si) -> float:
    r = residuals(poses, src, dst, rel, si)
    return float(np.sum(r * r))


def jacobians(poses, src, dst, si):
    """Whitened Jacobians (E, 3, 3) of each residual by pose a and b."""
    pa, pb = poses[src], poses[dst]
    c, s = np.cos(pa[:, 2]), np.sin(pa[:, 2])
    dx, dy = pb[:, 0] - pa[:, 0], pb[:, 1] - pa[:, 1]
    e = len(src)
    ja = np.zeros((e, 3, 3))
    jb = np.zeros((e, 3, 3))
    ja[:, 0, 0], ja[:, 0, 1], ja[:, 0, 2] = -c, -s, -s * dx + c * dy
    ja[:, 1, 0], ja[:, 1, 1], ja[:, 1, 2] = s, -c, -c * dx - s * dy
    ja[:, 2, 2] = -1.0
    jb[:, 0, 0], jb[:, 0, 1] = c, s
    jb[:, 1, 0], jb[:, 1, 1] = -s, c
    jb[:, 2, 2] = 1.0
    return np.einsum("eij,ejk->eik", si, ja), np.einsum("eij,ejk->eik", si,
                                                        jb)


def tf32(x: np.ndarray) -> np.ndarray:
    """x rounded to TF32 (float32's exponent, 10 bits of mantissa, to
    nearest, ties to even), the tensor cores' input format."""
    i = np.ascontiguousarray(x, np.float32).view(np.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(np.float32).astype(np.float64)


def _solve(h, rhs, products=None):
    """h x = rhs by a sparse LU factorization in the nodes' order (the
    chain keeps it banded). products="tf32" rounds the factors and each
    triangular solve's right-hand side to TF32."""
    from scipy.sparse.linalg import splu, spsolve_triangular

    lu = splu(h, permc_spec="NATURAL", diag_pivot_thresh=0.0,
              options={"SymmetricMode": True})
    if products != "tf32":
        return lu.solve(rhs)
    n = h.shape[0]
    if not (np.array_equal(lu.perm_r, np.arange(n))
            and np.array_equal(lu.perm_c, np.arange(n))):
        raise RuntimeError("the factorization pivoted")
    lo, up = lu.L.tocsr(), lu.U.tocsr()
    lo.data, up.data = tf32(lo.data), tf32(up.data)
    y = spsolve_triangular(lo, tf32(rhs), lower=True, unit_diagonal=True)
    return spsolve_triangular(up, tf32(y), lower=False)


def _step(poses, src, dst, rel, si, free, lam, products=None):
    """One damped Gauss-Newton step, solved exactly: the new poses.
    products="tf32" computes the step's products in TF32, as the tensor
    cores do: the Jacobians and residuals the normal equations are made
    of, the factors and the right-hand sides of the solve are rounded to
    it (the control that puts a TF32 reference in the program's
    place)."""
    import scipy.sparse as sp

    n = len(poses)
    r = residuals(poses, src, dst, rel, si)
    ja, jb = jacobians(poses, src, dst, si)
    if products == "tf32":
        r, ja, jb = tf32(r), tf32(ja), tf32(jb)
    haa = np.einsum("eji,ejk->eik", ja, ja)
    hbb = np.einsum("eji,ejk->eik", jb, jb)
    hab = np.einsum("eji,ejk->eik", ja, jb)
    diag = np.zeros((n, 3, 3))
    np.add.at(diag, src, haa)
    np.add.at(diag, dst, hbb)
    grad = np.zeros((n, 3))
    np.add.at(grad, src, -np.einsum("eji,ej->ei", ja, r))
    np.add.at(grad, dst, -np.einsum("eji,ej->ei", jb, r))
    tr = np.einsum("nii->n", diag)
    diag = diag + (lam * tr / 3.0 + 1e-8)[:, None, None] * np.eye(3)
    # the free nodes' system: fixed nodes take no step
    idx = np.full(n, -1)
    live = np.flatnonzero(free > 0)
    idx[live] = np.arange(len(live))
    m = len(live)
    both = (free[src] > 0) & (free[dst] > 0)
    a, b = idx[src[both]], idx[dst[both]]
    blocks = [(idx[live], idx[live], diag[live]),
              (a, b, hab[both]), (b, a, np.transpose(hab[both], (0, 2, 1)))]
    rows, cols, vals = [], [], []
    ii, jj = np.meshgrid(np.arange(3), np.arange(3), indexing="ij")
    for bi, bj, v in blocks:
        rows.append((3 * bi[:, None, None] + ii).ravel())
        cols.append((3 * bj[:, None, None] + jj).ravel())
        vals.append(v.ravel())
    h = sp.csc_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(3 * m, 3 * m))
    x = np.zeros((n, 3))
    x[live] = _solve(h, grad[live].reshape(-1), products).reshape(m, 3)
    new = poses + x
    new[:, 2] = np.arctan2(np.sin(new[:, 2]), np.cos(new[:, 2]))
    return new


def lm_solve(poses, src, dst, rel, si, free, max_iterations: int,
             initial_lambda: float = 1e-4,
             function_tolerance: float = 1e-3, products=None):
    """(poses (n, 3) float64, chi2) after at most `max_iterations` LM
    steps from `poses` (`products`: see _step)."""
    poses = np.asarray(poses, np.float64)
    src, dst = np.asarray(src, np.int64), np.asarray(dst, np.int64)
    rel, si = np.asarray(rel, np.float64), np.asarray(si, np.float64)
    free = np.asarray(free, np.float64)
    lam = initial_lambda
    cur = chi2(poses, src, dst, rel, si)
    for _ in range(max_iterations):
        new = _step(poses, src, dst, rel, si, free, lam, products)
        new_chi2 = chi2(new, src, dst, rel, si)
        if new_chi2 <= cur:
            rel_dec = (cur - new_chi2) / max(cur, 1e-30)
            poses, cur = new, new_chi2
            lam = max(lam * 0.3, 1e-9)
            if rel_dec < function_tolerance:
                break
        else:
            lam = min(lam * 10.0, 1e6)
            if lam >= 1e6:
                break
    return poses, cur
