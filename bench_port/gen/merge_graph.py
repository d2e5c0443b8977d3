"""The benchmark's frozen multi-session joint pose graph.

A vectorized copy of workloads_torch.py's config-5 graph (merge_pose,
merge_origins, the MERGE_* constants and joint_graph, which copy
scripts/bench_merge500k.py). It needs no scans, no snapshots and no
MapMerger: each node's corrected pose is its true serpentine pose plus
the build's residual noise, and the graph is made from those poses with
joint_graph's structure, noise and information matrices:
  - every session's chain, relative-pose noise N(0, CHAIN_NOISE),
    covariance COV_ODOM;
  - every CROSS_EVERY-th node of session s linked to its nearest node of
    session s - 1 where that one is closer than 1 m, noise
    N(0, CROSS_NOISE), covariance COV_CROSS;
  - nodes padded to the next power of two; node 0 and the padding fixed.
The noise is drawn from one generator in joint_graph's order (each
session's node noise, then the chain's, then the cross edges'), so seed 7
gives the script's graph (tests/test_bench_port_gen.py holds the
structure to joint_graph's).

Imports numpy and scipy.
"""
from __future__ import annotations

import numpy as np

SESSIONS = 8
NODES_PER = 62500
STEP = 0.3
PER_AISLE = int(60.0 / STEP)   # 200 nodes an aisle
NODE_NOISE = (0.02, 0.02, 0.005, 0.05, 0.05, 0.01)
CHAIN_NOISE = (0.002, 0.002, 0.0005)
CROSS_NOISE = 0.004
CROSS_EVERY = 64
COV_ODOM = (1e-3, 1e-3, 1e-4)
COV_CROSS = (4e-3, 4e-3, 4e-4)


def origins(sessions: int, nodes_per: int):
    """Each session's first aisle's y (merge_origins)."""
    n_aisles = (nodes_per + PER_AISLE - 1) // PER_AISLE
    off_aisles = n_aisles - 1
    if off_aisles % 2:
        off_aisles -= 1
    return [s * off_aisles * 2.0 for s in range(sessions)]


def true_poses(nodes: int, y0: float) -> np.ndarray:
    """merge_pose(i, y0) for i < nodes: east on even aisles, west on odd
    ones, 2 m apart from y0."""
    i = np.arange(nodes)
    aisle, k = np.divmod(i, PER_AISLE)
    even = aisle % 2 == 0
    x = np.where(even, k * STEP, (PER_AISLE - 1 - k) * STEP)
    y = y0 + aisle * 2.0
    return np.stack([x, y, np.where(even, 0.0, np.pi)], axis=1)


def relative(p1, p2) -> np.ndarray:
    """geometry.relative_pose on (n, 3) arrays."""
    c, s = np.cos(p1[:, 2]), np.sin(p1[:, 2])
    dx, dy = p2[:, 0] - p1[:, 0], p2[:, 1] - p1[:, 1]
    h = p2[:, 2] - p1[:, 2]
    return np.stack([c * dx + s * dy, -s * dx + c * dy,
                     np.arctan2(np.sin(h), np.cos(h))], axis=1)


def sqrt_info(cov) -> np.ndarray:
    return np.linalg.cholesky(np.linalg.inv(np.diag(cov))).T


def corrected_poses(sessions: int, nodes_per: int, rng):
    """Each session's corrected poses: true pose plus the build's node
    noise, drawn from `rng` session by session as build_merge_session
    draws it ((nodes, 6): the corrected pose's, then the odometry's)."""
    out = []
    for y0 in origins(sessions, nodes_per):
        noise = rng.normal(0.0, NODE_NOISE, size=(nodes_per, 6))
        out.append(true_poses(nodes_per, y0) + noise[:, :3])
    return out


def joint_graph(sessions: int = SESSIONS, nodes_per: int = NODES_PER,
                seed: int = 7) -> dict:
    """The joint graph's solve arrays (poses f32 (n_pad, 3), src, dst,
    rel, sqrt_info, emask, free) and its counts, from `seed`."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    subs = corrected_poses(sessions, nodes_per, rng)
    n = sessions * nodes_per
    n_pad = 1
    while n_pad < n:
        n_pad <<= 1
    poses = np.zeros((n_pad, 3), np.float32)
    c = np.concatenate(subs)
    poses[:n] = c
    bases = np.arange(sessions) * nodes_per
    src = np.concatenate([b + np.arange(nodes_per - 1) for b in bases])
    n_chain = len(src)
    rel = relative(c[src], c[src + 1]) + rng.normal(
        0.0, CHAIN_NOISE, size=(n_chain, 3))
    dst = src + 1
    xs, xd, xr = [], [], []
    for s in range(1, sessions):
        a, b = subs[s - 1], subs[s]
        q = np.arange(0, nodes_per, CROSS_EVERY)
        # the nearest node of a within reach of each query (cKDTree's
        # nearest is joint_graph's argmin but at exact ties)
        _, j = cKDTree(a[:, :2]).query(b[q, :2], distance_upper_bound=1.5)
        hit = j < nodes_per
        q, j = q[hit], j[hit]
        ok = np.hypot(*(a[j, :2] - b[q, :2]).T) < 1.0
        q, j = q[ok], j[ok]
        xs.append(bases[s - 1] + j)
        xd.append(bases[s] + q)
        xr.append(relative(a[j], b[q]))
    xs = np.concatenate(xs).astype(np.int64)
    xd = np.concatenate(xd).astype(np.int64)
    n_cross = len(xs)
    if n_cross:
        x_rel = np.concatenate(xr) + rng.normal(
            0.0, CROSS_NOISE, size=(n_cross, 3))
        src = np.concatenate([src, xs])
        dst = np.concatenate([dst, xd])
        rel = np.concatenate([rel, x_rel])
    si = np.concatenate([
        np.broadcast_to(sqrt_info(COV_ODOM), (n_chain, 3, 3)),
        np.broadcast_to(sqrt_info(COV_CROSS), (n_cross, 3, 3))])
    free = np.ones(n_pad, np.float32)
    free[n:] = 0
    free[0] = 0
    e = n_chain + n_cross
    return dict(poses=poses, src=src.astype(np.int64),
                dst=dst.astype(np.int64), rel=rel, sqrt_info=si,
                emask=np.ones(e, bool), free=free, n=n, n_pad=n_pad,
                n_chain=n_chain, n_cross=n_cross)
