"""Marginalization-on-removal for bounded pose graphs.

The reference deletes a removed node's constraints outright
(RemoveNodeFromGraph, Mapper.cpp:2964-3021), so bounding the graph
(lifelong decay, localization eviction) throws away the information that
anchored old geometry — measured 3x worse survivors-ATE on a 40-lap
warehouse (CONFIG3.json round 3). This module instead replaces the
removed node's star of edges with relative-pose factors among its
neighbors, so the graph stays bounded in NODES while keeping the
constraints' information:

- The removed node's incident edges are re-oriented to point away from
  it, then composed pairwise THROUGH the node along a spanning chain of
  its neighbors (ordered by state id). First-order covariance
  compounding (Smith-Self-Cheeseman) gives each new factor's
  covariance; for a degree-2 node (the dominant decay case: a chain
  node with prev/next) this equals the Gauss-Newton Schur complement of
  the eliminated variable at the current linearization point.
- A constituent edge reused by m chain factors has its covariance
  inflated by m, keeping the composite information CONSERVATIVE (never
  counts an original measurement twice).
- A factor whose endpoint pair is already directly constrained is
  dropped (the solver keys constraints by pair; replacing the direct
  measurement with a composite would lose information, double-adding
  would overcount).

No reference counterpart (its lifelong mode is experimental and
delete-only); SURVEY §5 north star "graph edits over the sharded pose
graph".

The port's copy of slam_toolbox_tpu/graph/marginal.py: host NumPy in f64
on the port's PoseGraph and solver.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from slam_toolbox_tpu_torch.core import geometry


def _edge_from(edge, scan):
    """(rel, cov, other_scan) with the edge re-oriented so `scan` is the
    source. Edge covariance lives in the source frame (Mapper.h:183-187);
    inverting transforms it with the SE(2) inverse Jacobian."""
    if edge.source is scan:
        return edge.rel_pose, edge.covariance, edge.target
    r = np.asarray(edge.rel_pose, np.float64)
    cov = np.asarray(edge.covariance, np.float64)
    x, y = r[0], r[1]
    c, s = np.cos(r[2]), np.sin(r[2])
    rel_inv = np.asarray(geometry.inverse(r))
    j = np.array([
        [-c, -s, s * x - c * y],
        [s, -c, c * x + s * y],
        [0.0, 0.0, -1.0],
    ])
    return rel_inv, j @ cov @ j.T, edge.source


def compose_with_cov(r1, cov1, r2, cov2):
    """SE(2) compounding a->b->c: returns (r_ac, cov_ac) to first order
    (independent inputs)."""
    r1 = np.asarray(r1, np.float64)
    r2 = np.asarray(r2, np.float64)
    c1, s1 = np.cos(r1[2]), np.sin(r1[2])
    x2, y2 = r2[0], r2[1]
    j1 = np.array([
        [1.0, 0.0, -s1 * x2 - c1 * y2],
        [0.0, 1.0, c1 * x2 - s1 * y2],
        [0.0, 0.0, 1.0],
    ])
    j2 = np.array([
        [c1, -s1, 0.0],
        [s1, c1, 0.0],
        [0.0, 0.0, 1.0],
    ])
    rel = np.asarray(geometry.compose(r1, r2))
    cov = j1 @ np.asarray(cov1, np.float64) @ j1.T \
        + j2 @ np.asarray(cov2, np.float64) @ j2.T
    return rel, cov


def marginal_factors(graph, scan) -> List[Tuple[object, object,
                                                np.ndarray, np.ndarray]]:
    """Replacement factors for removing `scan`: [(scan_a, scan_b, rel,
    cov)] with rel = pose of b in a's frame. Chain spanning tree over
    neighbors in (sensor, state_id) order; neighbors already directly
    connected to each other are still chained (the caller dedupes)."""
    incident = list(graph.adjacency.get(scan.unique_id, []))
    if len(incident) < 2:
        return []
    # deduplicate parallel edges to the same neighbor: keep the highest-
    # information one (smallest covariance trace) — composing parallel
    # paths would correlate the chain
    by_other = {}
    for e in incident:
        rel, cov, other = _edge_from(e, scan)
        key = other.unique_id
        tr = float(np.trace(cov))
        if key not in by_other or tr < by_other[key][3]:
            by_other[key] = (rel, cov, other, tr)
    legs = sorted(
        by_other.values(),
        key=lambda t: (t[2].laser.name, t[2].state_id),
    )
    if len(legs) < 2:
        return []
    # chain: factor between consecutive neighbors through the removed
    # node; interior legs participate in 2 factors -> covariance x2
    mult = np.ones(len(legs))
    mult[1:-1] = 2.0
    out = []
    for i in range(len(legs) - 1):
        rel_a, cov_a, sa, _ = legs[i]
        rel_b, cov_b, sb, _ = legs[i + 1]
        # a -> removed -> b  ==  inverse(removed->a) ∘ (removed->b)
        inv_a, icov_a, _ = _edge_from(_FakeEdge(sa, rel_a, cov_a), sa)
        rel, cov = compose_with_cov(
            inv_a, icov_a * mult[i], rel_b, cov_b * mult[i + 1]
        )
        out.append((sa, sb, rel, cov))
    return out


class _FakeEdge:
    """Adapter so _edge_from can invert a (rel, cov) leg: models the edge
    removed->neighbor with neighbor as the requested source."""

    __slots__ = ("source", "target", "rel_pose", "covariance")

    def __init__(self, neighbor, rel, cov):
        # stored as source=virtual-removed, target=neighbor; _edge_from
        # called with scan=neighbor takes the inversion branch
        self.source = object()
        self.target = neighbor
        self.rel_pose = rel
        self.covariance = cov


def marginalize_and_remove(graph, scan) -> bool:
    """Replace `scan`'s constraints with neighbor factors, then remove it
    (the accuracy-preserving alternative to plain remove_vertex)."""
    from slam_toolbox_tpu_torch.graph.pose_graph import Edge

    factors = marginal_factors(graph, scan)
    ok = graph.remove_vertex(scan)
    solver = graph.mapper.solver
    stats = getattr(graph.mapper, "stats", None)
    for sa, sb, rel, cov in factors:
        if graph._find_edge(sa, sb) is not None or \
                graph._find_edge(sb, sa) is not None:
            if stats is not None:
                stats.count("marginal_factor_dup_skipped")
            continue
        e = Edge.__new__(Edge)
        e.source, e.target = sa, sb
        e.rel_pose = np.asarray(rel, np.float64)
        e.covariance = np.asarray(cov, np.float64)
        graph._append_edge(e)
        graph.adjacency.setdefault(sa.unique_id, []).append(e)
        graph.adjacency.setdefault(sb.unique_id, []).append(e)
        graph._bump()
        if not graph._q_dirty:
            graph._q_add_edge(sa.unique_id, sb.unique_id)
        if solver is not None:
            solver.add_constraint(
                sa.unique_id, sb.unique_id, e.rel_pose, e.covariance
            )
        if stats is not None:
            stats.count("marginal_factor_added")
    return ok
