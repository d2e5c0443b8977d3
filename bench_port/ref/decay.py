"""The plain reference of the lifelong scan decay: one evaluation of
slam_toolbox's evaluateNodeDepreciation recomputed from a snapshot of the
pose graph taken just before it.

A snapshot holds every node of the graph: its unique id, its corrected
robot pose and its score before the evaluation, with the ranges of its
scan; every list of constraints the graph keeps by id, as (source id,
target id) in the graph's order (a node's constraint count is the
length of its list); the evaluated scan's id; the steady-state top-up's
anchors (id -> the xy they were promoted at); and the order in which the
program's candidate query visited the candidates. From that alone, in
plain PyTorch in the dtype it is given (float64 for the check, bfloat16
for the control), this module
computes the scans' geometry (LocalizedRangeScan's filtered point
readings, barycenter and bounding box, Karto.h:5644-5704), the candidate
query, the filter, the scores, the removals and the top-up, and returns
the candidates, the removed ids in order, the scores and the anchors after
the evaluation. It imports nothing of the program and no kernel.

slam_toolbox_lifelong.cpp, as this follows it:
- computeIntersectBounds (:373-397): boxes of the scans' bounding-box
  sizes centred on their barycenters; computeIntersect (:404-415), the
  product of the overlaps, 0 where negative (a product of two negative
  overlaps stays, as in the C++); computeIntersectOverUnion (:417-435);
  computeAreaOverlapRatio (:437-453), over the candidate's box;
  computeReadingOverlapRatio (:455-478), the candidate's filtered
  readings strictly inside the bounds.
- computeObjectiveScore (:201-253): -1 for an IOU above iou_match with
  fewer than 3 constraints; else initial * (1 + min(constraint boost,
  overlap)) - overlap - nearby_penalty, capped at 1.
- computeScore's protections (:255-292): the scan_buffer_size newest
  ids and ids 0 and 1 keep their score.
- computeScores (:294-330): candidates with an IOU of at least
  iou_thresh and at least 2 constraints.
- evaluateNodeDepreciation (:149-178): the candidates within half the
  scan's bounding-box diagonal, linked to it (FindNearLinkedVertices:
  a breadth-first walk from the scan through constraints, expanding
  only from nodes whose barycenter is within the radius, less 1e-6 m^2,
  Karto's tolerance); a score below removal_score removes the node,
  else the score is stored.

Departures from the C++, each the program's:
- The candidates are scored and removed one at a time, in the query's
  order: a removal before a candidate's score changes that candidate's
  constraint count (the C++ scores all, then removes). The set of
  candidates is recomputed here (every node's distance, by brute force,
  and the walk through the snapshot's constraints); the order of the
  walk's visits, which the C++ leaves to the graph's edge order, is the
  program's.
- A protected node is never removed, whatever its score (the C++
  removes a protected node whose stored score is below removal_score),
  and an anchor is protected.
- A constraint count is the length of the graph's list, and a list may
  hold constraints to a node removed earlier: a scan of a drain's batch
  is linked to the near chains found before the decay of an earlier scan
  of the same batch removed one of their members (PERF.md §7). The walk
  does not step onto such a node; a removal edits its lists as the
  program's does, and a marginalized removal may give it new ones.
- With marginalize_on_removal, a removed node's constraints are replaced
  by constraints between its consecutive distinct neighbours in id
  order, each added only where the pair has no constraint yet in either
  direction (graph/marginal.py's chain); the node needs at least 2
  constraints and 2 distinct neighbours for any. Only the count of
  constraints matters here, not their values.
- The steady-state top-up (PARITY.md §Known; not in the C++): where at
  least steady_state_min_candidates nodes other than the scan, outside
  the buffer's ids and ids 0 and 1, lie within the radius of the scan's
  barycenter and overlap it by an IOU of at least steady_state_min_iou,
  it removes 1 + (3 * min or more candidates) less the evaluation's
  removals so far, the lowest score first, then the oldest; a candidate
  with no anchor within steady_state_anchor_spacing of its pose is not
  removed but promoted, with the surviving ids within
  max(2, loop_match_minimum_chain_size // 2) of its own, to anchors.
"""
from __future__ import annotations

import math
from collections import deque

import numpy as np
import torch

KT_TOLERANCE = 1e-6      # m^2 off the query's squared radius


class Geometry:
    """The snapshot's scans in `dtype`: sensor poses, filtered world
    points, barycenters and bounding boxes, by row."""

    def __init__(self, poses: np.ndarray, ranges: np.ndarray, laser,
                 dtype):
        def t(a):
            return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype)

        pose = t(poses)
        ox, oy, oh = laser.offset_pose
        c, s = torch.cos(pose[:, 2]), torch.sin(pose[:, 2])
        sx = pose[:, 0] + c * ox - s * oy
        sy = pose[:, 1] + s * ox + c * oy
        sh = pose[:, 2] + oh
        r = np.asarray(ranges, np.float64)
        ok = np.isfinite(r) & (r >= laser.min_range) & (
            r <= laser.range_threshold)
        self.mask = torch.as_tensor(ok)
        rr = t(np.where(ok, r, 0.0))
        ang = t(laser.beam_angles)[None, :] + sh[:, None]
        px = sx[:, None] + rr * torch.cos(ang)
        py = sy[:, None] + rr * torch.sin(ang)
        self.pts = torch.stack([px, py], dim=-1)          # (n, beams, 2)
        m = self.mask.to(dtype)
        cnt = m.sum(1)
        has = cnt > 0
        div = torch.where(has, cnt, torch.ones_like(cnt))
        mean_x = (px * m).sum(1) / div
        mean_y = (py * m).sum(1) / div
        self.bary = torch.stack([torch.where(has, mean_x, sx),
                                 torch.where(has, mean_y, sy)], dim=1)
        inf = torch.tensor(math.inf, dtype=dtype)
        lo_x = torch.where(self.mask, px, inf).amin(1)
        lo_y = torch.where(self.mask, py, inf).amin(1)
        hi_x = torch.where(self.mask, px, -inf).amax(1)
        hi_y = torch.where(self.mask, py, -inf).amax(1)
        self.lo = torch.stack([torch.minimum(lo_x, sx),
                               torch.minimum(lo_y, sy)], dim=1)
        self.hi = torch.stack([torch.maximum(hi_x, sx),
                               torch.maximum(hi_y, sy)], dim=1)
        self.size = self.hi - self.lo
        self.xy = pose[:, :2]

    def bounds(self, a: int, b: int):
        """computeIntersectBounds of rows a and b: (x_l, x_u, y_l, y_u)."""
        h1, h2 = self.size[a] / 2.0, self.size[b] / 2.0
        p1, p2 = self.bary[a], self.bary[b]
        x_u = torch.minimum(p1[0] + h1[0], p2[0] + h2[0])
        y_u = torch.minimum(p1[1] + h1[1], p2[1] + h2[1])
        x_l = torch.maximum(p1[0] - h1[0], p2[0] - h2[0])
        y_l = torch.maximum(p1[1] - h1[1], p2[1] - h2[1])
        return x_l, x_u, y_l, y_u

    def intersect(self, a: int, b: int):
        x_l, x_u, y_l, y_u = self.bounds(a, b)
        area = (y_u - y_l) * (x_u - x_l)
        return torch.where(area > 0, area, torch.zeros_like(area))

    def iou(self, a: int, b: int) -> float:
        inter = self.intersect(a, b)
        union = (self.size[a].prod() + self.size[b].prod()) - inter
        return float(inter / union) if float(union) > 0 else 0.0

    def area_overlap(self, ref: int, cand: int) -> float:
        area = self.size[cand].prod()
        return (float(self.intersect(ref, cand) / area)
                if float(area) > 0 else 0.0)

    def reading_overlap(self, ref: int, cand: int) -> float:
        m = self.mask[cand]
        n = int(m.sum())
        if n == 0:
            return 0.0
        p = self.pts[cand][m]
        x_l, x_u, y_l, y_u = self.bounds(ref, cand)
        inner = ((p[:, 0] > x_l) & (p[:, 0] < x_u) & (p[:, 1] > y_l)
                 & (p[:, 1] < y_u))
        return float(int(inner.sum())) / float(n)


def objective(cfg: dict, iou: float, area: float, reading: float,
              n_con: int, initial: float) -> float:
    """computeObjectiveScore (:201-253)."""
    if iou > cfg["iou_match"] and n_con < 3:
        return -1.0
    overlap = cfg["overlap_scale"] * min(area, reading)
    boost = min(1.0, max(0.0, cfg["constraint_scale"] * (n_con - 2)))
    boost = min(boost, overlap)
    score = initial * (1.0 + boost) - overlap - cfg["nearby_penalty"]
    return min(score, 1.0)


class Graph:
    """The snapshot's constraints, edited as the program's removals edit
    the graph: each id's list of (source id, target id), one entry a
    constraint in the graph's order, for every id the graph lists, some
    removed ones among them (see the module's docstring)."""

    def __init__(self, edges: dict, marginalize: bool):
        self.edges = {int(u): [tuple(e) for e in v]
                      for u, v in edges.items()}
        self.marginalize = marginalize

    def n_con(self, u: int) -> int:
        return len(self.edges.get(u, ()))

    def neighbours(self, u: int):
        for a, b in self.edges.get(u, ()):
            yield b if a == u else a

    def _linked(self, a: int, b: int) -> bool:
        return (a, b) in self.edges.get(a, ())

    def remove(self, u: int) -> None:
        incident = self.edges.get(u, [])
        legs = sorted(set(self.neighbours(u)))
        for e in list(incident):
            o = e[1] if e[0] == u else e[0]
            if e in self.edges.get(o, ()):
                self.edges[o].remove(e)
        self.edges.pop(u, None)
        if not (self.marginalize and len(incident) >= 2 and len(legs) >= 2):
            return
        for a, b in zip(legs[:-1], legs[1:]):
            if self._linked(a, b) or self._linked(b, a):
                continue
            self.edges.setdefault(a, []).append((a, b))
            self.edges.setdefault(b, []).append((a, b))


def evaluate(snap: dict, laser, lifelong: dict, buffer: int,
             chain_min: int, marginalize: bool,
             dtype=torch.float64) -> dict:
    """One evaluation recomputed from `snap` (see the module's
    docstring): {"candidates": set of ids, "removed": [ids in order],
    "scores": {id: score}, "anchors": {id: xy}}."""
    uid = [int(u) for u in snap["uid"]]
    row = {u: i for i, u in enumerate(uid)}
    geo = Geometry(snap["pose"], snap["ranges"], laser, dtype)
    graph = Graph(snap["edges"], marginalize)
    scores = dict(snap["score"])
    anchors = {int(k): np.asarray(v, np.float64)
               for k, v in snap["anchors"].items()}
    me = int(snap["scan"])
    i = row[me]
    radius = float(torch.sqrt((geo.size[i] ** 2).sum()) / 2.0)
    d2 = ((geo.bary - geo.bary[i]) ** 2).sum(1)
    near = (d2 <= radius * radius - KT_TOLERANCE).tolist()
    # the linked query: a walk from the scan through its constraints,
    # expanding from the nodes within the radius
    found, seen, q = set(), {me}, deque([me])
    while q:
        u = q.popleft()
        if near[row[u]]:
            found.add(u)
            for v in graph.neighbours(u):
                if v in row and v not in seen:
                    seen.add(v)
                    q.append(v)
    order = [u for u in snap["order"] if u in found]
    order += sorted(found - set(order))
    filtered = [c for c in order if c != me
                and geo.iou(i, row[c]) >= lifelong["iou_thresh"]
                and graph.n_con(c) >= 2]
    removed = []
    alive = set(row)
    for c in filtered:
        j = row[c]
        initial = scores.get(c, 1.0)
        protected = me - c < buffer or c in (0, 1)
        if protected:
            score = initial
        else:
            score = objective(lifelong, geo.iou(i, j),
                              geo.area_overlap(i, j),
                              geo.reading_overlap(i, j), graph.n_con(c),
                              initial)
        if not (protected or c in anchors) and score < lifelong[
                "removal_score"]:
            graph.remove(c)
            alive.discard(c)
            scores.pop(c, None)
            removed.append(c)
        else:
            scores[c] = score
    if lifelong["steady_state_min_candidates"] > 0:
        removed += _topup(me, i, geo, graph, alive, scores, anchors, row,
                          radius, len(removed), lifelong, buffer, chain_min)
    return {"candidates": found - {me}, "removed": removed,
            "scores": scores, "anchors": anchors}



def _topup(me, i, geo, graph, alive, scores, anchors, row, radius, already,
           lifelong, buffer, chain_min) -> list:
    """The steady-state top-up's removals (PARITY.md §Known); `alive`,
    the snapshot's nodes less those removed so far."""
    d2 = ((geo.bary - geo.bary[i]) ** 2).sum(1)
    cands = []
    for c in sorted(alive):
        j = row[c]
        if c == me or c in (0, 1) or me - c < buffer:
            continue
        if float(d2[j]) <= radius * radius and geo.iou(i, j) >= lifelong[
                "steady_state_min_iou"]:
            cands.append((scores.get(c, 1.0), c))
    f_min = lifelong["steady_state_min_candidates"]
    if len(cands) < f_min:
        return []
    want = 1 + (len(cands) >= 3 * f_min) - already
    if want <= 0:
        return []
    cands.sort()
    spacing = lifelong["steady_state_anchor_spacing"]
    a_xy = [np.asarray(v, np.float64) for v in anchors.values()]
    half = max(2, chain_min // 2)
    out = []
    for _, c in cands:
        if len(out) >= want:
            break
        if c in anchors:
            continue
        xy = geo.xy[row[c]].double().numpy()
        if spacing > 0 and (not a_xy or min(
                float(np.sum((a - xy) ** 2)) for a in a_xy)
                > spacing * spacing):
            for u in range(c - half, c + half + 1):
                if u in alive:
                    anchors[u] = geo.xy[row[u]].double().numpy()
                    a_xy.append(anchors[u])
            continue
        graph.remove(c)
        alive.discard(c)
        scores.pop(c, None)
        out.append(c)
    return out


def compare(program: dict, reference: dict) -> tuple:
    """(decisions that differ, the widest score gap) of one evaluation:
    a decision differs where the candidate sets, the removed ids (in
    order), the scored ids or the anchors differ; the gap is the largest
    score difference over the ids both scored, relative to the larger
    score where that passes 1 in size. (An anchor is never removed, so
    its score, once negative, compounds without bound: initial * (1 +
    boost) less the overlap; such scores reach -1e6 in a few laps.)"""
    differ = int(program["candidates"] != reference["candidates"]
                 or list(program["removed"]) != list(reference["removed"])
                 or set(program["scores"]) != set(reference["scores"])
                 or set(program["anchors"]) != set(reference["anchors"]))
    gap = 0.0
    for u in set(program["scores"]) & set(reference["scores"]):
        a, b = float(program["scores"][u]), float(reference["scores"][u])
        gap = max(gap, abs(a - b) / max(1.0, abs(a), abs(b)))
    return differ, gap if math.isfinite(gap) else math.inf
