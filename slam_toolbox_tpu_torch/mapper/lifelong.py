"""Lifelong mapping: scan-decay node removal to bound graph growth.

Re-expression of LifelongSlamToolbox
(slam_toolbox src/experimental/slam_toolbox_lifelong.cpp): overlap
metrics (computeIntersectBounds :373, computeIntersect :404,
computeIntersectOverUnion :417, computeAreaOverlapRatio :437,
computeReadingOverlapRatio :455), the objective score
(computeObjectiveScore :201-253), candidate filtering (computeScores
:294-330) and node removal (:332-344). Metrics are vectorized NumPy —
they operate on scan bounding boxes/barycenters, not rasters.

The scalar metrics take two scans; the decay itself runs their row forms
(`box_rows`, `overlap_rows`): each phase gathers its candidates' boxes
and barycenters once and gets every IOU and area overlap from a few
array operations, and the scores' reading overlaps from one native pass
(native.decay_reading_overlap, or its twin `_np_decay_reading_overlap`
where the library is absent) over sensor-frame points the decay packs
once per node; the boxes of nodes a correction moved come from one
native pass over the same points (native.decay_boxes). Equal to the scalar forms bit for bit; the decisions stay
a sequential loop over the numbers, in the scalar decay's order.

Each evaluation is a span `decay` of the mapper's Stats (under the commit
that calls it), with the parts `decay_query` (the candidate query),
`decay_filter` (the IOU and constraint filter), `decay_score` (the
objective scores), `decay_topup` (the steady-state top-up) and
`decay_remove` (each removal, marginalized or plain; it nests under
decay_score or decay_topup, whose self time leaves it out). Counters:
decay_evals, decay_candidates (filtered candidates scored),
decay_removed, decay_forced (top-up removals), decay_resync
(stream_hook asked the device ring to resync), decay_batch_rows (rows
through the batched IOU pass, filter and top-up), decay_overlap_rows
(rows through the reading-overlap pass: the filtered candidates that
reach objective_score), decay_points_packed (nodes whose points entered
the decay's store) and decay_box_refresh (moved nodes' boxes recomputed
by the native box pass).

The port's copy of slam_toolbox_tpu/mapper/lifelong.py (host code; the
matches it rides on run on the mapper's device).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from slam_toolbox_tpu_torch.utils.metrics import stage_timer


@dataclass
class LifelongConfig:
    """Defaults from slam_toolbox_lifelong.cpp:49-114."""

    iou_thresh: float = 0.10          # lifelong_minimum_score
    iou_match: float = 0.85           # lifelong_iou_match
    removal_score: float = 0.10       # lifelong_node_removal_score
    overlap_scale: float = 0.06       # lifelong_overlap_score_scale
    constraint_scale: float = 0.08    # lifelong_constraint_multiplier
    nearby_penalty: float = 0.001     # lifelong_nearby_penalty
    candidates_scale: float = 0.03    # lifelong_candidates_scale
    use_tree: bool = False            # lifelong_search_use_tree
    # Steady-state extension (ours — documented in PARITY.md §Known):
    # the reference objective alone does not reach a plateau: a node with
    # >=3 constraints gets a constraint boost that cancels the overlap
    # subtraction, so it decays at only nearby_penalty (0.001) per
    # evaluation — on a 40-lap revisit workload removals ran ~0.2/scan
    # against 1.0 added (round-2 CONFIG3: "not yet plateaued"). When a
    # new scan's redundant-candidate count (already IOU- and
    # constraint-filtered) reaches steady_state_min_candidates, the area
    # is demonstrably over-covered: force-remove the worst-scoring
    # unprotected candidate so removals match additions on revisits
    # (net growth 0 by construction), with one extra removal per scan
    # above 3x the threshold to shrink over-dense regions.
    # DEFAULT 0 (off = exact reference behavior, like every other
    # extension knob): bounding the graph shortens the anchoring
    # horizon, and on drift-heavy workloads closures then re-anchor
    # against recent laps only — CONFIG3.json measures ATE 0.53 m
    # (reference decay, unbounded) vs 1.7 m (bounded) on a 40-lap
    # warehouse, while the low-drift CPU plateau test holds <0.30 m
    # (tests/test_lifelong_plateau.py). Opt in when bounded memory
    # matters more than absolute-frame accuracy.
    steady_state_min_candidates: int = 0
    # redundancy definition for the steady-state query: a node only
    # counts (and is only removable) when it overlaps the current scan
    # this strongly. The reference's iou_thresh (0.10) admits nodes a
    # dozen meters down the aisle — with a range-threshold-sized query
    # radius that made "over-covered" nearly global and decayed a
    # 4-aisle warehouse to ~90 nodes.
    steady_state_min_iou: float = 0.35
    # anchor lattice: before removing a redundant node, keep it FOREVER
    # if no anchor exists within this spacing (m). Recency-only decay
    # converges to the last laps' chains, so every closure re-anchors
    # against ~1-lap-old poses and the global frame random-walks
    # (measured survivors-ATE 1.7 m over 40 warehouse laps); a sparse
    # immortal lattice pins the frame everywhere while the graph stays
    # bounded by AREA, not time. 0 disables.
    steady_state_anchor_spacing: float = 4.0


def _half_extents(scan):
    bb = scan.bounding_box
    return (bb[1] - bb[0]) / 2.0  # (w/2, h/2)


def intersect_bounds(s1, s2):
    """(x_l, x_u, y_l, y_u) of the overlap of barycenter-centered boxes
    (computeIntersectBounds :373-397 — note the reference centers each
    bounding box on the scan *barycenter*, not the box center)."""
    h1, h2 = _half_extents(s1), _half_extents(s2)
    p1, p2 = s1.barycenter[:2], s2.barycenter[:2]
    x_u = min(p1[0] + h1[0], p2[0] + h2[0])
    y_u = min(p1[1] + h1[1], p2[1] + h2[1])
    x_l = max(p1[0] - h1[0], p2[0] - h2[0])
    y_l = max(p1[1] - h1[1], p2[1] - h2[1])
    return x_l, x_u, y_l, y_u


def intersect_area(s1, s2) -> float:
    x_l, x_u, y_l, y_u = intersect_bounds(s1, s2)
    area = (y_u - y_l) * (x_u - x_l)
    return area if area > 0.0 else 0.0


def iou(s1, s2) -> float:
    inter = intersect_area(s1, s2)
    b1 = _half_extents(s1) * 2.0
    b2 = _half_extents(s2) * 2.0
    union = b1[0] * b1[1] + b2[0] * b2[1] - inter
    return inter / union if union > 0 else 0.0


def area_overlap_ratio(ref_scan, candidate) -> float:
    inter = intersect_area(ref_scan, candidate)
    b = _half_extents(candidate) * 2.0
    area = b[0] * b[1]
    return inter / area if area > 0 else 0.0


def reading_overlap_ratio(ref_scan, candidate) -> float:
    pts = candidate.points_world(filtered=True)
    if len(pts) == 0:
        return 0.0
    x_l, x_u, y_l, y_u = intersect_bounds(ref_scan, candidate)
    inner = (
        (pts[:, 0] > x_l) & (pts[:, 0] < x_u)
        & (pts[:, 1] > y_l) & (pts[:, 1] < y_u)
    )
    return float(inner.sum()) / float(len(pts))


def box_rows(scans):
    """(lo, hi, bc) of `scans`: each one's bounding-box corners and
    barycenter xy, (n, 2) float64 each, read from the scans' caches."""
    if not scans:
        z = np.zeros((0, 2))
        return z, z, z
    bb = np.array([s.bounding_box for s in scans])
    bc = np.array([s.barycenter for s in scans])
    return bb[:, 0], bb[:, 1], bc[:, :2]


def overlap_rows(ref, rows):
    """The overlap metrics of one scan `ref` against each scan of `rows`,
    both as box_rows gives them: (bounds (n, 4) of intersect_bounds'
    (x_l, x_u, y_l, y_u), iou (n,), area_overlap_ratio (n,)), each row
    equal to the scalar function of (ref, row) bit for bit."""
    (rlo, rhi, rbc), (lo, hi, bc) = ref, rows
    rh = (rhi - rlo) / 2.0
    h = (hi - lo) / 2.0
    upper = np.minimum(rbc + rh, bc + h)
    lower = np.maximum(rbc - rh, bc - h)
    bounds = np.stack([lower[:, 0], upper[:, 0], lower[:, 1],
                       upper[:, 1]], axis=1)
    area = (upper[:, 1] - lower[:, 1]) * (upper[:, 0] - lower[:, 0])
    inter = np.where(area > 0.0, area, 0.0)
    rb = rh * 2.0
    b = h * 2.0
    own = b[:, 0] * b[:, 1]
    union = rb[:, 0] * rb[:, 1] + own - inter
    iou_ = np.zeros(len(inter))
    np.divide(inter, union, out=iou_, where=union > 0)
    area_ov = np.zeros(len(inter))
    np.divide(inter, own, out=area_ov, where=own > 0)
    return bounds, iou_, area_ov


def _sensor_rows(scans) -> np.ndarray:
    """(n, 4) of each scan's sensor pose as (x, y, cos, sin), the cos and
    sin the same scalar NumPy calls as LocalizedScan.points_world's."""
    pose = np.empty((len(scans), 4))
    for k, c in enumerate(scans):
        sp = c.sensor_pose
        pose[k] = (sp[0], sp[1], np.cos(sp[2]), np.sin(sp[2]))
    return pose


def _np_decay_reading_overlap(start, count, points, pose, bounds):
    """native.decay_reading_overlap in NumPy, equal to it bit for bit:
    of each candidate i, its points rows start[i] .. start[i] + count[i]
    strictly inside bounds[i] once moved to pose[i] = (x, y, cos, sin),
    as LocalizedScan.points_world moves them."""
    n = len(start)
    row = np.repeat(np.arange(n), count)
    first = np.cumsum(count) - count
    at = np.arange(len(row)) - first[row] + np.asarray(start)[row]
    lp = points[at]
    p = pose[row]
    wx = p[:, 0] + p[:, 2] * lp[:, 0] - p[:, 3] * lp[:, 1]
    wy = p[:, 1] + p[:, 3] * lp[:, 0] + p[:, 2] * lp[:, 1]
    b = bounds[row]
    inner = ((wx > b[:, 0]) & (wx < b[:, 1])
             & (wy > b[:, 2]) & (wy < b[:, 3]))
    return np.bincount(row[inner], minlength=n).astype(np.int64)


class _PointStore:
    """The decay's nodes' filtered sensor-frame points (LocalizedScan's
    local points under its filtered mask), packed once: they do not move
    with the pose. Node uid owns rows [start, start + count) of
    `points`; removed nodes' rows are reclaimed once they outnumber the
    live ones."""

    def __init__(self):
        self.points = np.empty((4096, 2))
        self.size = 0
        self.rows = {}   # unique_id -> (scan, start, count)
        self.dead = 0

    def locate(self, scans, stats):
        """(start, count) int64 arrays of `scans`, packing the new ones
        (after reclaiming the dead rows where they outnumber the live)."""
        if self.dead > max(self.size - self.dead, 1 << 16):
            self._compact()
        start = np.empty(len(scans), np.int64)
        count = np.empty(len(scans), np.int64)
        for k, c in enumerate(scans):
            ent = self.rows.get(c.unique_id)
            if ent is None or ent[0] is not c:
                ent = self._pack(c)
                stats.count("decay_points_packed")
            start[k], count[k] = ent[1], ent[2]
        return start, count

    def drop(self, uid) -> None:
        ent = self.rows.pop(uid, None)
        if ent is not None:
            self.dead += ent[2]

    def _pack(self, scan):
        # a snapshot loaded into the mapper gives old ids to new scans
        self.drop(scan.unique_id)
        pts = scan.local_points[scan.filtered_mask]
        need = self.size + len(pts)
        if need > len(self.points):
            grown = np.empty((max(need, 2 * len(self.points)), 2))
            grown[:self.size] = self.points[:self.size]
            self.points = grown
        self.points[self.size:need] = pts
        ent = (scan, self.size, len(pts))
        self.rows[scan.unique_id] = ent
        self.size = need
        return ent

    def _compact(self) -> None:
        live = sorted(self.rows.items(), key=lambda kv: kv[1][1])
        out = np.empty((max(4096, 2 * (self.size - self.dead)), 2))
        at = 0
        for uid, (scan, start, count) in live:
            out[at:at + count] = self.points[start:start + count]
            self.rows[uid] = (scan, at, count)
            at += count
        self.points, self.size, self.dead = out, at, 0


def objective_score(
    cfg: LifelongConfig,
    intersect_over_union: float,
    area_overlap: float,
    reading_overlap: float,
    num_constraints: int,
    initial_score: float,
    num_candidates: int,
) -> float:
    """computeObjectiveScore (:201-253)."""
    if intersect_over_union > cfg.iou_match and num_constraints < 3:
        return -1.0
    overlap = cfg.overlap_scale * min(area_overlap, reading_overlap)
    constraint_scale = min(
        1.0, max(0.0, cfg.constraint_scale * (num_constraints - 2))
    )
    constraint_scale = min(constraint_scale, overlap)
    score = (
        initial_score * (1.0 + constraint_scale)
        - overlap
        - cfg.nearby_penalty
    )
    return min(score, 1.0)


class LifelongMapper:
    """Wraps a Mapper with per-scan decay evaluation
    (evaluateNodeDepreciation, :149-178)."""

    def __init__(self, mapper, config: LifelongConfig = None):
        self.mapper = mapper
        self.cfg = config or LifelongConfig()
        # the steady-state top-up's immortal anchors: unique_id -> the xy
        # of its corrected pose when it was promoted
        self.anchors = {}
        self._points = _PointStore()

    @property
    def scores(self):
        """unique_id -> vertex score (Vertex::m_Score); lives on the
        mapper so snapshots persist it across sessions."""
        return self.mapper.vertex_scores

    def process(self, scan, covariance_out=None) -> bool:
        ok = self.mapper.process(scan, covariance_out=covariance_out)
        if ok:
            self.evaluate_node_depreciation(scan)
        return ok

    def evaluate_node_depreciation(self, scan) -> List[int]:
        stats = self.mapper.stats
        with stage_timer(stats, "decay"):
            removed = self._evaluate(scan, stats)
        stats.count("decay_evals")
        stats.count("decay_removed", len(removed))
        return removed

    def _evaluate(self, scan, stats) -> List[int]:
        mapper = self.mapper
        self._box_rows([scan], stats)   # the scan's own box, natively
        bb = scan.bounding_box
        size = bb[1] - bb[0]
        radius = float(np.hypot(*size) / 2.0)
        with stage_timer(stats, "decay_query"):
            if self.cfg.use_tree:
                candidates = mapper.graph.find_nearby_vertices(
                    scan.laser.name, scan.barycenter, radius
                )
            else:
                candidates = mapper.graph.find_near_linked_scans(scan,
                                                                 radius)

        # filter: minimum IOU + at least 2 constraints (computeScores)
        with stage_timer(stats, "decay_filter"):
            adjacency = mapper.graph.adjacency
            cands = [c for c in candidates if c is not scan]
            bounds, iou_, area_ov = self._overlaps(scan, cands, stats)
            keep = [k for k, c in enumerate(cands)
                    if len(adjacency.get(c.unique_id, ())) >= 2]
            keep = np.asarray(keep, np.int64)
            keep = keep[iou_[keep] >= self.cfg.iou_thresh]
            filtered = [cands[k] for k in keep]
        stats.count("decay_candidates", len(filtered))

        with stage_timer(stats, "decay_score"):
            removed = self._score_all(scan, filtered, bounds[keep],
                                      iou_[keep], area_ov[keep], stats)

        # steady-state top-up: in a well-covered area every added scan
        # must be paid for by a removal or the graph grows without bound
        if self.cfg.steady_state_min_candidates > 0:
            with stage_timer(stats, "decay_topup"):
                forced = self._steady_state_topup(scan, len(removed),
                                                  stats)
            stats.count("decay_forced", len(forced))
            removed.extend(forced)
        return removed

    def _score_all(self, ref_scan, filtered, bounds, iou_, area_ov,
                   stats) -> List[int]:
        """computeScore (:255-292) of each filtered candidate in the
        query's order, removing or storing as it goes; returns the
        removed ids in order. Recent scans and the first two nodes are
        protected (they keep their score), and so are the anchors (scored
        all the same). A removal moves no pose, so the geometry is
        computed before the loop; a constraint count is read from the
        live graph at its candidate, since an earlier removal in the loop
        may have changed it."""
        adjacency = self.mapper.graph.adjacency
        buf = self.mapper.config.scan_buffer_size
        uid0 = ref_scan.unique_id
        scored = [k for k, c in enumerate(filtered)
                  if uid0 - c.unique_id >= buf
                  and c.unique_id not in (0, 1)]
        reading = self._reading_overlaps(
            ref_scan, [filtered[k] for k in scored], bounds[scored], stats)
        geometry = dict(zip(scored, zip(iou_[scored].tolist(),
                                        area_ov[scored].tolist(),
                                        reading)))
        scores, anchors = self.scores, self.anchors
        n = len(filtered)
        removed = []
        for k, c in enumerate(filtered):
            uid = c.unique_id
            initial = scores.get(uid, 1.0)
            g = geometry.get(k)
            if g is None:
                score = initial
            else:
                score = objective_score(
                    self.cfg, g[0], g[1], g[2],
                    len(adjacency.get(uid, [])), initial, n,
                )
            if (g is not None and uid not in anchors
                    and score < self.cfg.removal_score):
                self._remove(c, stats)
                removed.append(uid)
            else:
                scores[uid] = score
        return removed

    def _overlaps(self, scan, scans, stats):
        """overlap_rows of `scan` against each of `scans`: (bounds, iou,
        area overlap), one row each."""
        stats.count("decay_batch_rows", len(scans))
        return overlap_rows(box_rows([scan]), self._box_rows(scans, stats))

    def _reading_overlaps(self, ref, scans, bounds, stats) -> List[float]:
        """reading_overlap_ratio(ref, c) of each scan c of `scans`, with
        bounds[k] = intersect_bounds(ref, c), from one pass over the
        points the store holds for them."""
        if not scans:
            return []
        from slam_toolbox_tpu_torch import native

        start, count = self._points.locate(scans, stats)
        pose = _sensor_rows(scans)
        pts = self._points.points
        inside = native.decay_reading_overlap(start, count, pts, pose,
                                              bounds)
        if inside is None:
            inside = _np_decay_reading_overlap(start, count, pts, pose,
                                               bounds)
        stats.count("decay_overlap_rows", len(scans))
        ratio = np.zeros(len(scans))
        np.divide(inside, count, out=ratio, where=count > 0)
        return ratio.tolist()

    def _box_rows(self, scans, stats):
        """box_rows(scans), the boxes of those whose pose moved since
        their box was computed (the scan's cache is empty) first
        recomputed in one native pass over the points the store holds
        for them and put in their caches (where the library is absent,
        the scans' own property recomputes them)."""
        from slam_toolbox_tpu_torch import native

        stale = [c for c in scans if c._bbox is None]
        if stale and native.get_lib() is not None:
            start, count = self._points.locate(stale, stats)
            boxes = native.decay_boxes(start, count, self._points.points,
                                       _sensor_rows(stale))
            for c, box in zip(stale, boxes):
                c._bbox = box
            stats.count("decay_box_refresh", len(stale))
        return box_rows(scans)

    def _remove(self, c, stats) -> None:
        with stage_timer(stats, "decay_remove"):
            self.mapper.remove_node_from_graph(c)
        self.scores.pop(c.unique_id, None)
        self._points.drop(c.unique_id)

    def _steady_state_topup(self, scan, already_removed: int, stats):
        """Force-remove the most redundant node(s) when the scan's area
        is demonstrably over-covered (PARITY.md §Known).

        Candidates come from a POSITION query over all vertices (the
        graph's vectorized query structure), NOT the linked BFS the
        reference scoring uses: removals thin link connectivity, so a
        BFS-scoped candidate set shrinks toward the trigger threshold
        while spatially-redundant but link-distant nodes become
        unremovable zombies — measured +37 nodes/lap of residual growth
        on a 6-lap loop with the BFS-scoped variant. Ranking prefers the
        lowest stored score, then the highest IOU with the current scan
        (most redundant coverage). The recent window and nodes 0/1 stay
        protected; n_con>=2 is NOT required here — a leaf node is the
        safest possible removal."""
        mapper = self.mapper
        cfg_m = mapper.config
        (scans_q, _, xy, present, _, _) = mapper.graph._query_structure()
        n = len(scans_q)
        if n == 0:
            return []
        bb = scan.bounding_box
        radius = float(np.hypot(*(bb[1] - bb[0])) / 2.0)
        center = scan.reference_pose(cfg_m.use_scan_barycenter)[:2]
        d2 = np.sum((xy[:n] - center) ** 2, axis=1)
        near = np.flatnonzero((d2 <= radius * radius) & (present[:n] > 0))
        buf = cfg_m.scan_buffer_size
        uid0 = scan.unique_id
        f_min = self.cfg.steady_state_min_candidates
        near = [scans_q[i] for i in near.tolist()]
        near = [c for c in near
                if c is not None and c is not scan
                and c.unique_id not in (0, 1)
                and uid0 - c.unique_id >= buf]
        if len(near) < f_min:
            return []
        _, iou_, _ = self._overlaps(scan, near, stats)
        # rank OLDEST-first (then score): lifelong replacement should
        # converge to the recent laps' CONTIGUOUS chains. Age-agnostic
        # max-IOU removal sprinkles holes across every lap, fragmenting
        # the state-id runs the loop sweep needs (chains under the
        # minimum size -> closures starve -> odometry drift never
        # corrected; measured survivors-ATE 3.9 m on the 40-lap
        # warehouse).
        over = np.flatnonzero(iou_ >= self.cfg.steady_state_min_iou)
        scores = self.scores
        cands = [(scores.get(c.unique_id, 1.0), c.unique_id, c)
                 for c in (near[k] for k in over.tolist())]
        if len(cands) < f_min:
            return []
        want = 1 + (len(cands) >= 3 * f_min) - already_removed
        if want <= 0:
            return []
        cands.sort(key=lambda t: (t[0], t[1]))
        anchors = self.anchors
        spacing = self.cfg.steady_state_anchor_spacing
        a_xy = (np.stack(list(anchors.values()))
                if anchors else np.zeros((0, 2)))
        out = []
        for _, _, c in cands:
            if len(out) >= want:
                break
            uid = c.unique_id
            if uid in anchors:
                continue  # immortal
            c_xy = np.asarray(c.corrected_pose[:2])
            if spacing > 0 and (
                len(a_xy) == 0
                or np.min(np.sum((a_xy - c_xy) ** 2, axis=1))
                > spacing * spacing
            ):
                # no anchor covers this cell yet: promote a CONTIGUOUS
                # state-id SEGMENT around this node instead of removing
                # it. A lone immortal node is useless — the loop sweep
                # only emits chains of >= loop_match_minimum_chain_size
                # consecutive surviving ids, so frame anchoring needs
                # whole runs (isolated anchors measured ATE 3.2 m, no
                # better than none).
                half = max(
                    2, self.mapper.config.loop_match_minimum_chain_size
                    // 2,
                )
                seg = []
                for du in range(-half, half + 1):
                    s2 = mapper.sensor_manager.get_scan_by_unique_id(
                        uid + du
                    )
                    if s2 is not None:
                        seg.append(s2)
                for s2 in seg:
                    anchors[s2.unique_id] = np.asarray(
                        s2.corrected_pose[:2]
                    )
                a_xy = np.concatenate(
                    [a_xy] + [np.asarray(
                        s2.corrected_pose[:2]
                    )[None] for s2 in seg],
                    axis=0,
                )
                continue
            self._remove(c, stats)
            out.append(uid)
        return out

    def stream_hook(self, scan) -> bool:
        """post_finish hook for the streaming pipeline: run decay after
        each drained scan; True when nodes were removed (device ring must
        resync). A session made with SlamSession(...,
        lifelong=LifelongConfig(...)) installs it on its pipeline and
        keeps it there while mapping; sess.lifelong is this mapper.

        The device ring mirrors only the RUNNING buffer; decay removals
        are protected out of the recent window (id_diff >=
        scan_buffer_size), so they normally don't touch it — resync only
        when one actually did (it would force a refresh + batch re-run
        per drain otherwise, the round-2 steady-state throughput tax)."""
        removed = self.evaluate_node_depreciation(scan)
        if not removed:
            return False
        sm = self.mapper.sensor_manager
        name = scan.laser.name
        running = {s.unique_id for s in sm.get_running_scans(name)}
        last = sm.get_last_scan(name)
        if last is not None:
            running.add(last.unique_id)
        resync = bool(set(removed) & running)
        if resync:
            self.mapper.stats.count("decay_resync")
        return resync
