"""Snapshot serialization: lossless save/continue/localize.

The PyTorch port's copy of slam_toolbox_tpu/io/serialization.py: the
same .npz members and the same JSON `meta` (version 1), so a snapshot
written by either package loads in the other. Functional replacement for
the boost binary archives (Mapper::SaveToFile/LoadFromFile,
Mapper.cpp:2635-2651; ROS shim serialization.hpp:39-82). Format compatibility with boost archives is a
non-goal (SURVEY.md §7.3); the snapshot is a single .npz of arrays + a JSON
config blob, which arrays straight back into device memory on resume. As in
the reference's deserialize path, the solver is rebuilt by re-feeding every
vertex and edge (slam_toolbox_common.cpp:952-1017).
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

from slam_toolbox_tpu_torch.core.params import MapperConfig, SolverConfig
from slam_toolbox_tpu_torch.core.scan import LaserConfig, LocalizedScan


def save_snapshot(mapper, path: str) -> None:
    sm = mapper.sensor_manager
    scans = mapper.all_processed_scans()
    n = len(scans)
    B = max((s.laser.n_beams for s in scans), default=0)

    # ranges in f32: the matcher quantizes world points to >=1 cm cells,
    # f32's 2e-5 m at 20 m is far below that; halves the snapshot (a
    # 100k-node graph at 1081 beams is 432 MB raw instead of 865)
    ranges = np.full((n, B), np.nan, np.float32)
    odom = np.zeros((n, 3))
    corrected = np.zeros((n, 3))
    times = np.zeros(n)
    state_ids = np.zeros(n, np.int64)
    unique_ids = np.zeros(n, np.int64)
    sensor_idx = np.zeros(n, np.int64)

    sensors = sorted({s.laser.name for s in scans})
    sensor_of = {name: i for i, name in enumerate(sensors)}
    lasers = {}
    for s in scans:
        lasers[s.laser.name] = dataclasses.asdict(s.laser)

    # persist the local-frame barycenter cache (pose-independent): a
    # deserialized 100k-node prior otherwise recomputes it per scan on
    # the first query-structure refresh — measured ~5-7 s of the
    # relocalization first-touch (VERDICT r3 #5). flag 1 = cached value,
    # -1 = no filtered points (False), computed here if still lazy.
    local_bary = np.zeros((n, 3))
    for i, s in enumerate(scans):
        ranges[i, : len(s.ranges)] = s.ranges
        odom[i] = s.odom_pose
        corrected[i] = s.corrected_pose
        times[i] = s.time
        state_ids[i] = s.state_id
        unique_ids[i] = s.unique_id
        sensor_idx[i] = sensor_of[s.laser.name]
        if s._local_bary is None:
            had_pts = s._local_pts is not None
            s.barycenter  # force the lazy _local_bary
            if not had_pts:
                # don't let the save loop materialize every scan's
                # (B, 2) local points (1.7 GB at 100k x 1081 beams)
                s._local_pts = None
        b = s._local_bary
        if b is False:
            local_bary[i, 2] = -1.0
        elif b is not None:
            local_bary[i, 0:2] = b
            local_bary[i, 2] = 1.0

    g = mapper.graph
    e = len(g.edges) if g else 0
    e_src = np.zeros(e, np.int64)
    e_dst = np.zeros(e, np.int64)
    e_rel = np.zeros((e, 3))
    e_cov = np.zeros((e, 3, 3))
    if g:
        for k, edge in enumerate(g.edges):
            e_src[k] = edge.source.unique_id
            e_dst[k] = edge.target.unique_id
            e_rel[k] = edge.rel_pose
            e_cov[k] = edge.covariance

    running = {
        name: np.array(
            [s.state_id for s in sm.get_running_scans(name)], np.int64
        )
        for name in sm.sensor_names()
    }
    last = {
        name: (
            sm.get_last_scan(name).state_id
            if sm.get_last_scan(name) is not None
            else -1
        )
        for name in sm.sensor_names()
    }

    meta = {
        "config": dataclasses.asdict(mapper.config),
        "lasers": lasers,
        "sensors": sensors,
        "running": {k: v.tolist() for k, v in running.items()},
        "last": last,
        "next_unique_id": sm.next_unique_id,
        "next_state_ids": {
            name: sm._mgr(name).next_state_id for name in sm.sensor_names()
        },
        "range_threshold": mapper.range_threshold,
        "vertex_scores": {
            str(k): float(v) for k, v in mapper.vertex_scores.items()
        },
        "version": 1,
    }
    np.savez_compressed(
        path,
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        ranges=ranges, odom=odom, corrected=corrected, times=times,
        state_ids=state_ids, unique_ids=unique_ids, sensor_idx=sensor_idx,
        local_bary=local_bary,
        e_src=e_src, e_dst=e_dst, e_rel=e_rel, e_cov=e_cov,
    )


def load_snapshot(path: str, mapper=None, device=None):
    """Rebuild a Mapper from a snapshot; returns the mapper. A new mapper
    is made on `device` (default "cuda"; see device.resolve_device); an
    existing one keeps its own."""
    from slam_toolbox_tpu_torch.mapper import Mapper

    zf = np.load(path, allow_pickle=False)
    # materialize every array ONCE: NpzFile.__getitem__ re-reads and
    # re-decompresses the whole member on every access, which turns the
    # per-scan loop below into O(n^2) decompression (measured 13 ms/scan
    # at n=2k — a 100k-node resume would take 20+ minutes)
    z = {k: zf[k] for k in zf.files}
    meta = json.loads(bytes(z["meta"]).decode())

    cfg_d = dict(meta["config"])
    solver_cfg = SolverConfig(**cfg_d.pop("solver"))
    config = MapperConfig(**cfg_d, solver=solver_cfg)
    if mapper is None:
        mapper = Mapper(config, device=device)
    else:
        # an existing mapper keeps its own (node-level) configuration, as
        # the reference re-applies ROS params after LoadFromFile
        # (slam_toolbox_common.cpp:952-1017)
        mapper.reset()
    mapper.initialize(meta["range_threshold"])

    lasers = {
        name: LaserConfig(
            **{k: (tuple(v) if k == "offset_pose" else v)
               for k, v in d.items()}
        )
        for name, d in meta["lasers"].items()
    }

    sm = mapper.sensor_manager
    scans_by_uid = {}
    order = np.argsort(z["unique_ids"])
    for i in order:
        name = meta["sensors"][int(z["sensor_idx"][i])]
        laser = lasers[name]
        r = z["ranges"][i][: laser.n_beams]
        s = LocalizedScan(laser, r, z["odom"][i], time=float(z["times"][i]))
        s.set_corrected_pose(z["corrected"][i])
        if "local_bary" in z:  # pre-v2 snapshots lack the cache
            lb = z["local_bary"][i]
            if lb[2] > 0.5:
                s._local_bary = lb[0:2].copy()
            elif lb[2] < -0.5:
                s._local_bary = False
        s.state_id = int(z["state_ids"][i])
        s.unique_id = int(z["unique_ids"][i])
        mgr = sm._mgr(name)
        mgr.scans[s.state_id] = s
        sm.by_unique_id[s.unique_id] = s
        scans_by_uid[s.unique_id] = s
        mapper.graph.add_vertex(s)

    for name, nid in meta["next_state_ids"].items():
        sm._mgr(name).next_state_id = int(nid)
    sm.next_unique_id = int(meta["next_unique_id"])

    # re-feed edges into graph + solver, using stored rel/cov directly
    from slam_toolbox_tpu_torch.graph.pose_graph import Edge

    for k in range(len(z["e_src"])):
        src = scans_by_uid.get(int(z["e_src"][k]))
        dst = scans_by_uid.get(int(z["e_dst"][k]))
        if src is None or dst is None:
            continue
        e = Edge.__new__(Edge)
        e.source, e.target = src, dst
        e.rel_pose = z["e_rel"][k].copy()
        e.covariance = z["e_cov"][k].copy()
        mapper.graph._append_edge(e)
        mapper.graph.adjacency.setdefault(src.unique_id, []).append(e)
        mapper.graph.adjacency.setdefault(dst.unique_id, []).append(e)
        mapper.solver.add_constraint(
            src.unique_id, dst.unique_id, e.rel_pose, e.covariance
        )

    mapper.vertex_scores = {
        int(k): v for k, v in meta.get("vertex_scores", {}).items()
    }

    for name, sids in meta["running"].items():
        mgr = sm._mgr(name)
        mgr.running_scans = [
            mgr.scans[sid] for sid in sids if sid in mgr.scans
        ]
    for name, sid in meta["last"].items():
        if sid >= 0 and sid in sm._mgr(name).scans:
            sm._mgr(name).last_scan = sm._mgr(name).scans[sid]

    return mapper
