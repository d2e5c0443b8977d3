"""Visualization utils — transport-free analog of the reference's
visualization_utils.hpp + loop_closure_assistant marker publishing.

The PyTorch port's copy of slam_toolbox_tpu/api/viz.py (numpy only).

The reference renders the pose graph as RViz markers (`toMarker`,
visualization_utils.hpp:34-60: one sphere per graph node, scale 0.1,
frame + timestamp) and interactive markers for node dragging
(`toInteractiveMarker`, :62-106); the occupancy map goes out as a
nav_msgs grid (`toNavMap`, :108-130). Here the same content is exposed
two ways:

- ``graph_to_markers(session)`` — the marker list as plain dicts (the
  exact fields an external UI needs: id, xy, scale, interactive flag),
  matching the reference's per-node sphere semantics.
- ``render_map(session, path)`` — a self-contained pure-numpy renderer:
  occupancy grid as grayscale, graph edges (odometry links vs loop
  closures colored differently), node dots, and the trajectory
  polyline, written as a binary PPM (P6 — readable by any image tool,
  zero dependencies beyond numpy).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

# palette (RGB)
_COL_NODE = np.array([220, 60, 60], np.uint8)       # graph nodes
_COL_EDGE = np.array([80, 140, 220], np.uint8)      # sequential links
_COL_LOOP = np.array([60, 180, 90], np.uint8)       # loop-closure links
_COL_TRAJ = np.array([240, 160, 40], np.uint8)      # corrected trajectory


def graph_to_markers(session, scale: float = 0.1,
                     interactive: bool = False):
    """Per-node sphere markers (toMarker, visualization_utils.hpp:34-60).

    `interactive` mirrors the assistant's interactive-mode switch
    (loop_closure_assistant.cpp: markers become draggable handles whose
    feedback drives modify_node / manual_loop_closure)."""
    g = session.get_graph()
    if g is None:  # VISUALIZING_GRAPH paused (interactive mode)
        return []
    nodes, _edges = g
    # the assistant colors localization-buffer vertices distinctly
    # (loop_closure_assistant.cpp:157-273) — surface the tag so UIs can
    loc = session.localization_buffer_uids()
    out = []
    for uid, pose in nodes.items():
        out.append({
            "id": int(uid),
            "x": float(pose[0]),
            "y": float(pose[1]),
            "scale": float(scale),
            "interactive": bool(interactive),
            "localization": int(uid) in loc,
        })
    return out


def _world_to_px(grid, xy):
    """World (x, y) -> image (row, col) in the flipped (y-down) frame."""
    col = (np.asarray(xy)[..., 0] - grid.offset[0]) / grid.resolution
    row_up = (np.asarray(xy)[..., 1] - grid.offset[1]) / grid.resolution
    h = grid.cells.shape[0]
    return (h - 1 - row_up.astype(np.int64)), col.astype(np.int64)


def _draw_disk(img, r, c, rad, color):
    h, w, _ = img.shape
    rr = np.arange(-rad, rad + 1)
    dr, dc = np.meshgrid(rr, rr, indexing="ij")
    mask = dr * dr + dc * dc <= rad * rad
    pr, pc = r + dr[mask], c + dc[mask]
    ok = (pr >= 0) & (pr < h) & (pc >= 0) & (pc < w)
    img[pr[ok], pc[ok]] = color


def _draw_line(img, r0, c0, r1, c1, color):
    """Dense sampled segment (2x oversampling beats Bresenham's gaps for
    a display overlay; cell-set exactness doesn't matter here). Endpoints
    are clipped to the image rectangle first: a diverged node pose far
    outside the grid must not size the sample array (a single bad loop
    closure otherwise allocates O(pixel-distance) points)."""
    h, w, _ = img.shape
    # Liang-Barsky style param clip of t in [0,1] to the rectangle
    t_lo, t_hi = 0.0, 1.0
    for p0, dp, hi in ((r0, r1 - r0, h - 1), (c0, c1 - c0, w - 1)):
        if dp == 0:
            if p0 < 0 or p0 > hi:
                return
            continue
        ta, tb = (0 - p0) / dp, (hi - p0) / dp
        if ta > tb:
            ta, tb = tb, ta
        t_lo, t_hi = max(t_lo, ta), min(t_hi, tb)
    if t_lo > t_hi:
        return
    r0c, c0c = r0 + (r1 - r0) * t_lo, c0 + (c1 - c0) * t_lo
    r1c, c1c = r0 + (r1 - r0) * t_hi, c0 + (c1 - c0) * t_hi
    r0, c0, r1, c1 = r0c, c0c, r1c, c1c
    n = int(max(abs(r1 - r0), abs(c1 - c0)) * 2) + 2
    t = np.linspace(0.0, 1.0, n)
    pr = np.round(r0 + (r1 - r0) * t).astype(np.int64)
    pc = np.round(c0 + (c1 - c0) * t).astype(np.int64)
    ok = (pr >= 0) & (pr < h) & (pc >= 0) & (pc < w)
    img[pr[ok], pc[ok]] = color


def render_map(
    session,
    path: Optional[str] = None,
    resolution: Optional[float] = None,
    with_graph: bool = True,
    with_trajectory: bool = True,
    node_radius_px: int = 2,
) -> np.ndarray:
    """Render occupancy + graph overlay; returns the (H, W, 3) uint8
    image and (if `path` is given) writes it as binary PPM (P6).

    Colors: occupied black, free white, unknown gray (map_saver
    conventions); sequential edges blue, loop closures green, nodes
    red, trajectory orange."""
    from slam_toolbox_tpu_torch.kernels.occupancy import FREE, OCCUPIED

    grid = session.get_occupancy_grid(resolution=resolution)
    cells = grid.cells[::-1]  # y-down image convention, like _save_pgm
    img = np.full(cells.shape + (3,), 205, np.uint8)
    img[cells == FREE] = 254
    img[cells == OCCUPIED] = 0

    # z-order: edges under the trajectory (sequential links coincide
    # with the corrected path — the trajectory wins), nodes on top
    g = session.get_graph() if with_graph else None
    if g is not None:
        nodes, edges = g
        # sequential (|Δstate|==1 by uid adjacency) vs loop links: the
        # reference styles closures separately in its marker array
        for (a, b) in edges:
            pa, pb = nodes.get(a), nodes.get(b)
            if pa is None or pb is None:
                continue
            ra, ca = _world_to_px(grid, np.asarray(pa[:2]))
            rb, cb = _world_to_px(grid, np.asarray(pb[:2]))
            color = _COL_EDGE if abs(int(a) - int(b)) == 1 else _COL_LOOP
            _draw_line(img, int(ra), int(ca), int(rb), int(cb), color)

    if with_trajectory:
        traj = session.trajectory
        if len(traj) >= 2:
            r, c = _world_to_px(grid, traj[:, :2])
            for i in range(len(r) - 1):
                _draw_line(img, r[i], c[i], r[i + 1], c[i + 1], _COL_TRAJ)

    if g is not None:
        nodes, _ = g
        for uid, pose in nodes.items():
            r, c = _world_to_px(grid, np.asarray(pose[:2]))
            _draw_disk(img, int(r), int(c), node_radius_px, _COL_NODE)

    if path is not None:
        with open(path, "wb") as f:
            f.write(f"P6\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
            f.write(img.tobytes())
    return img
