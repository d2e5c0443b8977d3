"""Occupancy-grid rendering: batched ray tracing as one scatter-add pass.

PyTorch counterpart of slam_toolbox_tpu/kernels/occupancy.py, a
re-design of karto::OccupancyGrid (Karto.h:5893-6323). The reference
walks Bresenham per beam (TraceLine, Karto.h:4874-4927) updating pass/hit
counters, then thresholds cells (UpdateCell, Karto.h:6242-6253). Here
every beam's Bresenham cell sequence is expressed in closed form
(minor(k) = floor((2*k*dY + dX) / (2*dX)) along the major axis, identical
cells to the reference's integer error accumulator) so all beams of a
chunk trace in one (N_beams, K) index computation plus a scatter-add.
Beam selection and the range-threshold endpoint clamp follow AddScan
(Karto.h:6146-6189).

Two routes accumulate the counters, with identical results: trace_beams
on the card for a CUDA device, and the native host Bresenham of
native/graph_ops.cpp (`occupancy_raster`) for the CPU while the library
loads (trace_beams on the CPU otherwise). `native=` overrides the choice.
Counters and cells come back as numpy arrays.

Grid states: 0 unknown, 100 occupied, 255 free (Karto.h:4379-4382).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from slam_toolbox_tpu_torch.core.scan import LocalizedScan, _beam_trig
from slam_toolbox_tpu_torch.device import resolve_device, upload

UNKNOWN, OCCUPIED, FREE = 0, 100, 255


def round_half_away_f32(x) -> np.ndarray:
    """The JAX package's round_half_away applied to a float64 host array:
    the +-0.5 in float64, the floor or ceil in float32 (its arrays are
    float32 there), so cell indices are the reference's bit for bit."""
    x = np.asarray(x, np.float64)
    with np.errstate(invalid="ignore", over="ignore"):
        return np.where(
            x >= 0,
            np.floor((x + 0.5).astype(np.float32)),
            np.ceil((x - 0.5).astype(np.float32)),
        )


def trace_beams(
    pass_cnt: torch.Tensor,     # (H, W) int32
    hit_cnt: torch.Tensor,      # (H, W) int32
    start_cells: torch.Tensor,  # (N, 2) int32 sensor cell (x, y) per beam
    end_cells: torch.Tensor,    # (N, 2) int32 endpoint cell (x, y)
    beam_valid: torch.Tensor,   # (N,) bool: beam participates at all
    end_valid: torch.Tensor,    # (N,) bool: endpoint is a hit
    width: int, height: int, max_steps: int,
):
    """Accumulate Bresenham pass counts and endpoint hits for all beams;
    returns new (pass, hit) int32 (H, W) tensors on the inputs' device.
    Cells off the grid go to a sentinel slot past the last cell, which is
    dropped, as the reference's `mode="drop"` scatter drops them."""
    dev = pass_cnt.device
    valid = beam_valid.to(torch.bool)
    # invalid beams carry arbitrary (even saturated) cells; they are
    # masked below, so zero them first and no arithmetic overflows
    st = torch.where(valid[:, None], start_cells.long(), 0)
    en = torch.where(valid[:, None], end_cells.long(), 0)
    x0, y0 = st[:, 0], st[:, 1]
    x1, y1 = en[:, 0], en[:, 1]
    steep = (y1 - y0).abs() > (x1 - x0).abs()
    ax0 = torch.where(steep, y0, x0)
    ay0 = torch.where(steep, x0, y0)
    ax1 = torch.where(steep, y1, x1)
    ay1 = torch.where(steep, x1, y1)
    flip = ax0 > ax1
    bx0 = torch.where(flip, ax1, ax0)
    by0 = torch.where(flip, ay1, ay0)
    bx1 = torch.where(flip, ax0, ax1)
    by1 = torch.where(flip, ay0, ay1)
    dx = bx1 - bx0                      # >= 0
    dy = (by1 - by0).abs()
    ystep = torch.where(by0 < by1, 1, -1)

    k = torch.arange(max_steps, dtype=torch.int64, device=dev)[None, :]
    dx_safe = dx.clamp(min=1)[:, None]
    # floor division of non-negative int64: the reference's int32 `//`
    minor_off = torch.div(2 * k * dy[:, None] + dx[:, None], 2 * dx_safe,
                          rounding_mode="floor")
    maj = bx0[:, None] + k                                    # (N, K)
    mnr = by0[:, None] + ystep[:, None] * minor_off
    steep_k = steep[:, None]
    px = torch.where(steep_k, mnr, maj)
    py = torch.where(steep_k, maj, mnr)
    ok = (
        valid[:, None]
        & (k <= dx[:, None])
        & (px >= 0) & (px < width) & (py >= 0) & (py < height)
    )
    sink = width * height
    flat = torch.where(ok, py * width + px, sink).reshape(-1)
    one = torch.ones((), dtype=torch.int32, device=dev)
    pass_flat = torch.cat([pass_cnt.reshape(-1).to(torch.int32),
                           torch.zeros(1, dtype=torch.int32, device=dev)])
    pass_flat.index_add_(0, flat, one.expand(flat.numel()))

    # endpoint hit + extra pass (RayTrace, Karto.h:6217-6231)
    eok = (
        valid & end_valid.to(torch.bool)
        & (x1 >= 0) & (x1 < width) & (y1 >= 0) & (y1 < height)
    )
    eflat = torch.where(eok, y1 * width + x1, sink)
    ones_e = one.expand(eflat.numel())
    pass_flat.index_add_(0, eflat, ones_e)
    hit_flat = torch.cat([hit_cnt.reshape(-1).to(torch.int32),
                          torch.zeros(1, dtype=torch.int32, device=dev)])
    hit_flat.index_add_(0, eflat, ones_e)
    return (
        pass_flat[:-1].reshape(height, width),
        hit_flat[:-1].reshape(height, width),
    )


def update_cells(pass_cnt: torch.Tensor, hit_cnt: torch.Tensor,
                 min_pass_through: int, occupancy_threshold: float):
    """UpdateCell thresholding (Karto.h:6242-6253). The hit ratio is
    float32 and so is the threshold it is compared with, as in the
    reference; a Python float would leave the cast to type promotion."""
    counted = pass_cnt > int(min_pass_through)
    ratio = hit_cnt.to(torch.float32) / pass_cnt.to(torch.float32).clamp(
        min=1.0)
    thr = torch.tensor(np.float32(occupancy_threshold), dtype=torch.float32,
                       device=ratio.device)
    occupied = counted & (ratio > thr)
    return torch.where(
        occupied, OCCUPIED, torch.where(counted, FREE, UNKNOWN)
    ).to(torch.uint8)


class OccupancyGrid:
    """Rendered occupancy map with its world transform."""

    def __init__(self, cells, offset, resolution, pass_cnt=None, hit_cnt=None):
        self.cells = np.asarray(cells)          # (H, W) uint8 grid states
        self.offset = np.asarray(offset)        # world xy of cell (0, 0)
        self.resolution = float(resolution)
        self.pass_cnt = pass_cnt
        self.hit_cnt = hit_cnt

    @property
    def width(self):
        return self.cells.shape[1]

    @property
    def height(self):
        return self.cells.shape[0]

    def world_to_grid(self, xy):
        return round_half_away_f32(
            (np.asarray(xy) - self.offset) / self.resolution
        ).astype(np.int64)

    def is_free(self, cell_xy) -> bool:
        x, y = int(cell_xy[0]), int(cell_xy[1])
        if not (0 <= x < self.width and 0 <= y < self.height):
            return False
        return self.cells[y, x] == FREE

    def ray_cast(self, pose, max_range: float) -> float:
        """Distance to the closest obstacle along the pose heading
        (RayCast, Karto.h:6005-6039)."""
        scale = 1.0 / self.resolution
        x, y, theta = float(pose[0]), float(pose[1]), float(pose[2])
        ct, st = np.cos(theta), np.sin(theta)
        x_steps = 1 + abs(max_range * ct) * scale
        y_steps = 1 + abs(max_range * st) * scale
        steps = max(x_steps, y_steps)
        delta = max_range / steps
        distance = delta
        for i in range(1, int(steps)):
            gx = self.world_to_grid(
                (x + distance * ct, y + distance * st)
            )
            if self.is_free(gx):
                distance = (i + 1) * delta
            else:
                break
        return distance if distance < max_range else max_range


# scans whose geometry is formed in one NumPy computation
POINTS_BLOCK = 4096


def _laser_blocks(scans):
    """`scans` POINTS_BLOCK at a time, a block whose scans' lasers differ
    split into blocks of one scan: each block is of one laser."""
    for b0 in range(0, len(scans), POINTS_BLOCK):
        group = scans[b0:b0 + POINTS_BLOCK]
        l0 = group[0].laser
        if all(s.laser is l0 or s.laser == l0 for s in group):
            yield group
        else:
            yield from ([s] for s in group)


def _local(group):
    """(ranges (n, B), local points (n, B, 2), filtered masks (n, B)) of
    scans of one laser: each scan's local_points and filtered_mask,
    formed for all of them at once where every scan is a LocalizedScan
    (element for element the same arithmetic), else the scans' own."""
    r = np.stack([s.ranges for s in group])
    if any(type(s) is not LocalizedScan for s in group):
        return (r, np.stack([s.local_points for s in group]),
                np.stack([s.filtered_mask for s in group]))
    laser = group[0].laser
    ca, sa = _beam_trig(laser)
    keep = (np.isfinite(r) & (r >= laser.min_range)
            & (r <= laser.range_threshold))
    return r, np.stack([r * ca, r * sa], axis=-1), keep


def _world_points(group, lp):
    """(sensor poses (n, 3), world beam endpoints (n, B, 2)) of scans of
    one laser with local points `lp`, each scan's
    points_world(filtered=False) computed for all of them at once (the
    same arithmetic element for element)."""
    sp = np.stack([s.sensor_pose for s in group])
    c = np.cos(sp[:, 2])[:, None]
    sn = np.sin(sp[:, 2])[:, None]
    pts = np.stack([sp[:, 0:1] + c * lp[..., 0] - sn * lp[..., 1],
                    sp[:, 1:2] + sn * lp[..., 0] + c * lp[..., 1]], axis=-1)
    return sp, pts


def compute_dimensions(scans, resolution: float):
    """Union of scan bounding boxes -> (width, height, offset)
    (ComputeDimensions, Karto.h:6088-6112). The scans are taken a block
    of one laser at a time (_laser_blocks); the minimum and maximum are
    exact, so the union equals the scans' bounding_box folded one by
    one."""
    mins = np.full(2, np.inf)
    maxs = np.full(2, -np.inf)
    for group in _laser_blocks([s for s in scans if s is not None]):
        _, lp, keep = _local(group)
        sp, pts = _world_points(group, lp)
        keep = keep[..., None]
        mins = np.minimum(mins, np.minimum(
            sp[:, :2].min(axis=0),
            np.where(keep, pts, np.inf).min(axis=(0, 1))))
        maxs = np.maximum(maxs, np.maximum(
            sp[:, :2].max(axis=0),
            np.where(keep, pts, -np.inf).max(axis=(0, 1))))
    scale = 1.0 / resolution
    size = maxs - mins
    width = int(round_half_away_f32(size[0] * scale))
    height = int(round_half_away_f32(size[1] * scale))
    return width, height, mins


def _beam_cells(group, offset, scale):
    """Host-side beam prep shared by both routes: per-beam (start_cell,
    end_cell, beam_valid, end_valid) with the range-threshold endpoint
    clamp (AddScan, Karto.h:6146-6189). Each block of one laser
    (_laser_blocks) is prepared in one NumPy computation, element for
    element the per-scan one."""
    parts = [_laser_beam_cells(g, offset, scale)
             for g in _laser_blocks(group)]
    if len(parts) == 1:
        return parts[0]
    return tuple(np.concatenate(p) for p in zip(*parts))


def _laser_beam_cells(group, offset, scale):
    laser = group[0].laser
    r, lp, _ = _local(group)
    sp, pts = _world_points(group, lp)
    spos = sp[:, None, :2]
    with np.errstate(invalid="ignore"):
        use = (
            np.isfinite(r)
            & (r > laser.min_range)
            & (r < laser.max_range)
        )
        clamp = use & (r >= laser.range_threshold)
    ratio = np.where(
        clamp, laser.range_threshold / np.where(r > 0, r, 1.0), 1.0
    )
    pts = spos + ratio[..., None] * (pts - spos)
    end_ok = use & (r < laser.range_threshold - 1e-6)
    sc = round_half_away_f32((sp[:, :2] - offset) * scale).astype(np.int32)
    with np.errstate(invalid="ignore", over="ignore"):
        ec = round_half_away_f32(
            (np.nan_to_num(pts, nan=-1e6) - offset) * scale
        ).astype(np.int32)
    n, b = r.shape
    return (np.repeat(sc, b, axis=0), ec.reshape(n * b, 2),
            use.reshape(-1), end_ok.reshape(-1))


def _use_native(device, native) -> bool:
    """The route: `native` when given (True raises without the library),
    else the native library for the CPU and trace_beams on a card."""
    from slam_toolbox_tpu_torch import native as lib_mod

    if native is False or (native is None and device.type != "cpu"):
        return False
    lib = lib_mod.get_lib()
    have = lib is not None and hasattr(lib, "occupancy_raster")
    if native and not have:
        raise RuntimeError("the native occupancy raster did not load")
    return have


def _accumulate(scans, offset, scale, width, height, pass0, hit0, chunk,
                device, native=None):
    """Accumulate pass/hit counters over `scans` on the route
    `_use_native` picks. Returns np.int32 (H, W) arrays; the routes agree
    bit for bit."""
    rt = min(s.laser.range_threshold for s in scans)
    max_steps = int(np.ceil(rt * scale)) + 8
    if _use_native(device, native):
        from slam_toolbox_tpu_torch import native

        pass_np = np.ascontiguousarray(pass0, np.int32).copy()
        hit_np = np.ascontiguousarray(hit0, np.int32).copy()
        for c0 in range(0, len(scans), chunk):
            st, en, bv, ev = _beam_cells(
                scans[c0:c0 + chunk], offset, scale
            )
            native.occupancy_raster(
                st, en, bv, ev, width, height, pass_np, hit_np
            )
        return pass_np, hit_np
    pass_cnt, hit_cnt = _trace_scans(
        scans, offset, scale, width, height,
        upload(np.asarray(pass0, np.int32), device),
        upload(np.asarray(hit0, np.int32), device), chunk, max_steps,
    )
    return pass_cnt.cpu().numpy(), hit_cnt.cpu().numpy()


def _trace_scans(scans, offset, scale, width, height, pass_cnt, hit_cnt,
                 chunk, max_steps, row0=0):
    """The tensor route's chunked trace: `chunk` scans at a time, their
    beams prepared on the host per chunk and padded to chunk * the first
    scan's beams (one trace shape per render), traced into the (height,
    W) counters on their device. `row0` is the global grid row of the
    counters' row 0: the beams are shifted down by it (Bresenham is
    translation invariant) and cells outside the window are dropped, which
    lets the sharded raster trace one row band. Returns (pass, hit)."""
    dev = pass_cnt.device
    n_pad = chunk * scans[0].laser.n_beams
    shift = np.array([0, row0], np.int32)
    for c0 in range(0, len(scans), chunk):
        st, en, bv, ev = _beam_cells(scans[c0:c0 + chunk], offset, scale)
        pass_cnt, hit_cnt = trace_beams(
            pass_cnt, hit_cnt,
            upload(_pad2(st - shift, n_pad), dev),
            upload(_pad2(en - shift, n_pad), dev),
            upload(_pad1(bv, n_pad), dev),
            upload(_pad1(ev, n_pad), dev),
            width, height, max_steps,
        )
    return pass_cnt, hit_cnt


def _grid(pass_np, hit_np, offset, resolution, min_pass_through,
          occupancy_threshold, device) -> OccupancyGrid:
    cells = update_cells(
        upload(pass_np, device), upload(hit_np, device),
        min_pass_through, occupancy_threshold,
    )
    return OccupancyGrid(cells.cpu().numpy(), offset, resolution,
                         pass_cnt=pass_np, hit_cnt=hit_np)


def create_from_scans(
    scans: List,
    resolution: float,
    min_pass_through: int = 2,
    occupancy_threshold: float = 0.1,
    chunk: int = 64,
    device=None,
    native=None,
) -> OccupancyGrid:
    """Full re-raster of all corrected scans (CreateFromScans,
    Karto.h:5947-6143). `device` defaults to "cuda" and raises without a
    card; the tensor route traces there, and the cells are thresholded
    there on both routes. `native` picks the route (see _use_native)."""
    device = resolve_device(device)
    scans = [s for s in scans if s is not None]
    if not scans:
        return None
    width, height, offset = compute_dimensions(scans, resolution)
    width, height = max(width, 1), max(height, 1)
    scale = 1.0 / resolution
    zeros = np.zeros((height, width), np.int32)
    pass_np, hit_np = _accumulate(
        scans, offset, scale, width, height, zeros, zeros, chunk, device,
        native,
    )
    return _grid(pass_np, hit_np, offset, resolution, min_pass_through,
                 occupancy_threshold, device)


def add_scans_incremental(
    grid: OccupancyGrid,
    scans: List,
    min_pass_through: int = 2,
    occupancy_threshold: float = 0.1,
    chunk: int = 64,
    device=None,
    native=None,
) -> OccupancyGrid:
    """Fold additional scans into an existing grid's hit/pass counters and
    re-threshold (the reference's AddScan(doUpdate=true) incremental path,
    Karto.h:6146-6189: here the counters update in one batched trace and
    cells re-threshold once). Scans must fall inside the grid's extent;
    out-of-bounds beams are dropped like the reference."""
    device = resolve_device(device)
    scans = [s for s in scans if s is not None]
    if not scans:
        return grid
    if grid.pass_cnt is None or grid.hit_cnt is None:
        raise ValueError("grid was created without counters")
    height, width = grid.pass_cnt.shape
    scale = 1.0 / grid.resolution
    pass_np, hit_np = _accumulate(
        scans, grid.offset, scale, width, height,
        grid.pass_cnt, grid.hit_cnt, chunk, device, native,
    )
    return _grid(pass_np, hit_np, grid.offset, grid.resolution,
                 min_pass_through, occupancy_threshold, device)


def _pad2(a, n):
    out = np.zeros((n, 2), a.dtype)
    out[: len(a)] = a
    return out


def _pad1(a, n):
    out = np.zeros((n,), a.dtype)
    out[: len(a)] = a
    return out
