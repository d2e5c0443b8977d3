"""Submap sharding with halo exchange: the row-band occupancy raster.

PyTorch counterpart of slam_toolbox_tpu/dist/submap.py. The global map is
decomposed into per-rank ROW BANDS; each rank rasterizes only the scans
whose sensor sits in its band into a local band+halo buffer, and the halo
rows (the cells a scan paints beyond its own band) are exchanged with
ring shifts (JAX's ppermute) and accumulated by their owners. Pass/hit
accumulation is an integer sum, so the sharded result is bit for bit the
single-device raster (kernels.occupancy.create_from_scans).

Halo width = range_threshold / resolution (+ rounding slack): no beam can
paint a cell further from its sensor row, so every scatter lands in the
owner's buffer, and any matcher window around a pose inside a band is
covered by that band's buffer after the halo refresh (local_window),
since the loop matcher's search window is narrower than the range
threshold that sizes the halo.

When the halo is wider than a band (small maps on many ranks) the
exchange runs ceil(halo/band) shifts per direction; contributions past
the global grid edge are dropped at scatter time, so the ring wraparound
carries only zeros and the non-periodic domain stays exact. A shift by a
multiple of the rank count (every shift on one rank) is a local copy.

Each rank traces its scans into its band with the tensor route of
kernels.occupancy (_trace_scans: trace_beams on the rank's device, 64
scans at a time, their beams prepared per chunk): the (beams, max_steps)
cell indices of a large merge (17 M beams x 248 steps) traced at once
would take tens of GB.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from slam_toolbox_tpu_torch.device import world_size
from slam_toolbox_tpu_torch.dist import multihost
from slam_toolbox_tpu_torch.kernels import occupancy as occ

# scans traced per trace_beams call, as create_from_scans traces them
CHUNK_SCANS = 64
# the auto gate's grid size, the JAX package's: below it one device renders
# faster than the exchange pays back (not yet measured across cards)
AUTO_MIN_CELLS = 8_000_000


def _band_geometry(height: int, n_dev: int, halo: int):
    band = -(-height // n_dev)  # ceil
    hops = -(-halo // band)
    return band, hops


def make_sharded_raster(
    mesh, width: int, height: int, halo: int, max_steps: int,
    min_pass_through: int = 2, occupancy_threshold: float = 0.1,
):
    """Build this rank's sharded rasterizer. Returns (fn, band).

    fn(scans, offset, scale) takes the scans assigned to this rank's band
    (the JAX function takes their beams; the port prepares them per chunk
    as it traces) and returns this rank's owned (band, W) rows on
    mesh.device: (cells uint8, pass int32, hit int32); global rows past
    `height` (the last band's padding) are zero."""
    n_dev = mesh.size
    band, hops = _band_geometry(height, n_dev, halo)
    lh = band + 2 * halo  # local buffer height
    row0 = mesh.rank * band - halo  # global row of local buffer row 0
    # rows of the local buffer inside the global grid; cells outside it
    # are dropped, which also keeps the ring wraparound zero-filled
    lo = max(0, -row0)
    hi = min(lh, height - row0)
    dev = mesh.device

    def fn(scans, offset, scale):
        buf_pass = torch.zeros((lh, width), dtype=torch.int32, device=dev)
        buf_hit = torch.zeros_like(buf_pass)
        if hi > lo and scans:
            # trace into the in-grid window of the buffer, whose row 0 is
            # global row row0 + lo
            buf_pass[lo:hi], buf_hit[lo:hi] = occ._trace_scans(
                scans, offset, scale, width, hi - lo, buf_pass[lo:hi],
                buf_hit[lo:hi], CHUNK_SCANS, max_steps, row0 + lo,
            )
        pass_b = exchange(buf_pass)
        hit_b = exchange(buf_hit)
        cells_b = occ.update_cells(pass_b, hit_b, min_pass_through,
                                   occupancy_threshold)
        return cells_b, pass_b, hit_b

    def exchange(buf):
        """Every rank keeps its own mid-band and absorbs the overlapping
        halo rows of senders up to `hops` bands away."""
        owned = buf[halo:halo + band].clone()
        for kk in range(1, hops + 1):
            # receive from band d-kk: my owned global row r maps to its
            # buffer row r - (d-kk)*band + halo = local + kk*band + halo
            up = mesh.shift(buf, kk)
            a = kk * band + halo
            b = min(lh, a + band)
            if b > a:
                owned[0:b - a] += up[a:b]
            # receive from band d+kk: its buffer row = local + halo -
            # kk*band
            down = mesh.shift(buf, -kk)
            a2 = halo - kk * band
            a2c, b2c = max(a2, 0), min(a2 + band, lh)
            if b2c > a2c:
                owned[a2c - a2:b2c - a2] += down[a2c:b2c]
        return owned

    return fn, band


def assign_scans_to_bands(
    scans: List, offset, scale, height: int, band: int, n_dev: int,
):
    """Host-side: group scans by the band owning their sensor row."""
    groups = [[] for _ in range(n_dev)]
    for s in scans:
        if s is None:
            continue
        cy = int(occ.round_half_away_f32(
            (s.sensor_pose[1] - offset[1]) * scale))
        d = min(max(cy, 0), height - 1) // band
        groups[int(min(d, n_dev - 1))].append(s)
    return groups


def sharded_occupancy(
    mesh, scans: List, resolution: float,
    min_pass_through: int = 2, occupancy_threshold: float = 0.1,
):
    """End-to-end sharded render: compute dimensions, assign scans to
    bands, raster + halo exchange on every rank, gather the bands; every
    rank returns the OccupancyGrid equal to
    kernels.occupancy.create_from_scans (bit for bit)."""
    n_dev = mesh.size
    width, height, offset = occ.compute_dimensions(scans, resolution)
    width, height = max(width, 1), max(height, 1)
    scale = 1.0 / resolution
    rt = max(s.laser.range_threshold for s in scans if s is not None)
    halo = int(np.ceil(rt * scale)) + 2
    band, _ = _band_geometry(height, n_dev, halo)
    groups = assign_scans_to_bands(scans, offset, scale, height, band, n_dev)
    max_steps = int(np.ceil(rt * scale)) + 8  # matches occ._accumulate
    fn, band = make_sharded_raster(
        mesh, width, height, halo, max_steps, min_pass_through,
        occupancy_threshold,
    )
    cells, pass_b, hit_b = (mesh.all_gather(t)[:height].cpu().numpy()
                            for t in fn(groups[mesh.rank], offset, scale))
    return occ.OccupancyGrid(cells, offset, resolution, pass_cnt=pass_b,
                             hit_cnt=hit_b)


def _use_sharded(scans, resolution: float, sharded: str, mesh) -> bool:
    """The gate: "1" takes the sharded raster on a mesh of more than one
    rank, "0" never; "auto" on a CUDA mesh of more than one rank for a
    grid of more than AUTO_MIN_CELLS cells (a CPU mesh adds collectives
    without adding memory bandwidth: the native host Bresenham stays
    faster there)."""
    if sharded == "0" or mesh.size <= 1:
        return False
    if sharded == "1":
        return True
    live = [s for s in scans if s is not None]
    if mesh.device.type != "cuda" or not live:
        return False
    w, h, _ = occ.compute_dimensions(live, resolution)
    return w * h > AUTO_MIN_CELLS


def maybe_sharded_create_from_scans(
    scans: List, resolution: float,
    min_pass_through: int = 2, occupancy_threshold: float = 0.1,
    device=None, sharded: str = "auto",
):
    """Live-path entry: route occupancy renders through the row-band
    sharded raster when the gate (`sharded`: "auto", "1" or "0", see
    _use_sharded) opens, else kernels.occupancy.create_from_scans on
    `device`. Bit-exact either way (integer accumulation), so callers
    (SlamSession.get_occupancy_grid full rebuilds, MapMerger.merge) can
    switch on topology alone. With no process group the gate is closed at
    the cost of one call."""
    if sharded not in ("auto", "1", "0"):
        raise ValueError(f"sharded={sharded!r}: expected auto, 1 or 0")
    if sharded != "0" and world_size() > 1:
        mesh = multihost.global_mesh(device)
        if _use_sharded(scans, resolution, sharded, mesh):
            return sharded_occupancy(
                mesh, [s for s in scans if s is not None], resolution,
                min_pass_through, occupancy_threshold,
            )
    return occ.create_from_scans(
        scans, resolution, min_pass_through, occupancy_threshold,
        device=device,
    )


def make_halo_refresh(mesh, band: int, halo: int, width: int):
    """After the owner accumulation each rank holds complete counts for
    its own band only. This second round of ring shifts hands every rank
    the adjacent rows of its neighbors' owned bands, yielding a complete
    (band + 2*halo, W) local view, after which any matcher window around a
    pose inside the band is a pure local slice (local_window), with no
    per-query communication. Returns f(owned (band, W)) -> (band + 2*halo,
    W) on the owned tensor's device."""
    n_dev = mesh.size
    hops = -(-halo // band)
    lh = band + 2 * halo
    d = mesh.rank

    def f(owned):
        full = owned.new_zeros((lh, owned.shape[1]))
        full[halo:halo + band] = owned
        for kk in range(1, hops + 1):
            # the ring wraps: rank d receives (d-kk) % n_dev, which for
            # d < kk is a real band from the far edge, not zero padding:
            # the paste is masked to senders that exist above/below
            up = mesh.shift(owned, kk)      # owned band of rank d-kk
            if d - kk >= 0:
                # its owned global rows [(d-kk)*band, ...) land at local
                # rows [halo - kk*band, halo - kk*band + band)
                a = halo - kk * band
                a_c, b_c = max(a, 0), min(a + band, lh)
                if b_c > a_c:
                    full[a_c:b_c] = up[a_c - a:b_c - a]
            down = mesh.shift(owned, -kk)
            if d + kk < n_dev:
                a = halo + kk * band
                a_c, b_c = max(a, 0), min(a + band, lh)
                if b_c > a_c:
                    full[a_c:b_c] = down[a_c - a:b_c - a]
        return full

    return f


def local_window(full_pass, full_hit, band: int, halo: int, d: int,
                 row_lo: int, row_hi: int):
    """Global rows [row_lo, row_hi) around a query pose from band d's
    refreshed (band + 2*halo) local view: the window any matcher needs
    around a pose inside band d (window half-height <= halo by
    construction)."""
    r0 = d * band
    lo_l = row_lo - r0 + halo
    hi_l = row_hi - r0 + halo
    assert 0 <= lo_l and hi_l <= band + 2 * halo, (
        "window exceeds the halo — widen halo or shrink the window"
    )
    return full_pass[lo_l:hi_l], full_hit[lo_l:hi_l]
