"""Correlation-raster construction: batched scatter + separable Gaussian smear.

PyTorch counterpart of slam_toolbox_tpu/kernels/rasterize.py (the
CorrelationGrid / ScanMatcher::AddScans re-design, Mapper.h:1074-1314,
Mapper.cpp:1032-1105). All base-scan points are scattered at once and the
Gaussian max-blend is a separable max-times dilation
(exp(-(dx^2+dy^2)/2s^2) = f(dx)*f(dy) with f >= 0, so the max over the
window factors into two 1-D passes).

`rasterize_smear` is the plain version of the two hand-written kernels
in kernels/match_cuda.py (scatter_occupancy, smear_quantize) and runs
their exact arithmetic: the same f32 products, maxima and rounding.

The occupancy passes between the two as bits packed along axis 0 (the
smear's first pass): a (ceil(G/32), G) int32 array whose word (q, c)
holds rows 32q .. 32q+31 of column c, bit r & 31 for row r. int32
carries the 32 bits (bit 31 makes a word negative); rows at or beyond G
are never set.
"""
from __future__ import annotations

import numpy as np
import torch


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Round half away from zero, matching karto::math::Round (Math.h:87-90).

    torch.round rounds half to even, which would disagree on .5
    boundaries."""
    return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))


def half_kernel_size(smear_deviation: float, resolution: float) -> int:
    """Smear window half-size = round(2*sigma/res) (Mapper.h:1275-1280)."""
    return int(np.floor(2.0 * smear_deviation / resolution + 0.5))


def smear_weights(sigma_cells: float, half_kernel: int) -> np.ndarray:
    """(2*hk+1,) float32 taps w_k = exp(-0.5 (k/sigma)^2).

    The exponent is formed in f32 exactly as the JAX package forms it; the
    exp itself is taken in f64 and rounded once to f32, which gives the
    correctly rounded tap on every backend. (XLA's f32 exp on the CPU is
    one ulp low at k = +-19 for sigma = 10, the bench geometry.)"""
    k = np.arange(-half_kernel, half_kernel + 1, dtype=np.float32)
    arg = np.float32(-0.5) * (k / np.float32(sigma_cells)) ** 2
    return np.exp(arg.astype(np.float64)).astype(np.float32)


def check_smear_taps(w: np.ndarray) -> None:
    """Raise ValueError unless the (2*hk+1,) taps are finite,
    non-negative, symmetric bit for bit and non-increasing outward from
    the centre: the smear kernel relies on it (its row pass takes the tap
    at the nearest occupied offset, its column pass pairs the taps +-k).
    smear_weights' taps always meet it."""
    w = np.asarray(w, np.float32)
    hk = (len(w) - 1) // 2
    if w.ndim != 1 or len(w) != 2 * hk + 1:
        raise ValueError(f"smear taps: odd-length vector expected, got "
                         f"shape {w.shape}")
    if not (np.all(np.isfinite(w)) and np.all(w >= 0)):
        raise ValueError("smear taps: not finite and non-negative")
    if not np.array_equal(w.view(np.int32), w[::-1].view(np.int32)):
        raise ValueError("smear taps: not symmetric")
    if np.any(np.diff(w[hk:]) > 0):
        raise ValueError("smear taps: increase away from the centre")


def occupancy_words(grid_size: int) -> int:
    """Word rows of the packed occupancy: ceil(G / 32)."""
    return (grid_size + 31) // 32


def cell_coords(points, valid, offset, scale, grid_size: int):
    """(ix, iy, inb): cells round_half_away((p - offset) * scale) in f32
    and the in-grid mask. The mask is decided on the floats, before any
    float->int conversion (padding points sit at -1e9)."""
    f = round_half_away((points - offset[None, :]) * scale)
    inb = valid & (f >= 0).all(dim=1) & (f < grid_size).all(dim=1)
    g = torch.where(inb[:, None], f, torch.zeros_like(f)).to(torch.int64)
    return g[:, 0], g[:, 1], inb


def scatter_occupancy_plain(points, valid, offset, scale, grid_size: int):
    """(ceil(G/32), G) int32 packed binary occupancy (module docstring):
    the bit of cell (iy, ix) is set for every valid in-grid point. The
    OR is a sum of 1 << bit over the distinct cells. Plain version of the
    scatter kernel."""
    G = grid_size
    ix, iy, inb = cell_coords(points, valid, offset, scale, G)
    cells = torch.unique((iy * G + ix)[inb])
    iy, ix = cells // G, cells % G
    words = torch.zeros(occupancy_words(G) * G, dtype=torch.int64,
                        device=points.device)
    words.index_add_(0, (iy >> 5) * G + ix, torch.ones_like(iy) << (iy & 31))
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32).view(-1, G)


def unpack_occupancy(words, grid_size: int):
    """(G, G) uint8 0/1 grid of the packed occupancy; bits of rows at or
    beyond G are dropped."""
    G = grid_size
    bit = torch.arange(32, dtype=torch.int32, device=words.device)
    occ = (words[:, None, :] >> bit[None, :, None]) & 1   # (nw, 32, G)
    return occ.reshape(-1, G)[:G].to(torch.uint8)


def smear_quantize_plain(words, w, grid_size: int, half_kernel: int):
    """(G*G+1,) int8 raster: separable max-times smear of the packed 0/1
    occupancy (rows, then columns), quantized to round_half_away(100*z),
    with a zero sink cell appended. Plain version of the smear kernel;
    it holds for any taps."""
    G, hk = grid_size, half_kernel
    x = unpack_occupancy(words, G).to(torch.float32)
    for dim in (0, 1):
        pad = [0, 0, 0, 0]
        pad[2 * (1 - dim)] = pad[2 * (1 - dim) + 1] = hk
        p = torch.nn.functional.pad(x, pad)
        out = torch.zeros_like(x)
        for j in range(2 * hk + 1):
            out = torch.maximum(out, w[j] * p.narrow(dim, j, G))
        x = out
    q = round_half_away(x * 100.0).to(torch.int8).reshape(-1)
    return torch.cat([q, q.new_zeros(1)])


def rasterize_smear(points, valid, offset, scale, sigma_cells,
                    grid_size: int, half_kernel: int):
    """(G*G+1,) int8 correlation raster of `points` (P, 2) f32 with mask
    `valid` (P,): scatter, smear, quantize, zero sink."""
    w = torch.from_numpy(smear_weights(sigma_cells, half_kernel)).to(
        points.device)
    occ = scatter_occupancy_plain(points, valid, offset, scale, grid_size)
    return smear_quantize_plain(occ, w, grid_size, half_kernel)


def find_valid_points_structure(points: np.ndarray):
    """Precompute the viewpoint-independent structure of
    ScanMatcher::FindValidPoints (Mapper.cpp:1113-1164).

    The reference walks the beam endpoints keeping a trailing anchor: every
    time the current point is > 0.1 m from the anchor it emits a "delimiter"
    and a side-of-viewpoint test there decides whether the run of points
    since the previous delimiter is kept. Anchors depend only on the points,
    so they are cached per scan; the per-match part (the determinant sign
    against the current viewpoint) is vectorized in find_valid_mask.

    Returns (delim_idx, anchor_xy, next_delim_of_point):
      delim_idx:  (D,) indices of delimiter points
      anchor_xy:  (D, 2) the anchor (previous firstPoint) at each delimiter
      next_delim: (B,) for each point, index into delim arrays of the
                  delimiter that flushes it, or -1 if never flushed.
    """
    from slam_toolbox_tpu_torch import native

    out = native.fvp_structure(points)
    if out is not None:
        return out
    B = len(points)
    finite = np.isfinite(points).all(axis=1)
    delim_idx, anchors = [], []
    anchor = None
    for i in range(B):
        p = points[i]
        if anchor is None:
            if finite[i]:
                anchor = p
            continue
        d = anchor - p
        if d[0] * d[0] + d[1] * d[1] > 0.01:  # (0.1 m)^2, strict >
            delim_idx.append(i)
            anchors.append(anchor.copy())
            anchor = p.copy()
    delim_idx = np.asarray(delim_idx, dtype=np.int64)
    anchors = (
        np.asarray(anchors, dtype=np.float64)
        if anchors
        else np.zeros((0, 2))
    )
    next_delim = np.full(B, -1, dtype=np.int64)
    # points strictly before delimiter d (and at/after previous delimiter)
    # are flushed by d; the delimiter point itself belongs to the next run.
    prev = 0
    for k, di in enumerate(delim_idx):
        next_delim[prev:di] = k
        prev = di
    return delim_idx, anchors, next_delim


def find_valid_mask(points: np.ndarray, structure, viewpoint: np.ndarray):
    """Per-match validity of each beam endpoint for rasterization, given the
    cached structure and the current viewpoint (Mapper.cpp:1144-1159)."""
    delim_idx, anchors, next_delim = structure
    B = len(points)
    if len(delim_idx) == 0:
        return np.zeros(B, dtype=bool)
    first = anchors  # (D,2): firstPoint at test time
    cur = points[delim_idx]  # (D,2): currentPoint
    a = viewpoint[1] - first[:, 1]
    b = first[:, 0] - viewpoint[0]
    c = first[:, 1] * viewpoint[0] - first[:, 0] * viewpoint[1]
    ss = cur[:, 0] * a + cur[:, 1] * b + c
    keep_run = ss >= 0.0  # (D,)
    mask = np.zeros(B, dtype=bool)
    has = next_delim >= 0
    mask[has] = keep_run[next_delim[has]]
    # NaN endpoints are later bounds-rejected anyway, but be explicit:
    mask &= np.isfinite(points).all(axis=1)
    return mask
