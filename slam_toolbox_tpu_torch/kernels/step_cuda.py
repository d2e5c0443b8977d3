"""Hand-written CUDA kernels of the scan step's tensor code, and their
plain versions.

The JAX package's drain step is one traced body inside lax.fori_loop
(slam_toolbox_tpu/mapper/streaming.py _stream_raster_impl and
_stream_update_impl), and its match one jit (kernels/match.py
_score_impl): XLA fuses their tensor code into a few fusions around the
three Pallas calls. None of the three kernels here replaces a Pallas
kernel; each stands for one such group of XLA-fused code:

  ring_points    <- the ring's world points, device FindValidPoints and,
                    in step mode, the prior (_stream_raster_impl :165)
  score_tail     <- the rest of _score_impl after the window sums:
                    penalties, tie averages, covariances and the fine
                    pass (:758-800, :599, :626, :656)
  stream_update  <- _stream_update_impl's pose update, ring push,
                    eviction and result append (:223)

_score_impl's head (its coarse headings, rotated tables and lattice
origin, kernels/match.py :717-758, :612) is folded into the window-sum
kernel (K1, csrc/score_windows.cu): score_windows_head below is its
wrapper, its plain version score_head_plain followed by
match_cuda.score_windows_plain, its launches counted under
score_windows.

On a card a match runs score_windows_head (K1) -> score_tail, and a
drain step ring_points -> scatter_occupancy (K2) -> smear_quantize (K3)
-> score_windows_head -> score_tail -> stream_update: six launches.

The wrappers follow kernels/match_cuda.py: given CPU tensors a wrapper
runs its plain version, given CUDA tensors it launches its kernel
(built at first use by match_cuda's build, bound through ctypes) or
raises; it counts its launches in match_cuda.LAUNCHES and GRID_LAUNCHES
under the raster side G it serves, and inside match_cuda.tallied() into
the graph's tally. The plain versions are the port's tensor code as it
ran before these kernels, moved behind the wrappers' signatures, so
the CPU runs exactly what it ran.

Numerics. The kernels are built with --fmad=false and repeat the plain
version's f32 operations term by term with CUDA's cosf, sinf, atan2f,
sqrtf, floorf, ceilf and rintf, and PyTorch's own rule for a division by
a Python number on a card (a product with the f32 reciprocal): so
integer outputs (tables, cells, window sums, validity, tie counts, the
ring's indices) and elementwise outputs (points, center_off, prior, the
corrected pose, the ring pose) equal the plain version's on the card bit
for bit. The sums of the tie averages and covariances are taken in a
fixed order (score_tail's in fixed trees across its cluster), so a
kernel repeats bit for bit, but not in PyTorch's order: the mean and the
covariances agree with the plain version within the tolerances below
(chip_smoke.py, the card tests).
"""
from __future__ import annotations

import ctypes
import math

import torch

from slam_toolbox_tpu_torch.core.geometry import KT_TOLERANCE, MAX_VARIANCE
from slam_toolbox_tpu_torch.kernels import match_cuda as mc
from slam_toolbox_tpu_torch.kernels import rasterize as rz

_F32 = torch.float32
# score_tail's aux vector: [0] coarse tie count, [1] coarse best
# (clamped), [2:5] coarse mean, [5] fine tie count, [6] fine best
# (clamped), [7:10] fine mean, [10:13] fine cells x, [13:16] fine cells
# y, [16:18] the angular covariance's cell (x, y), then the fine window
# sums (na_f, 3, 3) and the angular sums (na_f,); integers are exact in
# f32 (their magnitudes stay below 2**24)
AUX_HEAD = 18
# tolerances of the reductions against the plain version on a card (the
# sums are taken in another order than PyTorch's): the mean's x and y in
# metres and its heading in radians; a covariance entry against the
# largest diagonal entry of its matrix (f32 sums of up to 81 x 81 terms)
MEAN_ATOL = 1e-5
COV_RTOL = 1e-4


def aux_len(na_fine: int) -> int:
    return AUX_HEAD + 10 * na_fine


def _rows(t, name, dtype, width, device):
    """Check a (n, width) tensor whose rows may be strided (a column
    slice of a pack); returns its row stride in elements."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t)}")
    if t.dtype != dtype or t.dim() != 2 or t.shape[1] != width:
        raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, expected "
                         f"{dtype} (n, {width})")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.shape[0] > 1 and t.stride(1) != 1:
        raise ValueError(f"{name}: elements of a row not contiguous")
    return t.stride(0)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _aligned16(t, name):
    """Raise unless `t` starts on a 16-byte boundary: ring_points' and
    stream_update's kernels move packs as 16-byte vectors (a pack's row
    stride, B * 32 bytes, keeps every pack of an aligned buffer
    aligned). Checked just before a launch: the plain versions take any
    buffer."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: starts at {t.data_ptr():#x}, not on a "
                         "16-byte boundary (the kernel's 16-byte loads)")


# -- the plain pieces ---------------------------------------------------------
def _unpack_scan(pack):
    """Decode per-scan (..., B, 8) f32 pack buffers:
    [local_xy, fvp_anchor_xy, fvp_current_xy, next_delim, flags]
    with flags bit0 = finite, bit1 = delimiter-slot valid."""
    local_pts = pack[..., 0:2]
    anchor = pack[..., 2:4]
    current = pack[..., 4:6]
    nxt = pack[..., 6].to(torch.int64)
    flags = pack[..., 7].to(torch.int32)
    finite = (flags & 1) > 0
    dvalid = (flags & 2) > 0
    return local_pts, anchor, current, nxt, finite, dvalid


def _compose(a, b):
    ca, sa = torch.cos(a[2]), torch.sin(a[2])
    h = a[2] + b[2]
    return torch.stack([
        a[0] + ca * b[0] - sa * b[1],
        a[1] + sa * b[0] + ca * b[1],
        torch.atan2(torch.sin(h), torch.cos(h)),
    ])


def _transform_between(p1, p2, p):
    dh = p2[2] - p1[2]
    c, s = torch.cos(dh), torch.sin(dh)
    tx = p2[0] - (c * p1[0] - s * p1[1])
    ty = p2[1] - (s * p1[0] + c * p1[1])
    h = p[2] + dh
    return torch.stack([
        tx + c * p[0] - s * p[1],
        ty + s * p[0] + c * p[1],
        torch.atan2(torch.sin(h), torch.cos(h)),
    ])


def _corrected_at(sensor_pose, offset_pose):
    ox, oy, oh = offset_pose[0], offset_pose[1], offset_pose[2]
    length = torch.sqrt(ox * ox + oy * oy)
    alpha = torch.atan2(oy, ox)
    hs = torch.atan2(torch.sin(sensor_pose[2]), torch.cos(sensor_pose[2]))
    wx = length * torch.cos(hs + alpha - oh)
    wy = length * torch.sin(hs + alpha - oh)
    h = hs - oh
    return torch.stack([
        sensor_pose[0] - wx, sensor_pose[1] - wy,
        torch.atan2(torch.sin(h), torch.cos(h)),
    ])


def _stream_prior(state, odom, offset_pose, half_span):
    """The step's prior propagation: (center_off (5,), prior (3,))."""
    prior = _transform_between(
        state["last_odom"], state["last_corrected"], odom
    )
    center = _compose(prior, offset_pose)
    off = center[:2] - half_span
    return torch.cat([center, off]), prior


def _evict(ring_pose, head, count, run_buffer_size: int, max_sq: float):
    """Running-buffer eviction by count and front-to-back distance
    (Mapper.cpp:182-204) as one vectorized count: evicting from the front
    never moves the back scan, so the reference's while-loop condition
    after e evictions is a function of e alone, and the number of
    evictions is the length of its leading run of True. Returns the new
    (head, count), device scalars."""
    K = ring_pose.shape[0]
    e = torch.arange(K, device=ring_pose.device)
    back = ring_pose.index_select(0, ((head + count - 1) % K).view(1))[0]
    front = ring_pose.index_select(0, (head + e) % K)
    d = front[:, :2] - back[:2]
    too_far = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) > max_sq
    ct = count - e
    cond = (ct > 1) & ((ct > run_buffer_size) | too_far)
    n_ev = torch.cumprod(cond.to(torch.int64), 0).sum()
    return (head + n_ev) % K, count - n_ev


def _penalized(raw, B, x_offsets, y_offsets, angles, center_h, penalize,
               dist_var_penalty, ang_var_penalty, min_dist_pen, min_ang_pen):
    """Response tensor (na, ny, nx) from integer window sums: sum / (B*100)
    and, under `penalize`, the distance and heading penalties
    (Mapper.cpp:874-904)."""
    resp = raw.to(_F32) / (float(B) * 100.0)
    if not penalize:
        return resp
    sq_xy = y_offsets[:, None] ** 2 + x_offsets[None, :] ** 2
    dist_pen = torch.clamp_min(
        1.0 - 0.2 * sq_xy / dist_var_penalty, min_dist_pen)
    sq_ang = (angles - center_h) ** 2
    ang_pen = torch.clamp_min(1.0 - 0.2 * sq_ang / ang_var_penalty,
                              min_ang_pen)
    pen = dist_pen[None, :, :] * ang_pen[:, None, None]
    return torch.where(resp.abs() > KT_TOLERANCE, resp * pen, resp)


def _gather_sums(grid_flat, G, sink, cand_x, cand_y, d, finite):
    """(na, ny, nx) int32 sums over beams of the raster at arbitrary
    candidate cells by plain gathers, through the sink for out-of-grid
    cells and non-finite beams (the fine pass)."""
    gx = d[:, :, 0].long()[:, :, None] + cand_x.long()[None, None, :]
    gy = d[:, :, 1].long()[:, :, None] + cand_y.long()[None, None, :]
    okx = (gx >= 0) & (gx < G)
    oky = (gy >= 0) & (gy < G)
    ok = (
        oky[:, :, :, None] & okx[:, :, None, :]
        & finite[None, :, None, None]
    )
    flat = torch.where(ok, gy[:, :, :, None] * G + gx[:, :, None, :], sink)
    return grid_flat[flat].to(torch.int32).sum(dim=1)


def _score_tensor(
    grid_flat, G, sink, cand_x, cand_y, d, finite,
    x_offsets, y_offsets, angles, center_h,
    penalize, dist_var_penalty, ang_var_penalty, min_dist_pen, min_ang_pen,
):
    """Response tensor (na, ny, nx) for arbitrary candidate cells by
    plain gathers (the fine pass)."""
    raw = _gather_sums(grid_flat, G, sink, cand_x, cand_y, d, finite)
    return _penalized(
        raw, d.shape[1], x_offsets, y_offsets, angles, center_h, penalize,
        dist_var_penalty, ang_var_penalty, min_dist_pen, min_ang_pen,
    )


def _tie_average(resp_p, wx, wy, angles):
    best = resp_p.max()
    tie = resp_p >= best - KT_TOLERANCE
    cnt = tie.sum()
    zero = resp_p.new_zeros(())
    avg_x = torch.where(tie, wx[None, None, :], zero).sum() / cnt
    avg_y = torch.where(tie, wy[None, :, None], zero).sum() / cnt
    tx = torch.where(tie, torch.cos(angles)[:, None, None], zero).sum() / cnt
    ty = torch.where(tie, torch.sin(angles)[:, None, None], zero).sum() / cnt
    return torch.clamp_max(best, 1.0), torch.stack(
        [avg_x, avg_y, torch.atan2(ty, tx)]
    )


def _rotated_tables(angles, local_pts, scale):
    """On-device (f32) rotated beam offsets in cells, (na, B, 2) int32;
    used by the fused path where the fine-pass angles depend on the coarse
    result (cell-boundary flips vs f64 are immaterial at runtime)."""
    c, s = torch.cos(angles), torch.sin(angles)
    rx = (c[:, None] * local_pts[None, :, 0]
          - s[:, None] * local_pts[None, :, 1]) * scale
    ry = (s[:, None] * local_pts[None, :, 0]
          + c[:, None] * local_pts[None, :, 1]) * scale
    return torch.stack(
        [rz.round_half_away(rx), rz.round_half_away(ry)], dim=-1
    ).to(torch.int32)


def _device_scalar(x, dev):
    """An f32 scalar on `dev`: a tensor as it is, a Python number filled
    on the device (no host-to-device copy, which would synchronize)."""
    if isinstance(x, torch.Tensor):
        return x.to(_F32)
    return torch.full((), x, dtype=_F32, device=dev)


def _positional_cov(probs, best, avg_x, avg_y, center, x_offsets, y_offsets,
                    step_xy, angle_step):
    dev = probs.device
    step_xy = _device_scalar(step_xy, dev)
    angle_step = _device_scalar(angle_step, dev)
    dx = avg_x - center[0]
    dy = avg_y - center[1]
    use = probs >= best - 0.1
    zero = probs.new_zeros(())
    norm = torch.where(use, probs, zero).sum()
    xm = x_offsets[None, :] - dx
    ym = y_offsets[:, None] - dy
    acc_xx = torch.where(use, xm**2 * probs, zero).sum()
    acc_xy = torch.where(use, xm * ym * probs, zero).sum()
    acc_yy = torch.where(use, ym**2 * probs, zero).sum()
    var_th = 4.0 * angle_step**2
    min_var = 0.1 * step_xy**2
    mult = 1.0 / torch.clamp_min(best, KT_TOLERANCE)
    vxx = torch.clamp_min(acc_xx / norm, min_var) * mult
    vyy = torch.clamp_min(acc_yy / norm, min_var) * mult
    vxy = (acc_xy / norm) * mult
    eye = torch.eye(3, dtype=_F32, device=dev)
    cov_ok = eye.clone()
    cov_ok[0, 0] = vxx
    cov_ok[0, 1] = vxy
    cov_ok[1, 0] = vxy
    cov_ok[1, 1] = vyy
    cov_ok[2, 2] = var_th
    cov_norm = torch.where(norm > KT_TOLERANCE, cov_ok, eye)
    cov_low = torch.diag(torch.stack([
        torch.full_like(var_th, MAX_VARIANCE),
        torch.full_like(var_th, MAX_VARIANCE), var_th,
    ]))
    return torch.where(best < KT_TOLERANCE, cov_low, cov_norm)


def _angular_cell(avg, offset, scale):
    """The raster cell (int64 x, y) of the fine mean, where the angular
    covariance gathers."""
    bx = rz.round_half_away((avg[0] - offset[0]) * scale).long()
    by = rz.round_half_away((avg[1] - offset[1]) * scale).long()
    return bx, by


def _angular_sums(grid_flat, G, sink, bx, by, d_fine, finite):
    """(na,) int32 sums over beams of the raster at cell (bx, by) under
    each heading's table."""
    agx = d_fine[:, :, 0].long() + bx
    agy = d_fine[:, :, 1].long() + by
    aok = (agx >= 0) & (agx < G) & (agy >= 0) & (agy < G) & finite[None, :]
    aflat = torch.where(aok, agy * G + agx, sink)
    return grid_flat[aflat].to(torch.int32).sum(dim=1)


def _angular_cov(grid_flat, G, sink, offset, scale, d_fine, finite,
                 avg, best, center_h, angles, angle_step):
    bx, by = _angular_cell(avg, offset, scale)
    B = d_fine.shape[1]
    resp_a = _angular_sums(grid_flat, G, sink, bx, by, d_fine,
                           finite).to(_F32) / (float(B) * 100.0)
    best_angle = avg[2] + 2 * math.pi * torch.round(
        (center_h - avg[2]) / (2 * math.pi)
    )
    use = resp_a >= best - 0.1
    zero = resp_a.new_zeros(())
    norm = torch.where(use, resp_a, zero).sum()
    acc = torch.where(use, (angles - best_angle) ** 2 * resp_a, zero).sum()
    step_sq = _device_scalar(angle_step, acc.device) ** 2
    acc = torch.where(acc < KT_TOLERANCE, step_sq, acc)
    return torch.where(norm > KT_TOLERANCE, acc / norm, 1000.0 * step_sq)


# -- K5: ring points ----------------------------------------------------------
def ring_points_plain(packs, poses, slot_valid, viewpoint_xy):
    """World points and device FindValidPoints of a ring or chain of scan
    packs (C, B, 8) at f32 poses (C, 3), seen from `viewpoint_xy` (2,):
    returns the flat (C*B, 2) points and (C*B,) validity. `slot_valid`
    (C,) masks whole scans (None: all valid). The reference's operation
    order is kept term by term, since no contraction may flip the
    `ss >= 0` side test or move a point across a cell edge."""
    local, anchor, cur, nxt, finite, dvalid = _unpack_scan(packs)
    c, s = torch.cos(poses[:, 2]), torch.sin(poses[:, 2])
    wx = (poses[:, 0:1] + c[:, None] * local[:, :, 0]
          - s[:, None] * local[:, :, 1])
    wy = (poses[:, 1:2] + s[:, None] * local[:, :, 0]
          + c[:, None] * local[:, :, 1])
    pts = torch.stack([wx, wy], dim=-1)

    dvx = viewpoint_xy[0] - poses[:, 0]
    dvy = viewpoint_xy[1] - poses[:, 1]
    vxl = c * dvx + s * dvy
    vyl = -s * dvx + c * dvy
    a = vyl[:, None] - anchor[:, :, 1]
    b = anchor[:, :, 0] - vxl[:, None]
    cc = anchor[:, :, 1] * vxl[:, None] - anchor[:, :, 0] * vyl[:, None]
    ss = cur[:, :, 0] * a + cur[:, :, 1] * b + cc
    keep_run = (ss >= 0.0) & dvalid
    keep = torch.gather(keep_run, 1, nxt.clamp_min(0))
    valid = (nxt >= 0) & keep & finite
    if slot_valid is not None:
        valid = valid & slot_valid[:, None]
    C, B = local.shape[0], local.shape[1]
    return pts.reshape(C * B, 2), valid.reshape(C * B)


# scratch bytes of ring_points' kernel by (scans, beams), as its library
# answers (0: the flags in shared memory)
_RING_SCRATCH = {}


def ring_scratch_bytes(C: int, B: int, lib=None) -> int:
    """The scratch ring_points' kernel takes for C scans of B beams: 0
    where a block's keep_run flags (a byte a beam) fit its shared memory,
    else C * B (csrc/ring_points.cu ring_points_scratch_bytes); asked
    once per geometry."""
    n = _RING_SCRATCH.get((C, B))
    if n is None:
        lib = lib or mc._lib("ring_points")
        n = _RING_SCRATCH[C, B] = int(lib.ring_points_scratch_bytes(C, B))
    return n


def _launch_ring_points(packs, poses, slot_valid, viewpoint, G, step=None):
    """One launch of the ring-points kernel; `step` holds the step mode's
    tensors (reads, then writes) or is None. Past its shared memory the
    kernel keeps each scan's flags in a scratch buffer allocated here
    (ring_scratch_bytes)."""
    dev = packs.device
    C, B = packs.shape[0], packs.shape[1]
    pts = torch.empty((C * B, 2), dtype=_F32, device=dev)
    valid = torch.empty(C * B, dtype=torch.bool, device=dev)
    s = step or {}
    _aligned16(packs, "ring_pack" if step else "packs")
    for key in ("batch_packs", "scan_pack"):
        if key in s:
            _aligned16(s[key], key)
    lib = mc._lib("ring_points")
    nbytes = ring_scratch_bytes(C, B, lib)
    flags = (torch.empty(nbytes, dtype=torch.uint8, device=dev)
             if nbytes else None)
    mc._raise_if(lib.ring_points(
        packs.data_ptr(), poses.data_ptr(), poses.stride(0),
        _ptr(slot_valid), _ptr(viewpoint), C, B,
        _ptr(s.get("step")), _ptr(s.get("batch_packs")),
        _ptr(s.get("batch_odoms")), _ptr(s.get("last_odom")),
        _ptr(s.get("last_corrected")), _ptr(s.get("offset_pose")),
        float(s.get("half_span", 0.0)), _ptr(s.get("center_off")),
        _ptr(s.get("prior")), _ptr(s.get("scan_pack")),
        _ptr(s.get("scan_odom")), _ptr(s.get("scan_finite")),
        pts.data_ptr(), valid.data_ptr(), _ptr(flags), mc._stream(),
    ), "ring_points")
    mc._count("ring_points", G)
    return pts, valid


def ring_points(packs, poses, slot_valid, viewpoint_xy, G: int = 0):
    """Chain mode: see ring_points_plain. `poses` may be a column slice
    (its rows strided, as a chain record's); `G` is the side of the
    raster the points feed (the launch counts' key). On a card `packs`
    must start on a 16-byte boundary."""
    dev = packs.device
    if packs.dim() != 3 or packs.shape[2] != 8:
        raise ValueError(f"packs: shape {tuple(packs.shape)}, expected "
                         "(C, B, 8)")
    C, B = packs.shape[0], packs.shape[1]
    mc._check(packs, "packs", _F32, (C, B, 8), dev)
    _rows(poses, "poses", _F32, 3, dev)
    if poses.shape[0] != C:
        raise ValueError(f"poses: {poses.shape[0]} rows for {C} packs")
    if slot_valid is not None:
        mc._check(slot_valid, "slot_valid", torch.bool, (C,), dev)
    mc._check(viewpoint_xy, "viewpoint_xy", _F32, (2,), dev)
    if not mc._on_cuda(dev):
        return ring_points_plain(packs, poses, slot_valid, viewpoint_xy)
    return _launch_ring_points(packs, poses, slot_valid, viewpoint_xy, G)


def ring_points_step_plain(state, offset_pose, half_span: float):
    """Step mode: the batch row `state["step"]` (a device index) with its
    prior propagated from the state's last odometry and correction, and
    the world points and FindValidPoints of the state's ring seen from
    the prior's sensor pose. Writes the state's center_off (5,), prior
    (3,), scan_pack (B, 8), scan_odom (3,) and scan_finite (B,); returns
    the ring's (K*B, 2) points and (K*B,) validity."""
    row = state["step"].view(1)
    pack = state["batch_packs"].index_select(0, row)[0]
    odom = state["batch_odoms"].index_select(0, row)[0]
    center_off, prior = _stream_prior(state, odom, offset_pose, half_span)
    pts, valid = ring_points_plain(
        state["ring_pack"], state["ring_pose"], state["ring_slot_valid"],
        center_off[:2],
    )
    state["center_off"].copy_(center_off)
    state["prior"].copy_(prior)
    state["scan_pack"].copy_(pack)
    state["scan_odom"].copy_(odom)
    state["scan_finite"].copy_(_unpack_scan(pack)[4])
    return pts, valid


STEP_INPUTS = ("step", "batch_packs", "batch_odoms", "last_odom",
               "last_corrected")
STEP_OUTPUTS = ("center_off", "prior", "scan_pack", "scan_odom",
                "scan_finite")


def ring_points_step(state, offset_pose, half_span: float, G: int = 0):
    """Step mode; see ring_points_step_plain. One launch: a block per ring
    slot (each forms the prior itself) and one that writes the scan's
    buffers. On a card the packs must start on 16-byte boundaries."""
    ring = state["ring_pack"]
    dev = ring.device
    K, B = ring.shape[0], ring.shape[1]
    n = state["batch_packs"].shape[0]
    for key, dtype, shape in (
            ("ring_pack", _F32, (K, B, 8)), ("ring_pose", _F32, (K, 3)),
            ("ring_slot_valid", torch.bool, (K,)),
            ("step", torch.int64, ()), ("batch_packs", _F32, (n, B, 8)),
            ("batch_odoms", _F32, (n, 3)), ("last_odom", _F32, (3,)),
            ("last_corrected", _F32, (3,)), ("center_off", _F32, (5,)),
            ("prior", _F32, (3,)), ("scan_pack", _F32, (B, 8)),
            ("scan_odom", _F32, (3,)), ("scan_finite", torch.bool, (B,))):
        mc._check(state[key], key, dtype, shape, dev)
    mc._check(offset_pose, "offset_pose", _F32, (3,), dev)
    if not mc._on_cuda(dev):
        return ring_points_step_plain(state, offset_pose, half_span)
    step = {k: state[k] for k in STEP_INPUTS + STEP_OUTPUTS}
    step.update(offset_pose=offset_pose, half_span=half_span)
    return _launch_ring_points(ring, state["ring_pose"],
                               state["ring_slot_valid"], None, G, step)


# -- K1's head form: the match's head folded into the window sums -----------
def score_head_plain(center_off, local_pts, x_off_c, y_off_c, scale,
                     coarse_angle_offset, coarse_angle_res, na_coarse: int):
    """The coarse pass's preamble of a match: the headings ang_c (na,)
    f32 around center_off's heading, their rotated beam tables d_c (na,
    B, 2) int32, and the lattice origin cand0 = (cand_x[0], cand_y[0])
    (2,) int32 that the window sums take."""
    center = center_off[:3]
    offset = center_off[3:5]
    dev = center_off.device
    ang_c = (
        center[2] - coarse_angle_offset
        + coarse_angle_res * torch.arange(na_coarse, dtype=_F32, device=dev)
    )
    d_c = _rotated_tables(ang_c, local_pts, scale)
    cand_x = rz.round_half_away(
        (center[0] + x_off_c - offset[0]) * scale).to(torch.int32)
    cand_y = rz.round_half_away(
        (center[1] + y_off_c - offset[1]) * scale).to(torch.int32)
    return ang_c, d_c, torch.stack([cand_x[0], cand_y[0]])


def score_windows_head_plain(grid_flat, G: int, center_off, local_pts,
                             finite, x_off_c, y_off_c, scale,
                             coarse_angle_offset, coarse_angle_res,
                             na_coarse: int):
    """A match's coarse window sums raw (na, ny, nx) int32 and headings
    ang_c (na,) f32: score_head_plain's headings, tables and origin, then
    match_cuda.score_windows_plain's sums of them."""
    ang_c, d_c, cand0 = score_head_plain(
        center_off, local_pts, x_off_c, y_off_c, scale, coarse_angle_offset,
        coarse_angle_res, na_coarse)
    raw = mc.score_windows_plain(grid_flat, G, d_c, cand0[0:1], cand0[1:2],
                                 y_off_c.shape[0], x_off_c.shape[0], finite)
    return raw, ang_c


def score_windows_head(grid_flat, G: int, center_off, local_pts, finite,
                       x_off_c, y_off_c, scale, coarse_angle_offset,
                       coarse_angle_res, na_coarse: int):
    """See score_windows_head_plain: one launch of the window-sum kernel's
    head form (csrc/score_windows.cu), which rotates each staged beam in
    the block and never writes the table, counted under score_windows
    and G. `local_pts` may be a column slice of a pack. The kernel's
    launcher zero-fills the sums on the stream; any geometry the card
    holds runs on it (its wide instantiation past 16-bit lattice sides,
    65,535 headings or int32 offsets)."""
    dev = grid_flat.device
    B = local_pts.shape[0]
    ny, nx = y_off_c.shape[0], x_off_c.shape[0]
    mc._check(grid_flat, "grid_flat", torch.int8, (G * G + 1,), dev)
    mc._check(center_off, "center_off", _F32, (5,), dev)
    stride = _rows(local_pts, "local_pts", _F32, 2, dev)
    mc._check(finite, "finite", torch.bool, (B,), dev)
    mc._check(x_off_c, "x_off_c", _F32, (nx,), dev)
    mc._check(y_off_c, "y_off_c", _F32, (ny,), dev)
    if not mc._on_cuda(dev):
        return score_windows_head_plain(
            grid_flat, G, center_off, local_pts, finite, x_off_c, y_off_c,
            scale, coarse_angle_offset, coarse_angle_res, na_coarse)
    raw = torch.empty((na_coarse, ny, nx), dtype=torch.int32, device=dev)
    ang = torch.empty(na_coarse, dtype=_F32, device=dev)
    lib = mc._lib("score_windows")
    mc._raise_if(lib.score_windows_head(
        grid_flat.data_ptr(), G, center_off.data_ptr(),
        local_pts.data_ptr(), stride, x_off_c.data_ptr(),
        y_off_c.data_ptr(), float(scale), float(coarse_angle_offset),
        float(coarse_angle_res), na_coarse, B, ny, nx, finite.data_ptr(),
        raw.data_ptr(), ang.data_ptr(), mc._stream(),
    ), "score_windows")
    mc._count("score_windows", G)
    return raw, ang


# -- K7: score tail -----------------------------------------------------------
def _fine_pass(grid_flat, G, offset, local_pts, finite, mean_c, x_off_f,
               y_off_f, scale, fine_angle_offset, fine_angle_res, penalize,
               pens, na_fine: int):
    """The fine pass centered on the coarse mean `mean_c`: its headings,
    rotated tables, 3 x 3 cells and window sums, the tie average and the
    angular covariance. Returns (best_f, mean_f, var_th, parts), parts
    the integer intermediates (the aux vector's)."""
    sink = G * G
    dev = grid_flat.device
    ang_f = (
        mean_c[2] - fine_angle_offset
        + fine_angle_res * torch.arange(na_fine, dtype=_F32, device=dev)
    )
    d_f = _rotated_tables(ang_f, local_pts, scale)
    cand_xf = rz.round_half_away(
        (mean_c[0] + x_off_f - offset[0]) * scale).to(torch.int32)
    cand_yf = rz.round_half_away(
        (mean_c[1] + y_off_f - offset[1]) * scale).to(torch.int32)
    raw_f = _gather_sums(grid_flat, G, sink, cand_xf, cand_yf, d_f, finite)
    resp_f = _penalized(raw_f, d_f.shape[1], x_off_f, y_off_f, ang_f,
                        mean_c[2], penalize, *pens)
    best_f, mean_f = _tie_average(
        resp_f, mean_c[0] + x_off_f, mean_c[1] + y_off_f, ang_f
    )
    var_th = _angular_cov(
        grid_flat, G, sink, offset, scale, d_f, finite,
        mean_f, best_f, mean_c[2], ang_f, fine_angle_res,
    )
    parts = dict(ang_f=ang_f, d_f=d_f, cand_x=cand_xf, cand_y=cand_yf,
                 raw=raw_f, resp=resp_f)
    return best_f, mean_f, var_th, parts


def fine_parts_plain(grid_flat, G, center_off, local_pts, finite, mean_c,
                     mean_f, x_off_f, y_off_f, scale, fine_angle_offset,
                     fine_angle_res, penalize, pens, na_fine: int) -> dict:
    """The fine pass's integer parts as the plain version forms them,
    centered on a given coarse mean and with the angular cell at a given
    fine mean (a kernel's, whose sums ran in another order): cells, window
    sums, tie count, clamped best, angular cell and sums."""
    offset = center_off[3:5]
    best_f, _, _, p = _fine_pass(
        grid_flat, G, offset, local_pts, finite, mean_c, x_off_f, y_off_f,
        scale, fine_angle_offset, fine_angle_res, penalize, pens, na_fine)
    resp = p["resp"]
    bx, by = _angular_cell(mean_f, offset, scale)
    return dict(
        cand_x=p["cand_x"], cand_y=p["cand_y"], raw=p["raw"],
        tie=(resp >= resp.max() - KT_TOLERANCE).sum(), best=best_f,
        cell=torch.stack([bx, by]),
        ang_sums=_angular_sums(grid_flat, G, G * G, bx, by, p["d_f"],
                               finite))


def score_tail_plain(raw, grid_flat, center_off, local_pts, finite, ang_c,
                     x_off_c, y_off_c, x_off_f, y_off_f, scale,
                     fine_angle_offset, fine_angle_res, coarse_angle_res,
                     penalize, dist_var_penalty, ang_var_penalty,
                     min_dist_pen, min_ang_pen, G: int, na_fine: int,
                     refine: bool, aux=None):
    """The rest of a match after the window sums `raw` (na_c, ny, nx)
    int32: the coarse responses with penalties, tie average and
    positional covariance, and under `refine` the fine pass and the
    angular covariance. Returns the packed (13,) f32 [best, mean (3),
    covariance (9)]; fills `aux` (aux_len(na_fine),) f32 if given."""
    center = center_off[:3]
    offset = center_off[3:5]
    pens = (dist_var_penalty, ang_var_penalty, min_dist_pen, min_ang_pen)
    resp_c = _penalized(raw, local_pts.shape[0], x_off_c, y_off_c, ang_c,
                        center[2], penalize, *pens)
    best_c, mean_c = _tie_average(
        resp_c, center[0] + x_off_c, center[1] + y_off_c, ang_c
    )
    probs = resp_c.max(dim=0).values
    cov = _positional_cov(
        probs, best_c, mean_c[0], mean_c[1], center, x_off_c, y_off_c,
        x_off_c[1] - x_off_c[0], coarse_angle_res,
    )
    if aux is not None:
        aux.zero_()
        aux[0] = (resp_c >= resp_c.max() - KT_TOLERANCE).sum()
        aux[1] = best_c
        aux[2:5] = mean_c

    if not refine:
        return torch.cat([best_c[None], mean_c, cov.reshape(-1)])

    best_f, mean_f, var_th, p = _fine_pass(
        grid_flat, G, offset, local_pts, finite, mean_c, x_off_f, y_off_f,
        scale, fine_angle_offset, fine_angle_res, penalize, pens, na_fine)
    cov = cov.clone()
    cov[2, 2] = var_th
    if aux is not None:
        fp = fine_parts_plain(
            grid_flat, G, center_off, local_pts, finite, mean_c, mean_f,
            x_off_f, y_off_f, scale, fine_angle_offset, fine_angle_res,
            penalize, pens, na_fine)
        fill_aux_fine(aux, fp, mean_f)
    return torch.cat([best_f[None], mean_f, cov.reshape(-1)])


def fill_aux_fine(aux, fp: dict, mean_f) -> None:
    """Write fine_parts_plain's parts and the fine mean into an aux
    vector's fine entries."""
    n = fp["ang_sums"].shape[0]
    aux[5] = fp["tie"]
    aux[6] = fp["best"]
    aux[7:10] = mean_f
    aux[10:13] = fp["cand_x"]
    aux[13:16] = fp["cand_y"]
    aux[16:18] = fp["cell"]
    aux[AUX_HEAD:AUX_HEAD + 9 * n] = fp["raw"].reshape(-1)
    aux[AUX_HEAD + 9 * n:AUX_HEAD + 10 * n] = fp["ang_sums"]


# score_tail's kernel: at most 16 CTAs a cluster (the non-portable size),
# 512 threads a CTA, in the resident and streamed modes kMaxFine fine
# headings, in the resident mode kMaxHeadings coarse headings; a CTA's
# shared memory on Hopper is 227 KB (232,448 bytes), of which its static
# part takes at most TAIL_STATIC_SMEM (chip_smoke checks the build's) and
# the dynamic part (score_tail_smem) the rest
TAIL_MAX_CLUSTER = 16
TAIL_MAX_THREADS = 512
TAIL_MAX_HEADINGS = 512
TAIL_MAX_FINE = 64
TAIL_SMEM_PER_CTA = 232448
TAIL_STATIC_SMEM = 16384
TAIL_ROOM = TAIL_SMEM_PER_CTA - TAIL_STATIC_SMEM
# the kernel's modes, the last entry of a launch geometry: the coarse
# responses kept in shared memory; formed again from the sums in each
# coarse pass (any lattice, any number of coarse headings); and that with
# the beams read from global memory and the fine and angular sums in a
# global workspace (any number of fine headings, any number of beams)
TAIL_RESIDENT, TAIL_STREAMED, TAIL_WIDE = 0, 1, 2
TAIL_MODES = ("resident", "streamed", "wide")


def score_tail_smem(na: int, ny: int, nx: int, B: int, ctas: int,
                    mode: int = TAIL_RESIDENT) -> int:
    """Dynamic shared bytes a CTA of score_tail's kernel takes in a
    cluster of `ctas`: in the resident mode the coarse responses of its
    ceil(ny * nx / ctas) cells, all na headings of each, and the cells'
    maxima (4 (na + 1) bytes a cell); in the resident and streamed modes
    the B beams' local x and y (8 bytes a beam); in the wide mode
    none."""
    if mode == TAIL_WIDE:
        return 0
    cells = 0 if mode == TAIL_STREAMED else -(-(ny * nx) // ctas)
    return 4 * (na + 1) * cells + 8 * B


def score_tail_launch(na: int, ny: int, nx: int, B: int, na_fine: int):
    """score_tail's launch geometry for na coarse headings on an ny x nx
    lattice, B beams and na_fine fine headings: (CTAs in the cluster,
    threads a CTA, dynamic shared bytes a CTA, mode). Always 16 CTAs of
    512 threads, the fastest of the cluster shapes timed on the H100
    (chip_smoke's other geometries; PERF.md) at both the bench (21 x 26 x
    26) and the loop (21 x 81 x 81) lattice: the coarse walk and the fine
    gathers spread over the SMs, while a phase's barriers cost about the
    same at 8 and 16 CTAs. The resident mode wherever a CTA's responses
    and beams fit its shared memory, na is at most kMaxHeadings and
    na_fine at most kMaxFine (every matcher the port builds at its
    defaults); else the streamed mode where the beams fit and na_fine is
    at most kMaxFine; else the wide mode, which takes any geometry.
    Raises ValueError only on arguments no match has: no heading, no
    beam, a lattice of fewer than 1 x 2 cells."""
    if na < 1 or na_fine < 1:
        raise ValueError(f"score_tail: {na} coarse and {na_fine} fine "
                         "headings")
    if ny < 1 or nx < 2 or B < 1:
        raise ValueError(f"score_tail: lattice {ny} x {nx}, {B} beams")
    if na_fine <= TAIL_MAX_FINE:
        smem = score_tail_smem(na, ny, nx, B, TAIL_MAX_CLUSTER)
        if na <= TAIL_MAX_HEADINGS and smem <= TAIL_ROOM:
            return TAIL_MAX_CLUSTER, TAIL_MAX_THREADS, smem, TAIL_RESIDENT
        smem = score_tail_smem(na, ny, nx, B, TAIL_MAX_CLUSTER,
                               TAIL_STREAMED)
        if smem <= TAIL_ROOM:
            return TAIL_MAX_CLUSTER, TAIL_MAX_THREADS, smem, TAIL_STREAMED
    return TAIL_MAX_CLUSTER, TAIL_MAX_THREADS, 0, TAIL_WIDE


def score_tail(raw, grid_flat, center_off, local_pts, finite, ang_c,
               x_off_c, y_off_c, x_off_f, y_off_f, scale, fine_angle_offset,
               fine_angle_res, coarse_angle_res, penalize, dist_var_penalty,
               ang_var_penalty, min_dist_pen, min_ang_pen, G: int,
               na_fine: int, refine: bool, aux=None):
    """See score_tail_plain. On a card one thread-block cluster per match,
    shaped by score_tail_launch; before a geometry's first launch,
    tail_clusters checks that the card can hold the cluster. The kernel
    takes a 3 x 3 fine lattice (x_off_f, y_off_f of 3), as the matchers
    build it."""
    dev = raw.device
    na, ny, nx = raw.shape
    B = local_pts.shape[0]
    mc._check(raw, "raw", torch.int32, (na, ny, nx), dev)
    mc._check(grid_flat, "grid_flat", torch.int8, (G * G + 1,), dev)
    mc._check(center_off, "center_off", _F32, (5,), dev)
    _rows(local_pts, "local_pts", _F32, 2, dev)
    mc._check(finite, "finite", torch.bool, (B,), dev)
    mc._check(ang_c, "ang_c", _F32, (na,), dev)
    mc._check(x_off_c, "x_off_c", _F32, (nx,), dev)
    mc._check(y_off_c, "y_off_c", _F32, (ny,), dev)
    mc._check(x_off_f, "x_off_f", _F32, (3,), dev)
    mc._check(y_off_f, "y_off_f", _F32, (3,), dev)
    if aux is not None:
        mc._check(aux, "aux", _F32, (aux_len(na_fine),), dev)
    if nx < 2:
        raise ValueError("the coarse lattice needs two columns (its step)")
    args = (raw, grid_flat, center_off, local_pts, finite, ang_c, x_off_c,
            y_off_c, x_off_f, y_off_f, scale, fine_angle_offset,
            fine_angle_res, coarse_angle_res, penalize, dist_var_penalty,
            ang_var_penalty, min_dist_pen, min_ang_pen, G, na_fine, refine)
    if not mc._on_cuda(dev):
        return score_tail_plain(*args, aux=aux)
    geometry = score_tail_launch(na, ny, nx, B, na_fine)
    out = _launch_score_tail(args, aux, geometry)
    mc._count("score_tail", G)
    return out


# active clusters by launch geometry, as tail_clusters found them
_TAIL_CLUSTERS = {}


def tail_clusters(geometry, device, lib=None) -> int:
    """The clusters of a launch geometry (CTAs, threads, dynamic shared
    bytes, mode) that the card can hold at once, asked of the CUDA
    runtime (cudaOccupancyMaxActiveClusters) once per geometry. Raises
    RuntimeError, naming the card and the cluster's shape, where the
    answer is 0 or the question fails: a card or partition that cannot
    schedule the cluster, where a launch would fail. There is no other
    shape to fall back to."""
    n = _TAIL_CLUSTERS.get(geometry)
    if n is None:
        lib = lib or mc._lib("score_tail")
        count = (ctypes.c_int * 1)()
        err = lib.score_tail_clusters(*geometry, count)
        n = count[0] if err == 0 else 0
        if n == 0:
            ctas, threads, smem, mode = geometry
            raise RuntimeError(
                f"score_tail: {torch.cuda.get_device_name(device)} holds no "
                f"cluster of {ctas} CTAs x {threads} threads with {smem} "
                f"dynamic shared bytes a CTA ({TAIL_MODES[mode]} mode; "
                f"cudaOccupancyMaxActiveClusters: {n}, cudaError {err})")
        _TAIL_CLUSTERS[geometry] = n
    return n


def _launch_score_tail(args, aux, geometry, lib=None):
    """One launch of score_tail's kernel (from `lib`, else the package's
    build) on score_tail's checked arguments at a launch geometry
    (cluster, threads, dynamic shared bytes, mode); uncounted. The wide
    mode's workspace (10 na_fine int32) is allocated here."""
    (raw, grid_flat, center_off, local_pts, finite, ang_c, x_off_c, y_off_c,
     x_off_f, y_off_f, scale, fine_angle_offset, fine_angle_res,
     coarse_angle_res, penalize, dist_var_penalty, ang_var_penalty,
     min_dist_pen, min_ang_pen, G, na_fine, refine) = args
    na, ny, nx = raw.shape
    lib = lib or mc._lib("score_tail")
    tail_clusters(geometry, raw.device, lib)
    out = torch.empty(13, dtype=_F32, device=raw.device)
    ws = (torch.empty(10 * na_fine, dtype=torch.int32, device=raw.device)
          if geometry[3] == TAIL_WIDE else None)
    mc._raise_if(lib.score_tail(
        raw.data_ptr(), na, ny, nx, grid_flat.data_ptr(), G,
        center_off.data_ptr(), local_pts.data_ptr(), local_pts.stride(0),
        local_pts.shape[0], finite.data_ptr(), ang_c.data_ptr(),
        x_off_c.data_ptr(), y_off_c.data_ptr(), x_off_f.data_ptr(),
        y_off_f.data_ptr(), float(scale), float(fine_angle_offset),
        float(fine_angle_res), float(coarse_angle_res), int(bool(penalize)),
        float(dist_var_penalty), float(ang_var_penalty),
        float(min_dist_pen), float(min_ang_pen), na_fine, int(bool(refine)),
        *geometry, out.data_ptr(), _ptr(aux), _ptr(ws), mc._stream(),
    ), "score_tail")
    return out


# -- K8: stream update --------------------------------------------------------
UPDATE_STATE = ("ring_pack", "ring_pose", "ring_slot_valid", "head",
                "count", "last_odom", "last_corrected", "results", "ridx",
                "step")


def stream_update_plain(packed, center_off, pack, odom, offset_pose, eye9,
                        state, run_buffer_size: int, max_sq: float,
                        G: int = 0):
    """The step's state update after its match `packed` (13,), in place on
    `state`: the first scan's selection, the corrected pose, the push of
    `pack` (B, 8) and the pose at ring slot (head + count) % K, the
    eviction, head and count, the last odometry and correction, the
    result row at the device write index `ridx`, then ridx and the batch
    row `step` advanced. Every tensor keeps its storage."""
    is_first = state["count"] == 0
    center = center_off[:3]
    mean = torch.where(is_first, center, packed[1:4])
    response = torch.where(is_first, 0.0, packed[0])
    cov = torch.where(is_first, eye9, packed[4:13])
    corrected = _corrected_at(mean, offset_pose)
    out13 = torch.cat([response[None], mean, cov])

    # push into the ring at (head + count) % K, a device index
    K = state["ring_pack"].shape[0]
    idx = ((state["head"] + state["count"]) % K).view(1)
    state["ring_pack"].index_copy_(0, idx, pack[None])
    state["ring_pose"].index_copy_(0, idx, mean[None])
    state["ring_slot_valid"].index_fill_(0, idx, True)
    head, count = _evict(
        state["ring_pose"], state["head"], state["count"] + 1,
        run_buffer_size, max_sq,
    )
    state["head"].copy_(head)
    state["count"].copy_(count)
    state["last_odom"].copy_(odom)
    state["last_corrected"].copy_(corrected)

    ridx = state["ridx"]
    state["results"].index_copy_(0, ridx.view(1), out13[None])
    ridx.copy_((ridx + 1) % state["results"].shape[0])
    state["step"].add_(1)


def stream_update(packed, center_off, pack, odom, offset_pose, eye9, state,
                  run_buffer_size: int, max_sq: float, G: int = 0):
    """See stream_update_plain. One block: the pose update, the push, the
    eviction's leading run over the K slots (any K, in rounds of the
    block's warps) and the state's scalars.
    On a card `pack` and the ring's packs must start on 16-byte
    boundaries."""
    ring = state["ring_pack"]
    dev = ring.device
    K, B = ring.shape[0], ring.shape[1]
    R = state["results"].shape[0]
    mc._check(packed, "packed", _F32, (13,), dev)
    mc._check(center_off, "center_off", _F32, (5,), dev)
    mc._check(pack, "pack", _F32, (B, 8), dev)
    mc._check(odom, "odom", _F32, (3,), dev)
    mc._check(offset_pose, "offset_pose", _F32, (3,), dev)
    for key, dtype, shape in (
            ("ring_pack", _F32, (K, B, 8)), ("ring_pose", _F32, (K, 3)),
            ("ring_slot_valid", torch.bool, (K,)),
            ("head", torch.int64, ()), ("count", torch.int64, ()),
            ("last_odom", _F32, (3,)), ("last_corrected", _F32, (3,)),
            ("results", _F32, (R, 13)), ("ridx", torch.int64, ()),
            ("step", torch.int64, ())):
        mc._check(state[key], key, dtype, shape, dev)
    if not mc._on_cuda(dev):
        return stream_update_plain(packed, center_off, pack, odom,
                                   offset_pose, eye9, state, run_buffer_size,
                                   max_sq, G)
    _launch_stream_update(packed, center_off, pack, odom, offset_pose,
                          state, run_buffer_size, max_sq)
    mc._count("stream_update", G)


def _launch_stream_update(packed, center_off, pack, odom, offset_pose, state,
                          run_buffer_size: int, max_sq: float):
    """One launch of stream_update's kernel on stream_update's checked
    arguments; uncounted."""
    K, B = state["ring_pack"].shape[0], state["ring_pack"].shape[1]
    _aligned16(pack, "pack")
    _aligned16(state["ring_pack"], "ring_pack")
    lib = mc._lib("stream_update")
    mc._raise_if(lib.stream_update(
        packed.data_ptr(), center_off.data_ptr(), pack.data_ptr(),
        odom.data_ptr(), offset_pose.data_ptr(),
        *(state[k].data_ptr() for k in UPDATE_STATE),
        K, B, state["results"].shape[0], int(run_buffer_size),
        float(max_sq), mc._stream(),
    ), "stream_update")
