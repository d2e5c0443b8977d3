"""Batched correlative scan matcher.

PyTorch counterpart of slam_toolbox_tpu/kernels/match.py (the
karto::ScanMatcher re-design, Mapper.h:1322-1544, Mapper.cpp:477-1208).
The full (n_angles, ny, nx) candidate tensor is scored in one pass: a
(n_angles, B, 2) rotated-offset table turns into gathers from an int8
correlation raster, summed over beams; odometry penalties, tie-averaged
best pose and the response-surface covariances (Mapper.cpp:641-694,
802-829, 874-1025) stay on the device.

Layout: the raster is the plain row-major (G*G+1,) int8 grid whose last
cell is a zero sink for invalid gathers. The raster comes from the
scatter and smear kernels and the coarse lattice is scored by the window
kernel (kernels/match_cuda.py); in the fused score (_score_impl) the
window kernel's head form forms the coarse headings and tables itself
(step_cuda.score_windows_head), and one more kernel (step_cuda.
score_tail) the penalties, tie averages, covariances and the fine 3x3
pass with its gathers on the same flat grid. The exact two-call path
(_match_pass_impl) keeps those steps as PyTorch ops.

On a card a match runs as one program (match_cuda.Program): the raster
and the fused score captured once as a CUDA graph per (base points P,
beams B, penalize, refine) on static input buffers, as the JAX package
jits `_raster_jit` and `_score_jit` once per shape, and replayed per
match; on the CPU the same function runs eagerly on the same buffers.
The exact two-call path (`exact=True`) is programs too, as the JAX
package jits `_match_pass`: its raster per base-point bucket and each
pass per (headings, beams, lattice, penalize, fine), with the f64 index
tables built on the host and uploaded into the static buffers. So no
K1-K3 launch on a card comes from outside a graph replay; the
`*_eager` methods are the fresh-tensor references the programs are held
to.

Numerics follow the reference: raster values are round(100 * gaussian)
(Mapper.h:1258-1260); response = sum / (B * 100) (Mapper.cpp:1204);
rounding is half away from zero (Math.h:87-90); ties within KT_TOLERANCE
of the best response are averaged (Mapper.cpp:802-829), headings by
circular mean.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass

import numpy as np
import torch

from slam_toolbox_tpu_torch.core.geometry import KT_TOLERANCE
from slam_toolbox_tpu_torch.device import resolve_device, upload_into
from slam_toolbox_tpu_torch.kernels import match_cuda as mc
from slam_toolbox_tpu_torch.kernels import rasterize as rz
from slam_toolbox_tpu_torch.kernels import step_cuda as sc
from slam_toolbox_tpu_torch.kernels.step_cuda import (
    _angular_cov, _penalized, _positional_cov, _score_tensor, _tie_average,
)

_DEG = np.pi / 180.0
_F32 = torch.float32


def _f32(x) -> float:
    """A Python float that f32 represents exactly (scalar operands of f32
    tensor arithmetic, so every backend computes in the same f32 values
    as the JAX package's np.float32 arguments)."""
    return float(np.float32(x))


@dataclass
class MatchResult:
    response: float
    sensor_pose: np.ndarray  # (3,) best sensor pose
    covariance: np.ndarray   # (3, 3)


def _search_offsets(extent: float, step: float) -> np.ndarray:
    """Candidate offsets -extent..extent at the given step
    (CorrelateScan, Mapper.cpp:736-752)."""
    n = int(np.floor(extent * 2.0 / step + 0.5)) + 1
    return -extent + step * np.arange(n, dtype=np.float64)


class Matcher:
    """One correlative matcher instance (sequential or loop).

    Mirrors ScanMatcher::Create (Mapper.cpp:477-522): the raster side length
    is the search extent plus a 2x range-threshold margin so base-scan points
    cannot fall off the grid.
    """

    def __init__(
        self,
        search_size: float,
        resolution: float,
        smear_deviation: float,
        range_threshold: float,
        coarse_angle_offset: float,
        coarse_angle_resolution: float,
        fine_angle_offset: float,
        dist_var_penalty: float,
        ang_var_penalty: float,
        min_dist_penalty: float,
        min_ang_penalty: float,
        use_response_expansion: bool = False,
        device=None,
    ):
        assert resolution > 0 and search_size > 0 and range_threshold > 0
        self.device = resolve_device(device)
        self.resolution = float(resolution)
        self.scale = 1.0 / self.resolution
        self.search_size = float(search_size)
        self.smear_deviation = float(smear_deviation)
        self.roi = int(np.floor(search_size / resolution + 0.5)) + 1
        margin = int(np.ceil(range_threshold / resolution))
        self.G = self.roi + 2 * margin
        self.half_kernel = rz.half_kernel_size(smear_deviation, resolution)
        self.sigma_cells = smear_deviation / resolution
        self.coarse_angle_offset = float(coarse_angle_offset)
        self.coarse_angle_resolution = float(coarse_angle_resolution)
        self.fine_angle_offset = float(fine_angle_offset)
        self.penalty_params = tuple(_f32(v) for v in (
            dist_var_penalty, ang_var_penalty, min_dist_penalty,
            min_ang_penalty,
        ))
        self.use_response_expansion = bool(use_response_expansion)
        # search offsets for the coarse pass: extent = half the (roi-1)
        # cells, stride = 2 cells (MatchScan, Mapper.cpp:577-585)
        self.coarse_extent = 0.5 * (self.roi - 1) * self.resolution
        self.coarse_step = 2.0 * self.resolution
        self._xy_coarse = _search_offsets(self.coarse_extent,
                                          self.coarse_step)
        self._xy_fine = _search_offsets(self.coarse_step * 0.5,
                                        self.resolution)
        self._na_coarse = int(np.floor(
            self.coarse_angle_offset * 2.0 / self.coarse_angle_resolution
            + 0.5)) + 1
        # fine pass angle args follow the reference's (swapped) call:
        # offset = 0.5*coarse resolution, step = FineSearchAngleOffset
        # (MatchScan, Mapper.cpp:625-628)
        self._fine_angle_offset = 0.5 * self.coarse_angle_resolution
        self._fine_angle_res = self.fine_angle_offset
        self._na_fine = int(np.floor(
            self._fine_angle_offset * 2.0 / self._fine_angle_res + 0.5)) + 1
        dev = self.device
        taps = rz.smear_weights(self.sigma_cells, self.half_kernel)
        rz.check_smear_taps(taps)   # the smear kernel relies on their shape
        self._w = torch.from_numpy(taps).to(dev)
        self._score_args = dict(
            x_off_c=torch.tensor(self._xy_coarse, dtype=_F32, device=dev),
            y_off_c=torch.tensor(self._xy_coarse, dtype=_F32, device=dev),
            x_off_f=torch.tensor(self._xy_fine, dtype=_F32, device=dev),
            y_off_f=torch.tensor(self._xy_fine, dtype=_F32, device=dev),
            scale=_f32(self.scale),
            coarse_angle_offset=_f32(self.coarse_angle_offset),
            coarse_angle_res=_f32(self.coarse_angle_resolution),
            fine_angle_offset=_f32(self._fine_angle_offset),
            fine_angle_res=_f32(self._fine_angle_res),
            dist_var_penalty=self.penalty_params[0],
            ang_var_penalty=self.penalty_params[1],
            min_dist_pen=self.penalty_params[2],
            min_ang_pen=self.penalty_params[3],
            grid_size=self.G,
            na_coarse=self._na_coarse, na_fine=self._na_fine,
        )
        # key -> match_cuda.Program: this matcher's matches, and (on the
        # sequential matcher) the fused loop verify's and near-chain
        # matches' programs of kernels/loop_verify.py
        self._programs = {}
        # program kind (the key's first item) -> captures made, new keys
        # and the same key on moved pool storage alike
        self.captures = collections.Counter()

    def _tensor(self, a, dtype=None):
        return torch.as_tensor(a, dtype=dtype).to(self.device)

    def _raster(self, pts, valid, offset):
        """Scatter to packed occupancy words + smear + int8 quantize:
        (G*G+1,) raster on device."""
        words = mc.scatter_occupancy(pts, valid, offset, _f32(self.scale),
                                     self.G)
        return mc.smear_quantize(words, self._w, self.G, self.half_kernel)

    # -- raster construction ------------------------------------------------
    def _grid_inputs(self, base_scans, viewpoint_pose):
        off = np.asarray(
            viewpoint_pose[:2] - 0.5 * (self.G - 1) * self.resolution,
            dtype=np.float64,
        )
        vp = np.asarray(viewpoint_pose[:2], dtype=np.float64)
        pts_p, valid_p = self._base_points(base_scans, vp)
        return off, pts_p, valid_p

    def build_grid(self, base_scans, viewpoint_pose: np.ndarray):
        """Rasterize base scans around the query scan pose; returns
        (grid_flat int8 (G*G+1,), offset (2,)) — AddScans (Mapper.cpp:1032).
        One replay of the raster program of the base points' bucket P (K2
        then K3 on static buffers); the grid is a copy of its output."""
        off, pts_p, valid_p = self._grid_inputs(base_scans, viewpoint_pose)
        P = len(pts_p)

        def build():
            return self._raster, dict(
                pts=torch.zeros((P, 2), dtype=_F32, device=self.device),
                valid=torch.zeros(P, dtype=torch.bool, device=self.device),
                offset=torch.zeros(2, dtype=_F32, device=self.device))

        prog = self.program(("raster", P), build)
        with prog.lock:
            inp = prog.inputs
            upload_into(inp["pts"], pts_p)
            upload_into(inp["valid"], valid_p)
            upload_into(inp["offset"], off.astype(np.float32))
            return prog.run(), off

    def build_grid_eager(self, base_scans, viewpoint_pose: np.ndarray):
        """build_grid's raster on fresh tensors, launched eagerly: the
        reference its program is held to."""
        off, pts_p, valid_p = self._grid_inputs(base_scans, viewpoint_pose)
        grid = self._raster(
            self._tensor(pts_p), self._tensor(valid_p),
            self._tensor(off.astype(np.float32)),
        )
        return grid, off

    def _base_points(self, base_scans, viewpoint_xy):
        """Concatenated (padded) base-scan world points + validity mask,
        padded to a power of two (at least 1024) as the JAX package pads
        off-TPU; NaN points sit at -1e9."""
        pts_list, valid_list = [], []
        for sc in base_scans:
            if sc is None:
                continue
            pts = sc.points_world(filtered=False)
            struct = _fvp_structure(sc)
            valid = rz.find_valid_mask(pts, struct, viewpoint_xy)
            pts_list.append(pts)
            valid_list.append(valid)
        if not pts_list:
            pts = np.zeros((0, 2))
            valid = np.zeros((0,), bool)
        else:
            pts = np.concatenate(pts_list, axis=0)
            valid = np.concatenate(valid_list, axis=0)
        P = max(1024, 1 << int(np.ceil(np.log2(max(len(pts), 1)))))
        pts_p = np.zeros((P, 2), np.float32)
        pts_p[: len(pts)] = np.nan_to_num(pts, nan=-1e9)
        valid_p = np.zeros((P,), bool)
        valid_p[: len(valid)] = valid
        return pts_p, valid_p

    def program(self, key, build, storage=None):
        """The program cached under `key`, made by `build()` -> (fn,
        static inputs) at first use and again when it was made on other
        `storage` (a pool that grew). The lookup and the capture are one
        step under match_cuda.capture_lock."""
        with mc.capture_lock:
            prog = self._programs.get(key)
            if prog is None or prog.storage != storage:
                self.captures[key[0]] += 1
                fn, inputs = build()
                prog = self._programs[key] = mc.Program(fn, inputs,
                                                        storage=storage)
        return prog

    def _match(self, pts, valid, center_off, local, finite, penalize,
               refine):
        """Raster + fused score of one base set: the packed (13,) f32
        result."""
        grid = self._raster(pts, valid, center_off[3:5])
        return _score_impl(
            grid, center_off, local, finite, penalize=penalize,
            refine=refine, **self._score_args,
        )

    def _match_program(self, P: int, B: int, penalize: bool, refine: bool):
        def build():
            z = dict(dtype=_F32, device=self.device)
            inputs = dict(
                pts=torch.zeros((P, 2), **z),
                valid=torch.zeros(P, dtype=torch.bool, device=self.device),
                center_off=torch.zeros(5, **z),
                local=torch.zeros((B, 2), **z),
                finite=torch.zeros(B, dtype=torch.bool, device=self.device),
            )
            return (lambda **kw: self._match(penalize=penalize,
                                             refine=refine, **kw)), inputs

        return self.program(("match", P, B, penalize, refine), build)

    def _dispatch(self, scan, base_scans, center, penalize, refine):
        """Raster + fused score of one base set as a replay of its
        program, the inputs written into the program's static buffers
        (pinned host copies that do not wait, the query's cached device
        points); returns a copy of the packed (13,) f32 result, on the
        device."""
        off = center[:2] - 0.5 * (self.G - 1) * self.resolution
        pts_p, valid_p = self._base_points(base_scans, center[:2])
        local_dev, finite_dev = _scan_device_cache(scan, self.device)
        prog = self._match_program(len(pts_p), len(finite_dev), penalize,
                                   refine)
        with prog.lock:
            inp = prog.inputs
            upload_into(inp["pts"], pts_p)
            upload_into(inp["valid"], valid_p)
            upload_into(inp["center_off"],
                        np.concatenate([center, off]).astype(np.float32))
            inp["local"].copy_(local_dev)
            inp["finite"].copy_(finite_dev)
            return prog.run()

    def _dispatch_eager(self, scan, base_scans, center, penalize, refine):
        """_dispatch's match on fresh tensors, launched eagerly: the
        reference its program is held to."""
        off = center[:2] - 0.5 * (self.G - 1) * self.resolution
        pts_p, valid_p = self._base_points(base_scans, center[:2])
        local_dev, finite_dev = _scan_device_cache(scan, self.device)
        center_off = self._tensor(
            np.concatenate([center, off]).astype(np.float32))
        return self._match(self._tensor(pts_p), self._tensor(valid_p),
                           center_off, local_dev, finite_dev, penalize,
                           refine)

    # -- full match (MatchScan, Mapper.cpp:534-639) -------------------------
    def match_scan(
        self, scan, base_scans, penalize: bool = True, refine: bool = True,
        exact: bool = False,
    ) -> MatchResult:
        """Fused single-call match by default (_dispatch: a replay of the
        match's program); `exact=True` uses the two-call path with f64
        host index tables (bit-matching the NumPy oracle) and is also the
        fallback that implements response expansion. The exact path is
        programs too, as the JAX package jits `_match_pass`: its raster
        one replay (build_grid), each pass one replay keyed by its shape
        (_run_pass), the tables uploaded into their static buffers; the
        host reads each pass's result, since the expansion and the fine
        pass's centre depend on it."""
        if not exact:
            center = np.asarray(scan.sensor_pose, dtype=np.float64)
            packed = self._dispatch(scan, base_scans, center, penalize,
                                    refine)
            res = self.results_from_packed(packed.cpu().numpy())[0]
            if res.response <= KT_TOLERANCE and self.use_response_expansion:
                return self.match_scan(
                    scan, base_scans, penalize=penalize, refine=refine,
                    exact=True,
                )
            return res

        center = np.asarray(scan.sensor_pose, dtype=np.float64)
        grid_flat, off = self.build_grid(base_scans, center)

        local_pts = np.ascontiguousarray(scan.local_points, dtype=np.float32)
        finite = np.isfinite(scan.ranges)
        xy_off = _search_offsets(self.coarse_extent, self.coarse_step)

        best, mean, cov = self._run_pass(
            grid_flat, off, center, xy_off, xy_off,
            self.coarse_angle_offset, self.coarse_angle_resolution,
            local_pts, finite, self.coarse_step,
            penalize=penalize, fine=False,
        )

        if self.use_response_expansion and abs(best) <= KT_TOLERANCE:
            ang_off = self.coarse_angle_offset
            for _ in range(3):  # Mapper.cpp:594-619
                ang_off += 20.0 * _DEG
                best, mean, cov = self._run_pass(
                    grid_flat, off, center, xy_off, xy_off,
                    ang_off, self.coarse_angle_resolution,
                    local_pts, finite, self.coarse_step,
                    penalize=penalize, fine=False,
                )
                if abs(best) > KT_TOLERANCE:
                    break

        if refine:
            fine_xy = _search_offsets(
                self.coarse_step * 0.5, self.resolution
            )
            best, mean, var_th = self._run_pass(
                grid_flat, off, np.asarray(mean, np.float64),
                fine_xy, fine_xy,
                0.5 * self.coarse_angle_resolution, self.fine_angle_offset,
                local_pts, finite, self.resolution,
                penalize=penalize, fine=True,
            )
            cov = np.array(cov)
            cov[2, 2] = float(var_th)

        return MatchResult(
            response=float(best),
            sensor_pose=np.asarray(mean, dtype=np.float64),
            covariance=np.asarray(cov, dtype=np.float64),
        )

    def dispatch_scans_batch(
        self, scan, base_sets, penalize: bool = True, refine: bool = True,
    ):
        """Launch matches of one scan against several base sets without
        waiting: returns the list of packed device results. Convert with
        collect_batch (which pays the one sync/fetch)."""
        center = np.asarray(scan.sensor_pose, dtype=np.float64)
        return [
            self._dispatch(scan, base, center, penalize, refine)
            for base in base_sets
        ]

    @staticmethod
    def results_from_packed(rows) -> list:
        """Convert host (M, 13) packed rows to MatchResults."""
        out = []
        for packed in np.asarray(rows, np.float64).reshape(-1, 13):
            mean = packed[1:4].copy()
            mean[2] = _normalize(mean[2])
            out.append(MatchResult(
                response=float(packed[0]),
                sensor_pose=mean,
                covariance=packed[4:13].reshape(3, 3),
            ))
        return out

    @staticmethod
    def collect_batch(packs):
        """Wait for dispatched packs and convert to MatchResults (one
        stacked device-to-host copy for the whole batch)."""
        if not packs:
            return []
        return Matcher.results_from_packed(torch.stack(packs).cpu().numpy())

    def match_scans_batch(
        self, scan, base_sets, penalize: bool = True, refine: bool = True,
    ):
        """Match one scan against several base sets with all device work
        launched back-to-back and a single completion wait."""
        return self.collect_batch(self.dispatch_scans_batch(
            scan, base_sets, penalize=penalize, refine=refine,
        ))

    def _pass_inputs(self, off, center, x_off, y_off, angle_offset,
                     angle_resolution, local_pts, finite, fine: bool):
        """The host-built inputs of one exact pass (f64 index tables, as
        the JAX package builds them with numpy), as arrays."""
        na = int(np.floor(angle_offset * 2.0 / angle_resolution + 0.5)) + 1
        angles = (
            center[2] - angle_offset
            + angle_resolution * np.arange(na, dtype=np.float64)
        )
        d, cand_x, cand_y = build_index_tables(
            angles, local_pts, center, off, self.scale, x_off, y_off
        )
        if not fine and not (np.all(np.diff(cand_x) == 2)
                             and np.all(np.diff(cand_y) == 2)):
            raise ValueError("coarse candidates are not a stride-2 lattice")
        f32 = np.float32
        return dict(
            off=off.astype(f32), center=np.asarray(center, f32),
            x_off=np.asarray(x_off, f32), y_off=np.asarray(y_off, f32),
            angles=np.asarray(angles, f32), d=d, cand_x=cand_x,
            cand_y=cand_y, finite=np.asarray(finite, bool))

    def _pass_fn(self, step_xy, angle_resolution, penalize: bool,
                 fine: bool):
        """One exact pass as a function of its tensors: the packed
        [best, mean (3), covariance (9) or var_th] f32 result."""
        def fn(grid, off, center, x_off, y_off, angles, d, cand_x, cand_y,
               finite):
            best, mean, third = _match_pass_impl(
                grid, self.G, off, _f32(self.scale), center, x_off, y_off,
                angles, d, cand_x, cand_y, finite, _f32(step_xy),
                _f32(angle_resolution), penalize, *self.penalty_params,
                fine=fine,
            )
            return torch.cat([best[None], mean, third.reshape(-1)])

        return fn

    @staticmethod
    def _pass_result(packed, fine: bool):
        packed = np.asarray(packed, np.float64)
        mean = packed[1:4].copy()
        mean[2] = _normalize(mean[2])
        if fine:
            return float(packed[0]), mean, float(packed[4])
        return float(packed[0]), mean, packed[4:13].reshape(3, 3)

    def _run_pass(
        self, grid_flat, off, center, x_off, y_off,
        angle_offset, angle_resolution, local_pts, finite, step_xy,
        penalize: bool, fine: bool,
    ):
        """One exact pass as a replay of its program, keyed by (na, B, nx,
        ny, penalize, fine) and the pass's steps: the tables and the grid
        written into its static buffers, one read of the packed result."""
        arrays = self._pass_inputs(off, center, x_off, y_off, angle_offset,
                                   angle_resolution, local_pts, finite, fine)
        na, B = arrays["d"].shape[:2]
        key = ("pass", na, B, len(x_off), len(y_off), penalize, fine,
               step_xy, angle_resolution)

        def build():
            inputs = {k: torch.zeros(v.shape, device=self.device,
                                     dtype=torch.from_numpy(v).dtype)
                      for k, v in arrays.items()}
            inputs["grid"] = torch.zeros_like(grid_flat)
            return self._pass_fn(step_xy, angle_resolution, penalize,
                                 fine), inputs

        prog = self.program(key, build)
        with prog.lock:
            for k, v in arrays.items():
                upload_into(prog.inputs[k], v)
            prog.inputs["grid"].copy_(grid_flat)
            packed = prog.run()
        return self._pass_result(packed.cpu().numpy(), fine)

    def _run_pass_eager(
        self, grid_flat, off, center, x_off, y_off,
        angle_offset, angle_resolution, local_pts, finite, step_xy,
        penalize: bool, fine: bool,
    ):
        """_run_pass's pass on fresh tensors, launched eagerly: the
        reference its program is held to."""
        arrays = self._pass_inputs(off, center, x_off, y_off, angle_offset,
                                   angle_resolution, local_pts, finite, fine)
        fn = self._pass_fn(step_xy, angle_resolution, penalize, fine)
        packed = fn(grid_flat, **{k: self._tensor(v)
                                  for k, v in arrays.items()})
        return self._pass_result(packed.cpu().numpy(), fine)


def _score_coarse(
    grid_flat, G, cand_x, cand_y, d, finite,
    x_offsets, y_offsets, angles, center_h,
    penalize, dist_var_penalty, ang_var_penalty, min_dist_pen, min_ang_pen,
):
    """Response tensor of the coarse stride-2 lattice through the window
    kernel (cand_x = cand_x[0] + 2j, cand_y = cand_y[0] + 2i)."""
    raw = mc.score_windows(
        grid_flat, G, d, cand_x[:1], cand_y[:1], cand_y.shape[0],
        cand_x.shape[0], finite,
    )
    return _penalized(
        raw, d.shape[1], x_offsets, y_offsets, angles, center_h, penalize,
        dist_var_penalty, ang_var_penalty, min_dist_pen, min_ang_pen,
    )


def _match_pass_impl(
    grid_flat,     # (G*G + 1,) int8; last element 0 = OOB/invalid sink
    G,             # grid side
    offset,        # (2,) f32 world coords of cell (0,0)
    scale,         # f32 1/resolution
    center,        # (3,) f32 search-center sensor pose
    x_offsets,     # (nx,) f32
    y_offsets,     # (ny,) f32
    angles,        # (na,) f32 absolute candidate headings
    d,             # (na,B,2) int32 rotated beam offsets in cells, f64 on host
    cand_x,        # (nx,) int32 candidate cells
    cand_y,        # (ny,) int32
    finite,        # (B,) bool
    step_xy,       # f32 search-space resolution of this pass
    angle_step,    # f32 angular resolution of this pass
    penalize,      # bool
    dist_var_penalty, ang_var_penalty, min_dist_pen, min_ang_pen,
    fine: bool,
):
    """One pass of the exact (two-call) path on host-built tables: the
    coarse lattice through the window kernel, the fine pass by gathers."""
    sink = grid_flat.shape[0] - 1
    args = (
        x_offsets, y_offsets, angles, center[2],
        penalize, dist_var_penalty, ang_var_penalty,
        min_dist_pen, min_ang_pen,
    )
    if fine:
        resp_p = _score_tensor(grid_flat, G, sink, cand_x, cand_y, d,
                               finite, *args)
    else:
        resp_p = _score_coarse(grid_flat, G, cand_x, cand_y, d, finite,
                               *args)
    best, mean = _tie_average(
        resp_p, center[0] + x_offsets, center[1] + y_offsets, angles
    )
    if not fine:
        probs = resp_p.max(dim=0).values
        cov = _positional_cov(
            probs, best, mean[0], mean[1], center, x_offsets, y_offsets,
            step_xy, angle_step,
        )
        return best, mean, cov
    var_th = _angular_cov(
        grid_flat, G, sink, offset, scale, d, finite,
        mean, best, center[2], angles, angle_step,
    )
    return best, mean, var_th


def _score_impl(
    grid_flat,    # (G*G+1,) int8 raster
    center_off,   # (5,) [center_x, center_y, center_h, offset_x, offset_y]
    local_pts,    # (B,2)
    finite,       # (B,)
    x_off_c, y_off_c,          # coarse candidate offsets (constants)
    x_off_f, y_off_f,          # fine candidate offsets (constants)
    scale,
    coarse_angle_offset, coarse_angle_res,
    fine_angle_offset, fine_angle_res,
    penalize,
    dist_var_penalty, ang_var_penalty, min_dist_pen, min_ang_pen,
    grid_size: int, na_coarse: int, na_fine: int,
    refine: bool,
):
    """Coarse pass + (optional) fine pass + covariances on a prebuilt
    raster; returns the packed 13-float result, on the device: the
    coarse headings and window sums, their tables and lattice origin
    formed in the window kernel (step_cuda.score_windows_head), and the
    rest (step_cuda.score_tail), two launches on a card."""
    raw, ang_c = sc.score_windows_head(
        grid_flat, grid_size, center_off, local_pts, finite, x_off_c,
        y_off_c, scale, coarse_angle_offset, coarse_angle_res, na_coarse)
    return sc.score_tail(
        raw, grid_flat, center_off, local_pts, finite, ang_c, x_off_c,
        y_off_c, x_off_f, y_off_f, scale, fine_angle_offset, fine_angle_res,
        coarse_angle_res, penalize, dist_var_penalty, ang_var_penalty,
        min_dist_pen, min_ang_pen, grid_size, na_fine, refine)


def build_index_tables(angles, local_pts, center, offset, scale, x_off, y_off):
    """Integer gather tables in float64 on the host: per-(angle, beam)
    rotated cell offsets (the GridIndexLookup idea, Karto.h:6797-6894) and
    candidate cells. Computing these in f64 makes the device pass exact —
    indices round identically to the reference regardless of on-device fp
    contraction. na*B is tiny (~20k ints)."""
    c, s = np.cos(angles), np.sin(angles)  # (na,)
    lx = local_pts[:, 0].astype(np.float64)
    ly = local_pts[:, 1].astype(np.float64)
    rx = (c[:, None] * lx[None, :] - s[:, None] * ly[None, :]) * scale
    ry = (s[:, None] * lx[None, :] + c[:, None] * ly[None, :]) * scale
    with np.errstate(invalid="ignore"):
        d = np.stack(
            [_round_ha_np(rx), _round_ha_np(ry)], axis=-1
        )
    d = np.nan_to_num(d, nan=1 << 28).astype(np.int32)  # NaN -> OOB sink
    cand_x = _round_ha_np(
        (center[0] + np.asarray(x_off) - offset[0]) * scale
    ).astype(np.int32)
    cand_y = _round_ha_np(
        (center[1] + np.asarray(y_off) - offset[1]) * scale
    ).astype(np.int32)
    return d, cand_x, cand_y


def _round_ha_np(x):
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5))


def _normalize(a: float) -> float:
    return float(np.arctan2(np.sin(a), np.cos(a)))


def _scan_device_cache(scan, device):
    """Device-resident (local_pts, finite) for a scan — pose-independent,
    uploaded once per scan and reused across its sequential/loop matches."""
    cached = getattr(scan, "_dev_local", None)
    if cached is not None and cached[0].device == device:
        return cached
    local_pts = np.nan_to_num(
        np.ascontiguousarray(scan.local_points, dtype=np.float32), nan=0.0
    )
    finite = np.isfinite(scan.ranges)
    out = (torch.from_numpy(local_pts).to(device),
           torch.from_numpy(finite).to(device))
    try:
        scan._dev_local = out
    except AttributeError:
        pass
    return out


def _fvp_structure(scan):
    """Cached FindValidPoints structure per scan (see rasterize.py)."""
    cached = getattr(scan, "_fvp", None)
    pts = scan.points_world(filtered=False)
    if cached is not None and cached[0] is scan._points:
        return cached[1]
    struct = rz.find_valid_points_structure(pts)
    try:
        scan._fvp = (scan._points, struct)
    except AttributeError:
        pass
    return struct
