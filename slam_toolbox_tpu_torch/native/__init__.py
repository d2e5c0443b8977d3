"""Native (C++) graph-query library with ctypes bindings.

Compiled from graph_ops.cpp on first use (g++ -O3 -shared) into the
package's build directory, never next to the source; falls back to None
if no toolchain is available — callers keep a pure-Python path.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "graph_ops.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_LIB_PATH = os.path.join(BUILD_DIR, "libgraph_ops.so")

_lib = None


def _build() -> bool:
    try:
        if (
            os.path.exists(_LIB_PATH)
            and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC)
        ):
            return True
        os.makedirs(BUILD_DIR, exist_ok=True)
        # build under a private name, then rename: concurrent test
        # workers may build at once, and a reader never sees a partial file
        tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O3", "-ffp-contract=off", "-shared", "-fPIC",
             "-std=c++17",
             _SRC, "-o", tmp],
            check=True, capture_output=True,
        )
        os.replace(tmp, _LIB_PATH)
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def get_lib():
    global _lib
    if _lib is not None:
        return _lib
    if not _build():
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    i64 = ctypes.c_int64
    f64 = ctypes.c_double
    # buffers are passed as raw addresses (arr.ctypes.data) — the
    # ndpointer/from_param/cast path costs ~50 us per argument, which
    # dominated these sub-ms calls on the host bookkeeping path; callers
    # guarantee contiguity with ascontiguousarray and keep the arrays
    # alive across the call
    ptr = ctypes.c_void_p

    lib.bfs_within_radius.restype = i64
    lib.bfs_within_radius.argtypes = [
        i64, ptr, ptr, ptr, ptr, i64, f64, f64, f64, ptr, ptr,
    ]
    lib.loop_candidate_sweep.restype = i64
    lib.loop_candidate_sweep.argtypes = [
        i64, ptr, ptr, ptr, f64, f64, f64, i64,
        ctypes.POINTER(i64), ptr,
    ]
    lib.near_chains_sweep.restype = i64
    lib.near_chains_sweep.argtypes = [
        i64, ptr, ptr, ptr, i64, i64, f64, f64, f64, ptr, ptr,
    ]
    lib.radius_query.restype = i64
    lib.radius_query.argtypes = [i64, ptr, f64, f64, f64, ptr]
    lib.fvp_structure.restype = i64
    lib.fvp_structure.argtypes = [i64, ptr, ptr, ptr, ptr]
    lib.scan_pack.restype = None
    lib.scan_pack.argtypes = [i64, ptr, ptr, ptr]
    lib.sparse_block_solve.restype = i64
    lib.sparse_block_solve.argtypes = [
        i64, i64, ptr, ptr, ptr, ptr, ptr, ptr,
    ]
    lib.sparse_chol_analyze.restype = ptr
    lib.sparse_chol_analyze.argtypes = [i64, i64, ptr, ptr]
    lib.sparse_chol_factor_solve.restype = i64
    lib.sparse_chol_factor_solve.argtypes = [ptr, ptr, ptr, ptr, ptr]
    lib.sparse_chol_free.restype = None
    lib.sparse_chol_free.argtypes = [ptr]
    lib.se2_normal_blocks.restype = f64
    lib.se2_normal_blocks.argtypes = [i64, i64] + [ptr] * 11
    lib.se2_chi2.restype = f64
    lib.se2_chi2.argtypes = [i64] + [ptr] * 8
    lib.occupancy_raster.restype = None
    lib.occupancy_raster.argtypes = [
        ptr, ptr, ptr, ptr, i64, i64, i64, ptr, ptr,
    ]
    lib.decay_reading_overlap.restype = None
    lib.decay_reading_overlap.argtypes = [i64] + [ptr] * 6
    lib.decay_boxes.restype = None
    lib.decay_boxes.argtypes = [i64] + [ptr] * 5
    lib.augment_csr.restype = None
    lib.augment_csr.argtypes = [
        i64, i64, ptr, ptr, ptr, i64, ptr, ptr, ptr, ptr,
    ]
    _lib = lib
    return lib


def augment_csr(indptr0, indices0, segend0, es, ed):
    """Base CSR + new edges -> augmented (indptr, indices), bit-exact to
    the numpy lexsort/insert path in pose_graph._query_structure (which
    remains the fallback). All inputs int64; indptr0 length n+1."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(indptr0) - 1
    k = len(es)
    out_indptr = np.empty(n + 1, np.int64)
    out_indices = np.empty(len(indices0) + 2 * k, np.int64)
    lib.augment_csr(
        n, len(indices0), indptr0.ctypes.data, indices0.ctypes.data,
        segend0.ctypes.data, k, es.ctypes.data, ed.ctypes.data,
        out_indptr.ctypes.data, out_indices.ctypes.data,
    )
    return out_indptr, out_indices


def _decay_arrays(start, count, points, pose, *rows):
    """The decay's arrays as the native passes read them (contiguous,
    int64 and f64), their shapes and rows checked: each of the n
    candidates owns rows start .. start + count of points (r, 2), with
    pose (n, 4) and each of `rows` (n, 4)."""
    arrs = ([np.ascontiguousarray(start, np.int64),
             np.ascontiguousarray(count, np.int64)]
            + [np.ascontiguousarray(a, np.float64)
               for a in (points, pose, *rows)])
    start, count, points = arrs[:3]
    n = len(start)
    want = [(n,), (n,), (len(points), 2)] + [(n, 4)] * (1 + len(rows))
    if [a.shape for a in arrs] != want:
        raise ValueError(
            f"decay arrays of shapes {[a.shape for a in arrs]}")
    if n and (start.min() < 0 or count.min() < 0
              or (start + count).max() > len(points)):
        raise ValueError("a candidate's rows fall outside the points")
    return arrs


def decay_reading_overlap(start, count, points, pose, bounds):
    """Of each candidate i, its points rows start[i] .. start[i] +
    count[i] of `points` (sensor frame) strictly inside bounds[i] = (x_l,
    x_u, y_l, y_u) once moved to pose[i] = (x, y, cos, sin): (n,) int64,
    equal to mapper/lifelong._np_decay_reading_overlap's. None if no
    lib."""
    lib = get_lib()
    if lib is None:
        return None
    arrs = _decay_arrays(start, count, points, pose, bounds)
    n = len(arrs[0])
    inside = np.empty(n, np.int64)
    lib.decay_reading_overlap(
        n, *(a.ctypes.data for a in arrs), inside.ctypes.data)
    return inside


def decay_boxes(start, count, points, pose):
    """LocalizedScan.bounding_box of each candidate i at pose[i] = (x,
    y, cos, sin) of its sensor, from its filtered sensor-frame points
    rows start[i] .. start[i] + count[i] of `points`: (n, 2, 2) of [[min
    x, min y], [max x, max y]], equal to the property's. None if no
    lib."""
    lib = get_lib()
    if lib is None:
        return None
    arrs = _decay_arrays(start, count, points, pose)
    n = len(arrs[0])
    box = np.empty((n, 2, 2))
    lib.decay_boxes(n, *(a.ctypes.data for a in arrs), box.ctypes.data)
    return box


def occupancy_raster(start_cells, end_cells, beam_valid, end_valid,
                     width, height, pass_cnt, hit_cnt) -> bool:
    """Accumulate Bresenham pass/hit counts in place (int32 (H, W)
    arrays). Returns False when the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    sc = np.ascontiguousarray(start_cells, np.int32)
    ec = np.ascontiguousarray(end_cells, np.int32)
    bv = np.ascontiguousarray(beam_valid, np.uint8)
    ev = np.ascontiguousarray(end_valid, np.uint8)
    assert pass_cnt.dtype == np.int32 and pass_cnt.flags.c_contiguous
    assert hit_cnt.dtype == np.int32 and hit_cnt.flags.c_contiguous
    lib.occupancy_raster(
        sc.ctypes.data, ec.ctypes.data, bv.ctypes.data, ev.ctypes.data,
        len(sc), int(width), int(height),
        pass_cnt.ctypes.data, hit_cnt.ctypes.data,
    )
    return True


class SparseCholesky:
    """Reusable symbolic analysis of the block normal equations: analyze
    once per Compute(), factor+solve per LM iteration (only the damped
    values change). Wraps the native CholSymbolic handle."""

    def __init__(self, n, src, dst):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native lib unavailable")
        self._lib = lib
        self.n = int(n)
        self._src = np.ascontiguousarray(src, np.int64)
        self._dst = np.ascontiguousarray(dst, np.int64)
        self._h = lib.sparse_chol_analyze(
            self.n, len(self._src),
            self._src.ctypes.data, self._dst.ctypes.data,
        )

    def factor_solve(self, diag, off, b):
        """Returns x (n,3) or None on pivot failure (not SPD)."""
        diag_c = np.ascontiguousarray(diag, np.float64)
        off_c = np.ascontiguousarray(off, np.float64)
        b_c = np.ascontiguousarray(b, np.float64)
        x = np.zeros((self.n, 3), np.float64)
        nnz = self._lib.sparse_chol_factor_solve(
            self._h, diag_c.ctypes.data, off_c.ctypes.data,
            b_c.ctypes.data, x.ctypes.data,
        )
        if nnz < 0:
            return None
        return x

    def close(self):
        if self._h:
            self._lib.sparse_chol_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _edge_arrays(poses, src, dst, rel, sqrt_info, trig):
    """The arrays as the native assembly reads them (contiguous, int64 and
    f64), their shapes and node indices checked."""
    arrs = ([np.ascontiguousarray(src, np.int64),
             np.ascontiguousarray(dst, np.int64)]
            + [np.ascontiguousarray(a, np.float64)
               for a in (poses, rel, sqrt_info, *trig)])
    n, e = len(arrs[2]), len(arrs[0])
    want = [(e,), (e,), (n, 3), (e, 3), (e, 3, 3), (e,), (e,), (e,)]
    if [a.shape for a in arrs] != want:
        raise ValueError(f"edge arrays of shapes {[a.shape for a in arrs]}")
    if e and not (0 <= min(arrs[0].min(), arrs[1].min())
                  and max(arrs[0].max(), arrs[1].max()) < n):
        raise ValueError("an edge names a node outside the poses")
    return arrs


def normal_blocks(poses, src, dst, rel, sqrt_info, trig):
    """The SE(2) normal equations of edges (src, dst, rel, sqrt_info) at
    `poses` (n, 3) in one native pass: (diag (n, 3, 3), hab (e, 3, 3),
    grad (n, 3), chi2), bit-identical to se2_solver._np_normal_blocks.
    `trig` is NumPy's (cos and sin of each edge's source heading, its
    wrapped heading residual), se2_solver._edge_trig. None if no lib."""
    lib = get_lib()
    if lib is None:
        return None
    arrs = _edge_arrays(poses, src, dst, rel, sqrt_info, trig)
    n, e = len(arrs[2]), len(arrs[0])
    diag = np.empty((n, 3, 3))
    hab = np.empty((e, 3, 3))
    grad = np.empty((n, 3))
    total = lib.se2_normal_blocks(
        n, e, *(a.ctypes.data for a in arrs), diag.ctypes.data,
        hab.ctypes.data, grad.ctypes.data,
    )
    return diag, hab, grad, total


def chi2(poses, src, dst, rel, sqrt_info, trig):
    """normal_blocks' chi2 alone, bit-identical to se2_solver._np_chi2;
    None if no lib."""
    lib = get_lib()
    if lib is None:
        return None
    arrs = _edge_arrays(poses, src, dst, rel, sqrt_info, trig)
    return lib.se2_chi2(len(arrs[0]), *(a.ctypes.data for a in arrs))


def sparse_block_solve(src, dst, diag, off, b):
    """Solve the SE(2) block normal equations H x = b with a host
    simplicial sparse Cholesky (min-degree ordering, 3x3 blocks) — the
    Ceres SPARSE_NORMAL_CHOLESKY analog for graphs past the dense
    ceiling. diag (n,3,3) must already be damped and gauge-fixed (unit
    diagonal on fixed nodes, no edges touching them). Returns x (n,3) or
    None if the lib is unavailable / the matrix is not SPD."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(diag)
    e = len(src)
    src_c = np.ascontiguousarray(src, np.int64)
    dst_c = np.ascontiguousarray(dst, np.int64)
    diag_c = np.ascontiguousarray(diag, np.float64)
    off_c = np.ascontiguousarray(off, np.float64)
    b_c = np.ascontiguousarray(b, np.float64)
    x = np.zeros((n, 3), np.float64)
    nnz = lib.sparse_block_solve(
        n, e, src_c.ctypes.data, dst_c.ctypes.data, diag_c.ctypes.data,
        off_c.ctypes.data, b_c.ctypes.data, x.ctypes.data,
    )
    if nnz < 0:
        return None
    return x


def scan_pack(local_points, ranges):
    """One-call (B, 8) f32 streaming pack (mapper/streaming.scan_pack
    layout), bit-identical to the numpy assembly; None if no lib."""
    lib = get_lib()
    if lib is None:
        return None
    pts = np.ascontiguousarray(local_points, np.float64)
    rng = np.ascontiguousarray(ranges, np.float64)
    n = len(pts)
    pack = np.empty((n, 8), np.float32)
    lib.scan_pack(
        n, pts.ctypes.data, rng.ctypes.data, pack.ctypes.data,
    )
    return pack


def fvp_structure(points):
    """Native FindValidPoints structure; returns
    (delim_idx (D,), anchors (D,2), next_delim (B,)) or None."""
    lib = get_lib()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, np.float64)
    n = len(pts)
    delim_idx = np.zeros(n, np.int64)
    anchors = np.zeros((n, 2), np.float64)
    next_delim = np.zeros(n, np.int64)
    d = lib.fvp_structure(
        n, pts.ctypes.data, delim_idx.ctypes.data, anchors.ctypes.data,
        next_delim.ctypes.data,
    )
    return delim_idx[:d].copy(), anchors[:d].copy(), next_delim


def near_chains_sweep(xy, present, nears, scan_slot, center,
                      max_distance):
    """(rows (k, 3) of [lo, hi, valid]) chain slot ranges, or None."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(xy)
    m = len(nears)
    xy_c = np.ascontiguousarray(xy, np.float64)
    present_c = np.ascontiguousarray(present, np.uint8)
    nears_c = np.ascontiguousarray(nears, np.int64)
    processed = np.zeros(n, np.uint8)
    out = np.zeros((max(m, 1), 3), np.int64)
    cnt = lib.near_chains_sweep(
        n, xy_c.ctypes.data, present_c.ctypes.data, nears_c.ctypes.data,
        m, int(scan_slot),
        float(center[0]), float(center[1]),
        float(max_distance) * float(max_distance) + 1e-6,
        processed.ctypes.data, out.ctypes.data,
    )
    return out[:cnt].copy()


def bfs_within_radius(xy, present, indptr, indices, start, center,
                      max_distance):
    """Returns indices (BFS order) of present nodes within max_distance
    reachable through in-radius present nodes; None if no native lib."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(xy)
    visited = np.zeros(n, np.uint8)
    order = np.zeros(n, np.int64)
    xy_c = np.ascontiguousarray(xy, np.float64)
    present_c = np.ascontiguousarray(present, np.uint8)
    indptr_c = np.ascontiguousarray(indptr, np.int64)
    indices_c = np.ascontiguousarray(indices, np.int64)
    cnt = lib.bfs_within_radius(
        n, xy_c.ctypes.data, present_c.ctypes.data,
        indptr_c.ctypes.data, indices_c.ctypes.data,
        int(start), float(center[0]), float(center[1]),
        float(max_distance) * float(max_distance) - 1e-6,
        visited.ctypes.data, order.ctypes.data,
    )
    return order[:cnt].copy()


def loop_candidate_sweep(
    xy, present, near_linked, center, max_distance, min_chain, start_idx
):
    """Returns (chain_slot_indices, next_start_idx) or None if no lib."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(xy)
    chain = np.zeros(n, np.int64)
    s = ctypes.c_int64(int(start_idx))
    xy_c = np.ascontiguousarray(xy, np.float64)
    present_c = np.ascontiguousarray(present, np.uint8)
    near_c = np.ascontiguousarray(near_linked, np.uint8)
    cnt = lib.loop_candidate_sweep(
        n, xy_c.ctypes.data, present_c.ctypes.data, near_c.ctypes.data,
        float(center[0]), float(center[1]),
        float(max_distance) * float(max_distance) + 1e-6,
        int(min_chain), ctypes.byref(s), chain.ctypes.data,
    )
    return chain[:cnt].copy(), int(s.value)
