"""The benchmark's table of peaks and the operations and bytes of the
kernels whose roofline shares it reports.

Copied from chip_smoke.py (MEM_BYTES_PER_S, SCALAR_OPS_PER_S, bound(),
and check_step_kernels' arithmetic for K1's head form and K7) and from
the matcher's geometry (kernels/match.py Matcher.__init__); the joint
solve's least work is the benchmark's own count. None of it reads the
program: a launch's geometry comes from the configuration's settings.

The counts are what the inputs need, counted once: each input byte read
once, each output byte written once, an operation per arithmetic step.
Where a count depends on the data of a launch, which the trace does not
give, the part that does is left out (the raster cells K1 reads, K7's
fine gathers), so each least time is a lower bound and a share never
counts the work too high.
"""
from __future__ import annotations

import math

# NVIDIA H100 SXM, the data sheet's dense rates at the full 700 W
MEM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12        # f32 outside the tensor cores
F32_FLOPS_PER_S = 67e12


def bound(nbytes: float, ops: float):
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the memory's rate and the operations over the f32 rate."""
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def match_geometry(search_size: float, resolution: float,
                   range_threshold: float, coarse_angle_offset: float,
                   coarse_angle_resolution: float,
                   fine_angle_offset: float) -> dict:
    """A correlative matcher's launch geometry (Matcher.__init__): the
    raster side G, the coarse lattice side n, the coarse and fine heading
    counts."""
    roi = int(math.floor(search_size / resolution + 0.5)) + 1
    margin = int(math.ceil(range_threshold / resolution))
    coarse_extent = 0.5 * (roi - 1) * resolution
    n = int(math.floor(coarse_extent * 2.0 / (2.0 * resolution) + 0.5)) + 1
    na = int(math.floor(coarse_angle_offset * 2.0 / coarse_angle_resolution
                        + 0.5)) + 1
    fine_off = 0.5 * coarse_angle_resolution
    naf = int(math.floor(fine_off * 2.0 / fine_angle_offset + 0.5)) + 1
    return dict(G=roi + 2 * margin, n=n, na=na, naf=naf)


def mapper_geometries(mapper: dict, laser_range_threshold: float) -> dict:
    """{G: geometry} of the sequential and the loop matcher of a
    MapperConfig's settings (`mapper`: its keys, with the program's
    defaults for the loop search where the configuration leaves them)."""
    seq = match_geometry(
        mapper["correlation_search_space_dimension"],
        mapper["correlation_search_space_resolution"], laser_range_threshold,
        mapper["coarse_search_angle_offset"],
        mapper["coarse_angle_resolution"], mapper["fine_search_angle_offset"])
    loop = match_geometry(
        mapper["loop_search_space_dimension"],
        mapper["loop_search_space_resolution"], laser_range_threshold,
        mapper["coarse_search_angle_offset"],
        mapper["coarse_angle_resolution"], mapper["fine_search_angle_offset"])
    return {seq["G"]: seq, loop["G"]: loop}


def score_windows_head(geom: dict, beams: float):
    """K1's head form, one launch: (bytes, operations). The query's beams
    (9 B each) and the coarse sums out (4 B each); an add a gather (every
    finite beam at every coarse offset and heading) and 12 operations a
    (heading, beam) rotation. The distinct raster cells read are left
    out (they depend on the scan)."""
    na, n = geom["na"], geom["n"]
    nbytes = beams * 9 + na * n * n * 4 + na * 4 + 20 + 16 * n
    ops = na * beams * n * n + 12 * na * beams
    return nbytes, ops


def score_tail(geom: dict, beams: float):
    """K7, one launch: (bytes, operations). The coarse sums in (4 B
    each), the query's beams, the result out; about 10 operations a
    coarse sum. The fine pass's gathers are left out (a launch may or may
    not refine, and its cells depend on the scan)."""
    na, n = geom["na"], geom["n"]
    return 4 * na * n * n + beams * 9 + 20 + 52 + 24, 10 * na * n * n


KERNEL_COUNTS = {"score_windows": score_windows_head,
                 "score_tail": score_tail}


def kernel_least_s(kernel: str, launches_by_grid: dict, geometries: dict,
                   beams: float) -> float:
    """Least seconds of `kernel`'s launches {G: count} at their
    geometries."""
    count = KERNEL_COUNTS[kernel]
    total = 0.0
    for G, n in launches_by_grid.items():
        geom = geometries.get(int(G))
        if geom is None:
            raise KeyError(f"{kernel} launched at G {G}, a geometry the "
                           "configuration does not give")
        ms, _ = bound(*count(geom, beams))
        total += n * ms * 1e-3
    return total


def joint_solve_least_s(n_pad: int, n_edges: int, block: int,
                        lm_steps: int, cg_iterations: int) -> float:
    """Least seconds of a Schwarz-preconditioned LM solve: per LM step
    the Cholesky factorization of each block of `block` nodes (3 block
    rows a node, n^3 / 3 flops) at the f32 rate and one read of the
    graph's arrays (poses, edges: 2 indices, 3 measurements, 9 of
    sqrt-information, a mask); per CG iteration one read of the blocks'
    factors (their lower triangles, 4 B a value) at the memory's rate.
    The phases depend on one another (the CG applies the step's factors),
    so their least times add."""
    nb = n_pad // block
    m = 3 * block
    chol_flops = nb * m ** 3 / 3.0
    factor_bytes = nb * m * (m + 1) / 2 * 4
    graph_bytes = n_pad * 3 * 4 + n_edges * (2 * 8 + 3 * 4 + 9 * 4 + 1)
    per_step = (chol_flops / F32_FLOPS_PER_S
                + graph_bytes / MEM_BYTES_PER_S)
    per_iter = factor_bytes / MEM_BYTES_PER_S
    return lm_steps * per_step + cg_iterations * per_iter
