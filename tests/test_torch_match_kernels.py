"""The plain versions of the port's kernels against the JAX package's
Pallas kernels (in interpret mode, as the JAX tests run them on the CPU)
and XLA reference paths; the kernels themselves against their plain
versions on a CUDA card (marked `cuda`, skipped without one)."""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_toolbox_tpu.kernels import match_pallas as mp
from slam_toolbox_tpu.kernels import rasterize as jrz
from slam_toolbox_tpu.kernels.match import _score_tensor
from slam_toolbox_tpu_torch.kernels import match_cuda as mc
from slam_toolbox_tpu_torch.kernels import rasterize as trz


def _window_case(seed, G, na, B, n, cand0):
    rng = np.random.default_rng(seed)
    grid2d = rng.integers(0, 101, (G, G)).astype(np.int8)
    grid_flat = np.concatenate([grid2d.reshape(-1), np.zeros(1, np.int8)])
    d = rng.integers(-140, 140, (na, B, 2)).astype(np.int32)
    d[:, :3] = (1 << 28)  # far out of the grid, as the f64 tables map NaN
    finite = rng.random(B) > 0.1
    return grid2d, grid_flat, d, finite


def _xla_sums(grid_flat, G, cand_x, cand_y, d, finite):
    na = d.shape[0]
    resp = _score_tensor(
        jnp.asarray(grid_flat), G, G * G,
        jnp.asarray(cand_x), jnp.asarray(cand_y), jnp.asarray(d),
        jnp.asarray(finite),
        jnp.zeros(len(cand_x), jnp.float32),
        jnp.zeros(len(cand_y), jnp.float32),
        jnp.zeros(na, jnp.float32), jnp.float32(0.0), jnp.bool_(False),
        jnp.float32(1.0), jnp.float32(1.0),
        jnp.float32(0.5), jnp.float32(0.9),
    )
    return np.round(np.asarray(resp, np.float64) * (d.shape[1] * 100.0))


def _plain_sums(grid_flat, G, d, cx0, cy0, ny, nx, finite):
    return mc.score_windows(
        torch.from_numpy(grid_flat), G, torch.from_numpy(d),
        torch.tensor(cx0, dtype=torch.int32),
        torch.tensor(cy0, dtype=torch.int32), ny, nx,
        torch.from_numpy(finite),
    ).numpy()


@pytest.mark.parametrize("seed,cand0", [(0, 31), (1, -9), (2, 230)])
def test_score_windows_plain_matches_pallas_and_xla(seed, cand0):
    """Raw window sums equal the Pallas kernel's (interpret mode) and
    _score_tensor's, with negative and out-of-grid cells and non-finite
    beams."""
    G, na, B, n = 257, 5, 97, 26
    grid2d, grid_flat, d, finite = _window_case(seed, G, na, B, n, cand0)
    got = _plain_sums(grid_flat, G, d, cand0, cand0, n, n, finite)
    assert got.dtype == np.int32 and got.shape == (na, n, n)

    cand = (cand0 + 2 * np.arange(n)).astype(np.int32)
    np.testing.assert_array_equal(
        got, _xla_sums(grid_flat, G, cand, cand, d, finite))

    pgrid = mp.prepare_parity_grid(jnp.asarray(grid2d))
    tbl = mp.prepare_tables(jnp.asarray(d), np.int32(cand0), np.int32(cand0),
                            jnp.asarray(finite), G)
    pallas = np.asarray(mp.score_windows(pgrid, tbl, interpret=True))
    np.testing.assert_array_equal(got, pallas[:, :n, :n])


@pytest.mark.parametrize("cx0,cy0", [(-40, 7), (120, -75)])
def test_score_windows_plain_loop_lattice(cx0, cy0):
    """The loop matcher's 81 x 81 lattice, offset origins, against the XLA
    gather (the Pallas table invalidates far-off windows at this height,
    so the gather is the reference here)."""
    G, na, B, n = 161, 3, 41, 81
    _, grid_flat, d, finite = _window_case(7, G, na, B, n, cx0)
    got = _plain_sums(grid_flat, G, d, cx0, cy0, n, n, finite)
    np.testing.assert_array_equal(got, _xla_sums(
        grid_flat, G, (cx0 + 2 * np.arange(n)).astype(np.int32),
        (cy0 + 2 * np.arange(n)).astype(np.int32), d, finite))


@pytest.mark.parametrize("cx0,cy0,ny,nx", [
    (-30, -40, 7, 11), (-40, 230, 11, 7), (120, -75, 26, 26),
    (250, 3, 1, 13), (-3, -3, 17, 1),
])
def test_score_windows_plain_extreme_tables(cx0, cy0, ny, nx):
    """The semantics the kernel's per-beam spans must keep: table entries
    of INT_MIN (torch's NaN to int32) and +-(1 << 28) (the f64 tables'
    NaN) in either coordinate, on finite and on non-finite beams, add
    nothing; negative origins and ny != nx lattices. Against the JAX
    package's XLA gather."""
    G, na, B = 257, 4, 61
    _, grid_flat, d, finite = _window_case(11 + ny, G, na, B, 26, cx0)
    big = np.iinfo(np.int32).min
    for k, (axis, v) in enumerate(((0, big), (1, big), (0, 1 << 28),
                                   (1, 1 << 28), (0, -(1 << 28)))):
        d[:, 5 + 6 * k:8 + 6 * k, axis] = v
        finite[5 + 6 * k:7 + 6 * k] = True    # finite and
        finite[7 + 6 * k] = False             # non-finite beams
    d[1, 40:44] = big
    finite[40:42] = True
    got = _plain_sums(grid_flat, G, d, cx0, cy0, ny, nx, finite)
    assert got.shape == (na, ny, nx)
    np.testing.assert_array_equal(got, _xla_sums(
        grid_flat, G, (cx0 + 2 * np.arange(nx)).astype(np.int32),
        (cy0 + 2 * np.arange(ny)).astype(np.int32), d, finite))
    assert got.any()


def _unparity(planes, G):
    """(4, >=gh, >=gh) parity planes (origin at row r0, col c0 handled by
    the caller) -> (G, G) full grid: cell (y, x) = planes[2(y&1)+(x&1),
    y>>1, x>>1]."""
    y, x = np.mgrid[0:G, 0:G]
    return planes[2 * (y & 1) + (x & 1), y >> 1, x >> 1]


def _raster_inputs(G, seed):
    rng = np.random.default_rng(seed)
    P = 256
    pts = (rng.uniform(-0.1 * G, 1.1 * G, (P, 2)) * 0.01).astype(np.float32)
    valid = rng.random(P) < 0.9
    pts[:4] = -1e9
    valid[:4] = False
    return pts, valid, np.zeros(2, np.float32)


def _pack_numpy(occ):
    """(G, G) 0/1 -> (ceil(G/32), G) int32 words from the layout's
    definition: bit r & 31 of word (r >> 5, c) is cell (r, c)."""
    G = occ.shape[0]
    nw = (G + 31) // 32
    rows = np.zeros((nw * 32, G), np.int64)
    rows[:G] = occ
    words = (rows.reshape(nw, 32, G) << np.arange(32)[None, :, None]).sum(1)
    return np.where(words >= 1 << 31, words - (1 << 32), words).astype(
        np.int32)


@pytest.mark.parametrize("G", [100, 101, 257])
def test_scatter_plain_matches_pallas_parity(G):
    pts, valid, off = _raster_inputs(G, G)
    ref = np.asarray(mp.scatter_occupancy_parity(
        jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(off),
        np.float32(100.0), G))
    words = mc.scatter_occupancy(torch.from_numpy(pts),
                                 torch.from_numpy(valid),
                                 torch.from_numpy(off), 100.0, G)
    assert words.dtype == torch.int32 and words.shape == ((G + 31) // 32, G)
    got = trz.unpack_occupancy(words, G).numpy()
    assert got.dtype == np.uint8 and got.shape == (G, G)
    occ = _unparity(ref, G).astype(np.uint8)
    np.testing.assert_array_equal(got, occ)
    np.testing.assert_array_equal(words.numpy(), _pack_numpy(occ))
    assert got.sum() > 0


@pytest.mark.parametrize("G,hk", [(101, 5), (100, 4), (257, 10)])
def test_smear_plain_matches_pallas_parity(G, hk):
    """Scatter + smear + quantize from the packed words equal the Pallas
    rasterize_parity output mapped back from the padded parity layout."""
    pts, valid, off = _raster_inputs(G, 3 * G + hk)
    sigma = hk / 2.0
    pgrid = np.asarray(mp.rasterize_parity(
        jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(off),
        np.float32(100.0), np.float32(sigma), G, hk, 32))
    gh = (G + 1) // 2
    planes = pgrid[:, mp.PAD_TOP:mp.PAD_TOP + gh,
                   mp.PAD_LEFT:mp.PAD_LEFT + gh]
    words = mc.scatter_occupancy(torch.from_numpy(pts),
                                 torch.from_numpy(valid),
                                 torch.from_numpy(off), 100.0, G)
    w = torch.from_numpy(trz.smear_weights(sigma, hk))
    got = mc.smear_quantize(words, w, G, hk).numpy()
    np.testing.assert_array_equal(got[:-1].reshape(G, G),
                                  _unparity(planes, G))
    assert got[-1] == 0


@pytest.mark.parametrize("G,hk", [(40, 60), (64, 63)])
def test_smear_plain_taps_past_the_grid(G, hk):
    """Taps that reach past the grid (hk >= G - 1), which the JAX package
    takes through rasterize_parity's XLA route and the port's kernel by
    clamping hk to G - 1 (csrc/smear_quantize.cu): the plain version
    equals JAX's, and equals itself run on the G - 1 taps each side of
    the centre, which is what the kernel runs."""
    pts, valid, off = _raster_inputs(G, 7 * G + hk)
    sigma = hk / 2.0
    pgrid = np.asarray(mp.rasterize_parity(
        jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(off),
        np.float32(100.0), np.float32(sigma), G, hk, 32))
    gh = (G + 1) // 2
    planes = pgrid[:, mp.PAD_TOP:mp.PAD_TOP + gh,
                   mp.PAD_LEFT:mp.PAD_LEFT + gh]
    words = mc.scatter_occupancy(torch.from_numpy(pts),
                                 torch.from_numpy(valid),
                                 torch.from_numpy(off), 100.0, G)
    w = torch.from_numpy(trz.smear_weights(sigma, hk))
    got = mc.smear_quantize(words, w, G, hk).numpy()
    np.testing.assert_array_equal(got[:-1].reshape(G, G),
                                  _unparity(planes, G))
    h = G - 1
    clamped = trz.smear_quantize_plain(words, w[hk - h:hk + h + 1], G, h)
    np.testing.assert_array_equal(got, clamped.numpy())
    assert got.sum() > 0


def test_score_windows_plain_past_the_narrow_limits():
    """The semantics K1's wide instantiation keeps (csrc/score_windows.cu):
    a 2 x 70,000 lattice whose grid lies at the far end of its columns, so
    every in-grid span starts past 65,535 (the narrow form's 16-bit
    fields), against the JAX package's XLA gather."""
    G, na, B, ny, nx = 257, 2, 24, 2, 70000
    _, grid_flat, d, finite = _window_case(5, G, na, B, 26, 0)
    d[...] = np.clip(d, -100, 100)
    cx0, cy0 = G + 50 - 2 * (nx - 1), 100
    got = _plain_sums(grid_flat, G, d, cx0, cy0, ny, nx, finite)
    np.testing.assert_array_equal(got, _xla_sums(
        grid_flat, G, (cx0 + 2 * np.arange(nx)).astype(np.int32),
        (cy0 + 2 * np.arange(ny)).astype(np.int32), d, finite))
    assert got[:, :, 65536:].any() and not got[:, :, :65535].any()


def test_plain_smear_ignores_bits_past_the_grid():
    """At odd G the last word row is partly filled: set bits of rows at or
    beyond G change nothing."""
    G, hk = 101, 5
    rng = np.random.default_rng(3)
    words = _pack_numpy(rng.random((G, G)) < 0.05)
    stray = words.copy()
    stray[-1] |= np.int32(~((1 << (G % 32)) - 1))
    w = torch.from_numpy(trz.smear_weights(2.5, hk))
    np.testing.assert_array_equal(
        trz.smear_quantize_plain(torch.from_numpy(stray), w, G, hk).numpy(),
        trz.smear_quantize_plain(torch.from_numpy(words), w, G, hk).numpy())


@pytest.mark.parametrize("sigma", [0.5, 0.6, 1.0, 2.5, 10.0, 25.0])
@pytest.mark.parametrize("hk", [0, 1, 2, 5, 20, 33, 64])
def test_smear_weights_meet_the_kernel_precondition(sigma, hk):
    """Every tap vector smear_weights makes is finite, non-negative,
    symmetric and non-increasing outward (what the smear kernel relies
    on), the two matcher geometries (sigma 10 cells, hk 20; sigma 0.6,
    hk 1 at the loop grid) included, out to taps that underflow to 0."""
    w = trz.smear_weights(sigma, hk)
    trz.check_smear_taps(w)
    assert w[hk] == 1.0


def test_matcher_geometries_meet_the_kernel_precondition():
    from slam_toolbox_tpu_torch.core.params import MapperConfig
    from slam_toolbox_tpu_torch.mapper import Mapper

    cfg = MapperConfig(correlation_search_space_resolution=0.01,
                       correlation_search_space_smear_deviation=0.1)
    m = Mapper(cfg, device="cpu")
    m.initialize(10.0)
    for matcher in (m.sequential_matcher, m.loop_matcher):
        trz.check_smear_taps(matcher._w.numpy())
    assert (m.sequential_matcher.half_kernel, m.loop_matcher.half_kernel) \
        == (20, 1)


@pytest.mark.parametrize("taps", [
    [0.5, 1.0, 0.4],              # not symmetric
    [0.6, 0.5, 1.0, 0.5, 0.6],    # increases outward
    [-0.1, 1.0, -0.1],            # negative
    [np.nan, 1.0, np.nan],        # not finite
])
def test_matcher_raises_on_taps_that_break_the_precondition(
        monkeypatch, taps):
    from slam_toolbox_tpu_torch.kernels.match import Matcher

    monkeypatch.setattr(trz, "smear_weights",
                        lambda sigma, hk: np.asarray(taps, np.float32))
    with pytest.raises(ValueError, match="smear taps"):
        Matcher(0.5, 0.05, 0.05, 10.0, 0.35, 0.035, 0.0035, 0.5, 1.0, 0.5,
                0.9, device="cpu")


def test_wrappers_on_cpu_run_plain_and_count_nothing():
    mc.reset_launch_counts()
    pts, valid, off = _raster_inputs(64, 0)
    words = mc.scatter_occupancy(torch.from_numpy(pts),
                                 torch.from_numpy(valid),
                                 torch.from_numpy(off), 100.0, 64)
    assert words.dtype == torch.int32 and words.shape == (2, 64)
    grid = mc.smear_quantize(words, torch.ones(3), 64, 1)
    c = torch.zeros(1, dtype=torch.int32)
    mc.score_ceiling(grid, 64, c, c, 2, 9, 3, 3)
    assert mc.LAUNCHES == {k: 0 for k in mc.KERNELS}


# -- K4, the window-score ceiling ---------------------------------------------
def _ceiling_numpy(grid2d, cx0, cy0, na, B, ny, nx):
    """The ceiling from its definition: beam slot s = a * B + b reads the
    raster at lattice cell + CEIL_OFFSETS[s mod 8]; cells outside add 0."""
    G = grid2d.shape[0]
    uses = np.bincount(np.arange(na * B) % 8, minlength=8)
    out = np.zeros((ny, nx), np.int64)
    for u, (dx, dy) in enumerate(mc.CEIL_OFFSETS):
        y = cy0 + 2 * np.arange(ny)[:, None] + dy
        x = cx0 + 2 * np.arange(nx)[None, :] + dx
        ok = (y >= 0) & (y < G) & (x >= 0) & (x < G)
        out += uses[u] * np.where(
            ok, grid2d[np.clip(y, 0, G - 1), np.clip(x, 0, G - 1)], 0)
    return out


@pytest.mark.parametrize("cx0,cy0", [(975, 975), (-25, 2021), (2021, -25),
                                     (300, 1500)])
def test_score_ceiling_plain_matches_definition_and_xla(cx0, cy0):
    """At the bench raster size (its offsets reach 900 cells), with 3
    headings of 37 beams so that 111 slots cycle the 8 offsets unevenly:
    the plain ceiling equals the numpy definition, the window sums of the
    JAX package's XLA gather on the tiled table summed over headings, and
    score_windows_plain on that table."""
    G, na, B, n = 2051, 3, 37, 26
    rng = np.random.default_rng(cx0 + 7 * cy0)
    grid2d = rng.integers(0, 101, (G, G)).astype(np.int8)
    grid_flat = np.concatenate([grid2d.reshape(-1), np.zeros(1, np.int8)])
    t = torch.from_numpy(grid_flat)
    cx = torch.tensor([cx0], dtype=torch.int32)
    cy = torch.tensor([cy0], dtype=torch.int32)
    got = mc.score_ceiling(t, G, cx, cy, na, B, n, n).numpy()
    assert got.dtype == np.int32 and got.shape == (n, n)
    np.testing.assert_array_equal(
        got, _ceiling_numpy(grid2d, cx0, cy0, na, B, n, n))
    table = mc.ceiling_table(na, B, torch.device("cpu"))
    np.testing.assert_array_equal(table[1, 0].numpy(), mc.CEIL_OFFSETS[37 % 8])
    every = np.ones(B, bool)
    xla = _xla_sums(grid_flat, G, (cx0 + 2 * np.arange(n)).astype(np.int32),
                    (cy0 + 2 * np.arange(n)).astype(np.int32),
                    table.numpy(), every)
    np.testing.assert_array_equal(got, xla.sum(axis=0))
    np.testing.assert_array_equal(
        got, mc.score_windows_plain(t, G, table, cx, cy, n, n,
                                    torch.from_numpy(every)).sum(0).numpy())
    assert got.any()


def _offset_classes(G, cx0, cy0, ny, nx):
    """Per offset: 'full', 'partial' or 'empty' for the ny x nx lattice at
    (cx0, cy0), from the definition."""
    out = []
    for dx, dy in mc.CEIL_OFFSETS:
        ry = np.count_nonzero((0 <= cy0 + dy + 2 * np.arange(ny))
                              & (cy0 + dy + 2 * np.arange(ny) < G))
        rx = np.count_nonzero((0 <= cx0 + dx + 2 * np.arange(nx))
                              & (cx0 + dx + 2 * np.arange(nx) < G))
        out.append("empty" if not ry or not rx else
                   "full" if (ry, rx) == (ny, nx) else "partial")
    return out


# (G, na, B, ny, nx, cx0, cy0): the cases the kernel's slot groups, cell
# tiles and per-offset spans must survive; chip_smoke.check_ceiling_cases
# holds the kernel on the same kinds of case
CEILING_CASES = {
    "7x11": (2051, 3, 37, 7, 11, 975, 975),
    "11x7": (2051, 3, 37, 11, 7, 975, 975),
    "65_slots": (2051, 5, 13, 26, 26, 975, 975),
    "partial_offsets": (2051, 3, 37, 26, 26, 1430, 1320),
    "every_offset_outside": (257, 3, 37, 26, 26, 100, 100),
}


@pytest.mark.parametrize("case", sorted(CEILING_CASES))
def test_score_ceiling_plain_cases_match_definition(case):
    """score_ceiling on CPU tensors (its plain version) against the numpy
    definition on lattices with ny != nx, 65 slots that cycle the offsets
    unevenly, an origin where offsets straddle the grid's edge, and a grid
    that every offset misses (all zeros)."""
    G, na, B, ny, nx, cx0, cy0 = CEILING_CASES[case]
    rng = np.random.default_rng(sum(map(abs, CEILING_CASES[case])))
    grid2d = rng.integers(0, 101, (G, G)).astype(np.int8)
    grid_flat = np.concatenate([grid2d.reshape(-1), np.zeros(1, np.int8)])
    got = mc.score_ceiling(torch.from_numpy(grid_flat), G,
                           torch.tensor([cx0], dtype=torch.int32),
                           torch.tensor([cy0], dtype=torch.int32),
                           na, B, ny, nx).numpy()
    assert got.dtype == np.int32 and got.shape == (ny, nx)
    np.testing.assert_array_equal(
        got, _ceiling_numpy(grid2d, cx0, cy0, na, B, ny, nx))
    classes = _offset_classes(G, cx0, cy0, ny, nx)
    if case == "partial_offsets":
        assert classes.count("partial") == 2 and "empty" in classes
    if case == "every_offset_outside":
        assert set(classes) == {"empty"} and not got.any()
    else:
        assert got.any()


def test_sass_byte_loads_counts_loads_in_loops():
    """chip_smoke's SASS check counts the S8 / U8 global loads of the named
    kernel only, and those between a backward branch and its target."""
    from chip_smoke import sass_byte_loads

    sass = "\n".join([
        "\t\tFunction : _ZN12_GLOBAL__N_120score_ceiling_kernelEPKa",
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;",
        "        /*0100*/                   LDG.E.S8.CONSTANT R5, "
        "desc[UR4][R2.64] ;",
        "        /*0110*/                   LDG.E.U8 R6, desc[UR4][R8.64] ;",
        "        /*0120*/              @!P0 BRA 0x100 ;",
        "        /*0130*/                   LDG.E.S8 R6, desc[UR4][R8.64] ;",
        "        /*0140*/                   LDG.E R7, desc[UR4][R8.64] ;",
        "        /*0150*/                   EXIT ;",
        "\t\tFunction : other_kernel",
        "        /*0100*/                   LDG.E.S8 R5, desc[UR4][R2.64] ;",
        "        /*0110*/                   BRA 0x100 ;",
    ])
    assert sass_byte_loads(sass, "score_ceiling_kernel") == (3, 2)
    assert sass_byte_loads(sass.replace("BRA 0x100", "BRA 0x200"),
                           "score_ceiling_kernel") == (3, None)


def test_score_ceiling_offsets_match_source():
    """The CUDA source's compile-time offsets are CEIL_OFFSETS."""
    src = open(os.path.join(os.path.dirname(mc.__file__), os.pardir, "csrc",
                            "score_ceiling.cu")).read()
    dx, dy = (
        [int(v) for v in re.search(
            rf"#define CEIL_OFFSETS_{axis} \{{([^}}]*)\}}", src).group(1)
            .split(",")]
        for axis in ("DX", "DY"))
    assert list(zip(dx, dy)) == [tuple(o) for o in mc.CEIL_OFFSETS]


def test_smear_tile_matches_source():
    """chip_smoke's tile-edge patterns use SMEAR_TILE; it is the tile of
    the CUDA source."""
    src = open(os.path.join(os.path.dirname(mc.__file__), os.pardir, "csrc",
                            "smear_quantize.cu")).read()
    ty = int(re.search(r"constexpr int TY = (\d+);", src).group(1))
    tx = int(re.search(r"constexpr int TX = (\d+);", src).group(1))
    assert (ty, tx) == mc.SMEAR_TILE


def test_wrappers_check_arguments():
    words = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        mc.smear_quantize(words.float(), torch.ones(3), 8, 1)
    with pytest.raises(TypeError):
        mc.smear_quantize(words.to(torch.uint8), torch.ones(3), 8, 1)
    with pytest.raises(ValueError):
        mc.smear_quantize(words, torch.ones(5), 8, 1)
    with pytest.raises(ValueError):
        mc.smear_quantize(torch.zeros((8, 8), dtype=torch.int32),
                          torch.ones(3), 8, 1)
    with pytest.raises(ValueError):
        mc.smear_quantize(torch.zeros((40, 2), dtype=torch.int32).t(),
                          torch.ones(3), 40, 1)
    grid = torch.zeros(65, dtype=torch.int8)
    d = torch.zeros((2, 4, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        mc.score_windows(grid, 8, d, torch.zeros(2, dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32), 3, 3,
                         torch.ones(4, dtype=torch.bool))
    with pytest.raises(TypeError):
        mc.score_windows(grid, 8, d.long(), torch.zeros(1, dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32), 3, 3,
                         torch.ones(4, dtype=torch.bool))


# -- on the card -------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("G,hk", [(2051, 20), (561, 1), (257, 0), (257, 40)])
def test_kernels_match_plain_on_card(cuda_device, G, hk):
    dev = cuda_device
    rng = np.random.default_rng(G)
    P = 16384
    pts = (rng.uniform(-0.2 * G, 1.2 * G, (P, 2)) * 0.01).astype(np.float32)
    pts[:50] = -1e9
    pts[50:60] = np.nan
    valid = torch.from_numpy(rng.random(P) < 0.9).to(dev)
    args = (torch.from_numpy(pts).to(dev), valid,
            torch.tensor([0.003, -0.007], device=dev), 100.0, G)
    words = mc.scatter_occupancy(*args)
    assert torch.equal(words, trz.scatter_occupancy_plain(*args))
    w = torch.from_numpy(trz.smear_weights(max(hk, 1) / 2.0, hk)).to(dev)
    grid = mc.smear_quantize(words, w, G, hk)
    assert torch.equal(grid, trz.smear_quantize_plain(words, w, G, hk))
    # the adversarial occupancy patterns of chip_smoke.py, phase 2
    from chip_smoke import check_patterns
    assert check_patterns(G, hk, w, dev)[0] == 7
    n = 81 if G < 1000 else 26
    d = torch.from_numpy(
        rng.integers(-G // 2, G // 2, (21, 1081, 2)).astype(np.int32)).to(dev)
    finite = torch.from_numpy(rng.random(1081) > 0.05).to(dev)
    for c0 in (G // 2 - n, -30, G - 40):
        c = torch.tensor([c0], dtype=torch.int32, device=dev)
        for dd, ff in ((d, finite), (d[:, :1].contiguous(), finite[:1])):
            assert torch.equal(   # B = 1081, then B = 1
                mc.score_windows(grid, G, dd, c, c, n, n, ff),
                mc.score_windows_plain(grid, G, dd, c, c, n, n, ff))
    # INT_MIN and 1 << 28 entries, no finite beam, ny != nx (chip_smoke's
    # cases, phase 2)
    from chip_smoke import check_window_cases
    assert check_window_cases(grid, G, d, finite, n, f"G={G}") == 12


@pytest.mark.cuda
def test_score_ceiling_matches_plain_and_window_kernel_on_card(cuda_device):
    """K4 at the bench geometry against its plain version and against K1
    on the table that tiles its offsets, every beam counted, at four
    origins; on 7 x 11 and 11 x 7 lattices, with 65 slots and on a grid
    that every offset misses (chip_smoke's cases, phase 2); and on
    CEILING_CASES against the numpy definition."""
    dev = cuda_device
    G, na, B, n = 2051, 21, 1081, 26
    rng = np.random.default_rng(4)
    grid = torch.from_numpy(np.concatenate([
        rng.integers(0, 101, G * G).astype(np.int8), np.zeros(1, np.int8)
    ])).to(dev)
    from chip_smoke import check_ceiling_cases
    assert check_ceiling_cases(grid, G, na, B, n) == 18
    for G, na, B, ny, nx, cx0, cy0 in CEILING_CASES.values():
        grid2d = rng.integers(0, 101, (G, G)).astype(np.int8)
        flat = torch.from_numpy(np.concatenate([
            grid2d.reshape(-1), np.zeros(1, np.int8)])).to(dev)
        got = mc.score_ceiling(
            flat, G, torch.tensor([cx0], dtype=torch.int32, device=dev),
            torch.tensor([cy0], dtype=torch.int32, device=dev),
            na, B, ny, nx)
        np.testing.assert_array_equal(
            got.cpu().numpy(), _ceiling_numpy(grid2d, cx0, cy0, na, B, ny,
                                              nx))
