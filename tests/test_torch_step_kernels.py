"""The scan step's kernels (slam_toolbox_tpu_torch/kernels/step_cuda.py:
ring_points, score_tail, stream_update, and the window sums' head form
score_windows_head) through their plain versions on the CPU, against the
JAX package's functions they stand for:

- ring_points in chain mode against JAX's chain raster
  (kernels/loop_verify.py _chain_raster) and in step mode against
  _stream_raster_impl (prior, center_off, the ring raster);
- score_windows_head against the coarse pass of JAX's _score_impl (its
  headings, and the window sums of its tables and lattice on its XLA
  gather path), with contiguous and strided local points;
- score_windows_head -> score_tail against JAX's _score_impl on its XLA
  gather path and on its Pallas path (interpret mode, as
  tests/test_match_pallas.py runs it), penalize and refine on and off,
  at a sequential and a loop geometry, with the edge cases: no finite
  beam, an all-zero raster (the cov_low and 1000 step^2 branches), ties
  over many cells, candidates outside the grid, NaN beams;
- stream_update against JAX's _stream_update_impl (its score replaced by
  the same packed rows) over a run that starts from an empty ring (the
  first scan), fills it, evicts by count and by distance and wraps the
  result ring;
- score_tail on lattices past its kernel's resident mode (21 x 200 x 200
  at 16 beams; 600 coarse headings on a 3 x 3 lattice) and past its
  streamed mode (65 fine headings; 27,009 beams on a 3 x 3 lattice at 3
  headings) against JAX's _score_impl on its XLA path;
- every wrapper given CPU tensors takes its plain version, each new
  source is in KERNELS and in the build (score_head's source is gone),
  and no wrapper falls back; score_tail's launch geometry and modes, its
  cluster check's message, and the 16-byte alignment that ring_points'
  and stream_update's kernels need.

Inputs are made from numpy with a seed (rasters, beams, poses) or are
simulated scans of one seed; both packages get the same arrays.
Tolerances: integer outputs (tables, cells, sums, validity, indices, the
raster) equal; elementwise f32 outputs within 1e-6 (f32 trig of two
libraries); the packed results within 1e-5 (mean) and step_cuda's
COV_RTOL of the covariance's scale (reordered f32 sums)."""
import functools
import inspect
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_toolbox_tpu.core.scan import LaserConfig
from slam_toolbox_tpu.io.dataset import LidarSimulator, SegmentWorld
from slam_toolbox_tpu.kernels import loop_verify as jlv
from slam_toolbox_tpu.kernels import match_pallas as mp
from slam_toolbox_tpu.kernels import rasterize as jrz
from slam_toolbox_tpu.kernels.match import Matcher as JaxMatcher
from slam_toolbox_tpu.kernels.match import _rotated_tables as jax_tables
from slam_toolbox_tpu.kernels.match import _score_impl as jax_score
from slam_toolbox_tpu.kernels.match import _score_tensor as jax_tensor
from slam_toolbox_tpu.mapper import streaming as js
from slam_toolbox_tpu_torch.kernels import match_cuda as mc
from slam_toolbox_tpu_torch.kernels import step_cuda as sc
from slam_toolbox_tpu_torch.kernels.match import Matcher as TorchMatcher
from slam_toolbox_tpu_torch.mapper import streaming as ts

CPU = torch.device("cpu")
K_RING = 8          # slots of the test ring
B_SIM = 361         # 1-degree beams


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(search, res, rth):
    return dict(
        search_size=search, resolution=res, smear_deviation=0.1,
        range_threshold=rth, coarse_angle_offset=np.deg2rad(10),
        coarse_angle_resolution=np.deg2rad(2),
        fine_angle_offset=np.deg2rad(0.2), dist_var_penalty=0.5,
        ang_var_penalty=1.0, min_dist_penalty=0.5, min_ang_penalty=0.9,
    )


# a sequential geometry (G 221, 11 x 11 lattice) and a loop one (G 141,
# 21 x 21 lattice)
GEOMETRIES = {"seq": _kw(1.0, 0.05, 5.0), "loop": _kw(4.0, 0.1, 5.0)}


@pytest.fixture(scope="module")
def matchers():
    out = {}
    for tag, kw in GEOMETRIES.items():
        jm, tm = JaxMatcher(**kw), TorchMatcher(**kw, device=CPU)
        assert jm.G == tm.G and 101 <= tm.G <= 257
        out[tag] = (jm, tm)
    return out


@pytest.fixture(scope="module")
def sim():
    """Simulated scans (361 beams, some beyond the range: NaN) at their
    true poses, and their packs."""
    laser = LaserConfig(min_range=0.05, max_range=6.0, range_threshold=5.0,
                        angular_resolution=np.deg2rad(1.0))
    s = LidarSimulator(SegmentWorld.rooms(16.0, 10.0), laser,
                       range_noise=0.01, odom_noise=(0.015, 0.006), seed=5)
    data = s.simulate(np.array([(-6.0, -3.5), (1.5, -3.5), (5.5, -3.5)]),
                      step=0.3)
    packs, poses, odoms = [], [], []
    for scan, tp in data:
        scan.set_corrected_pose(tp)
        packs.append(js.scan_pack(scan))
        poses.append(np.asarray(scan.sensor_pose, np.float32))
        odoms.append(np.asarray(scan.odom_pose, np.float32))
    packs = np.stack(packs)
    assert packs.shape[1] == B_SIM
    assert ((packs[:, :, 7].astype(np.int32) & 1) == 0).any()  # NaN beams
    return dict(laser=laser, packs=packs, poses=np.stack(poses),
                odoms=np.stack(odoms))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- K5: ring points ----------------------------------------------------------
@pytest.mark.parametrize("tag", ["seq", "loop"])
def test_ring_points_chain_mode_matches_jax_chain_raster(matchers, sim, tag):
    """A padded chain (pad slots masked, poses a strided column slice of
    a chain record): the raster of the points bit-equal to JAX's
    _chain_raster, the pad slots invalid."""
    jm, tm = matchers[tag]
    C, n = 8, 6
    rec = np.zeros((C, 5), np.float32)
    rec[:n, 1:4] = sim["poses"][2:2 + n]
    rec[:n, 4] = 1.0
    packs = np.zeros((C, B_SIM, 8), np.float32)
    packs[:, :, 6] = -1.0
    packs[:n] = sim["packs"][2:2 + n]
    vp = sim["poses"][9]
    off = (vp[:2] - np.float32(0.5 * (tm.G - 1) * tm.resolution)).astype(
        np.float32)
    chain = _t(rec)
    pts, valid = sc.ring_points(_t(packs), chain[:, 1:4], chain[:, 4] > 0,
                                _t(vp[:2]), tm.G)
    assert pts.shape == (C * B_SIM, 2) and valid.dtype == torch.bool
    assert not valid.reshape(C, B_SIM)[n:].any()
    assert valid.sum() > 500
    grid = tm._raster(pts, valid, _t(off)).numpy()
    jgrid, _ = jlv._chain_raster(
        jnp.asarray(packs), jnp.asarray(rec[:, 1:4]),
        jnp.asarray(rec[:, 4] > 0), jnp.asarray(vp[:2]), jnp.asarray(off),
        np.float32(jm.scale), np.float32(jm.sigma_cells), jm.G,
        jm.half_kernel, jm._acc_r, False)
    np.testing.assert_array_equal(grid, np.asarray(jgrid))
    # slot_valid None: every slot of a full chain
    full = sc.ring_points(_t(packs[:n]), _t(rec[:n, 1:4]), None,
                          _t(vp[:2]), tm.G)
    np.testing.assert_array_equal(full[1].numpy(),
                                  valid.reshape(C, B_SIM)[:n].reshape(-1))


def _step_state(sim, members, head, n_batch, B=B_SIM):
    """A port state whose ring holds scans `members` from slot `head` on,
    with the next n_batch scans in its batch buffers, and the same state
    in the JAX layout."""
    st = ts._new_state(K_RING, B, 8, n_batch, "cpu")
    pack = st["ring_pack"].numpy()
    for k, i in enumerate(members):
        slot = (head + k) % K_RING
        pack[slot] = sim["packs"][i]
        st["ring_pose"][slot] = _t(sim["poses"][i])
        st["ring_slot_valid"][slot] = True
    st["head"].fill_(head)
    st["count"].fill_(len(members))
    last = members[-1] if members else 0
    st["last_odom"].copy_(_t(sim["odoms"][last]))
    st["last_corrected"].copy_(_t(sim["poses"][last]))
    nxt = (members[-1] + 1) if members else 0
    st["batch_packs"][:n_batch] = _t(sim["packs"][nxt:nxt + n_batch])
    st["batch_odoms"][:n_batch] = _t(sim["odoms"][nxt:nxt + n_batch])
    return st


def _jax_layout(st):
    pack = st["ring_pack"].numpy()
    flags = pack[:, :, 7].astype(np.int32)
    out = {
        "ring_local": pack[:, :, 0:2], "ring_anchor": pack[:, :, 2:4],
        "ring_current": pack[:, :, 4:6], "ring_dvalid": (flags & 2) > 0,
        "ring_next": pack[:, :, 6].astype(np.int32),
        "ring_finite": (flags & 1) > 0,
        "ring_pose": st["ring_pose"].numpy(),
        "ring_slot_valid": st["ring_slot_valid"].numpy(),
        "head": np.int32(st["head"]), "count": np.int32(st["count"]),
        "last_odom": st["last_odom"].numpy(),
        "last_corrected": st["last_corrected"].numpy(),
        "results": st["results"].numpy(),
        "n_results": np.int32(st["ridx"]),
    }
    return {k: jnp.asarray(np.array(v)) for k, v in out.items()}


@pytest.mark.parametrize("row", [0, 3])
def test_ring_points_step_mode_matches_jax_stream_raster(matchers, sim, row):
    """The batch row at the state's step: prior and center_off within
    1e-6 of _stream_raster_impl's, the ring raster bit-equal, the scan's
    pack, odometry and finite mask written, the step left as it was."""
    jm, tm = matchers["seq"]
    st = _step_state(sim, list(range(1, 7)), 5, 4)
    st["step"].fill_(row)
    offset = np.asarray(sim["laser"].offset_pose, np.float32)
    half = ts._f32(0.5 * (tm.G - 1) * tm.resolution)
    jstate = _jax_layout(st)
    pts, valid = sc.ring_points_step(st, _t(offset), half, tm.G)
    grid = tm._raster(pts, valid, st["center_off"][3:5]).numpy()
    odom = sim["odoms"][7 + row]
    jgrid, _, jco, jprior = js._stream_raster_impl(
        jstate, jnp.asarray(odom), jnp.asarray(offset),
        np.float32(jm.scale), np.float32(jm.sigma_cells), np.float32(half),
        jm.G, jm.half_kernel, jm._acc_r, False)
    np.testing.assert_allclose(st["prior"].numpy(), np.asarray(jprior),
                               atol=1e-6)
    np.testing.assert_allclose(st["center_off"].numpy(), np.asarray(jco),
                               atol=1e-6)
    np.testing.assert_array_equal(grid, np.asarray(jgrid))
    assert (grid > 0).sum() > 500
    np.testing.assert_array_equal(st["scan_pack"].numpy(),
                                  sim["packs"][7 + row])
    np.testing.assert_array_equal(st["scan_odom"].numpy(), odom)
    np.testing.assert_array_equal(
        st["scan_finite"].numpy(),
        (sim["packs"][7 + row][:, 7].astype(np.int32) & 1) > 0)
    assert int(st["step"]) == row
    # the chain mode on the same ring from the same viewpoint
    cp, cv = sc.ring_points(st["ring_pack"], st["ring_pose"],
                            st["ring_slot_valid"], st["center_off"][:2])
    assert torch.equal(cp, pts) and torch.equal(cv, valid)


# -- K1 (head form) + K7: the score -------------------------------------------
def _raster_case(tm, sim, kind, seed):
    """(grid_flat (G*G+1,) int8, center_off (5,), local (B, 2), finite
    (B,)) of one case, as numpy arrays."""
    rng = np.random.default_rng(seed)
    G = tm.G
    q = 9
    center = sim["poses"][q].copy()
    pack = sim["packs"][q]
    local = pack[:, 0:2].copy()
    finite = (pack[:, 7].astype(np.int32) & 1) > 0
    if kind == "scans":
        st = _step_state(sim, list(range(3, 9)), 0, 1)
        off = center[:2] - np.float32(0.5 * (G - 1) * tm.resolution)
        pts, valid = sc.ring_points(st["ring_pack"], st["ring_pose"],
                                    st["ring_slot_valid"], _t(center[:2]))
        grid = tm._raster(pts, valid, _t(off.astype(np.float32))).numpy()
        center = center + np.float32([0.04, -0.03, 0.02])
    else:
        grid = np.zeros(G * G + 1, np.int8)
        if kind == "random":
            grid[:-1] = rng.integers(0, 101, G * G)
        elif kind == "ties":     # a flat plateau: many cells tie
            grid[:-1] = 50
        elif kind == "nonzero_sink":
            grid[:] = rng.integers(-20, 101, G * G + 1)
        off = center[:2] - np.float32(0.5 * (G - 1) * tm.resolution)
    if kind == "no_finite":
        finite[:] = False
    if kind == "edge":           # the lattice reaches past the grid's edge
        off = center[:2] - np.float32(0.1 * tm.resolution)
    co = np.concatenate([center, off]).astype(np.float32)
    return grid, co, local, finite


def _head(tm, grid, co, local, finite):
    """score_windows_head on numpy inputs (`local` a numpy array or a
    tensor): (raw, ang)."""
    kw = tm._score_args
    local = local if isinstance(local, torch.Tensor) else _t(local)
    return sc.score_windows_head(
        _t(grid), tm.G, _t(co), local, _t(finite), kw["x_off_c"],
        kw["y_off_c"], kw["scale"], kw["coarse_angle_offset"],
        kw["coarse_angle_res"], kw["na_coarse"])


def _port_score(tm, grid, co, local, finite, penalize, refine, aux=None):
    kw = dict(tm._score_args)
    raw, ang = _head(tm, grid, co, local, finite)
    packed = sc.score_tail(
        raw, _t(grid), _t(co), _t(local), _t(finite), ang, kw["x_off_c"],
        kw["y_off_c"], kw["x_off_f"], kw["y_off_f"], kw["scale"],
        kw["fine_angle_offset"], kw["fine_angle_res"],
        kw["coarse_angle_res"], penalize, kw["dist_var_penalty"],
        kw["ang_var_penalty"], kw["min_dist_pen"], kw["min_ang_pen"], tm.G,
        kw["na_fine"], refine, aux=aux)
    return ang, raw, packed


def _jax_coarse(jm, grid, co, local, finite):
    """The coarse pass of JAX's _score_impl on its XLA path: its headings
    ang_c and the window sums of its tables d_c and lattice (cand_x,
    cand_y), as its unpenalized responses times B * 100 (exact in f64)."""
    kw = jm._score_args
    c = jnp.asarray(co)
    scale = kw["scale"]
    ang = (c[2] - kw["coarse_angle_offset"] + kw["coarse_angle_res"]
           * jnp.arange(jm._na_coarse, dtype=jnp.float32))
    d = jax_tables(ang, jnp.asarray(local), scale)
    cand_x = jrz.round_half_away(
        (c[0] + kw["x_off_c"] - c[3]) * scale).astype(jnp.int32)
    cand_y = jrz.round_half_away(
        (c[1] + kw["y_off_c"] - c[4]) * scale).astype(jnp.int32)
    G, na = jm.G, jm._na_coarse
    resp = jax_tensor(
        jnp.asarray(grid), G, G * G, cand_x, cand_y, d, jnp.asarray(finite),
        jnp.zeros(len(cand_x), jnp.float32),
        jnp.zeros(len(cand_y), jnp.float32), jnp.zeros(na, jnp.float32),
        jnp.float32(0.0), jnp.bool_(False), jnp.float32(1.0),
        jnp.float32(1.0), jnp.float32(0.5), jnp.float32(0.9))
    B = np.asarray(local).shape[0]
    return np.asarray(ang), np.round(np.asarray(resp, np.float64)
                                     * (B * 100.0))


@pytest.mark.parametrize("tag,kind,strided", [
    ("seq", "scans", False), ("loop", "random", False),
    ("seq", "random", True), ("loop", "scans", True)])
def test_score_windows_head_matches_jax_coarse_pass(matchers, sim, tag,
                                                    kind, strided):
    """K1's head form (its plain route: score_head_plain, then
    score_windows_plain) against JAX's _score_impl coarse pass: the
    headings within 1e-6 rad, the window sums equal, on the local points
    as an array and as the strided column slice of a pack (the step's
    view); the plain head's tables equal JAX's _rotated_tables of the
    port's headings."""
    jm, tm = matchers[tag]
    grid, co, local, finite = _raster_case(tm, sim, kind, seed=5)
    view = (_t(sim["packs"][9])[:, 0:2] if strided else _t(local))
    assert view.stride(0) == (8 if strided else 2)
    assert np.array_equal(view.numpy(), local)
    raw, ang = _head(tm, grid, co, view, finite)
    jang, jraw = _jax_coarse(jm, grid, co, local, finite)
    kw = tm._score_args
    assert raw.dtype == torch.int32 and ang.dtype == torch.float32
    assert raw.shape == (tm._na_coarse, kw["y_off_c"].shape[0],
                         kw["x_off_c"].shape[0])
    np.testing.assert_allclose(ang.numpy(), jang, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(raw.numpy(), jraw)
    assert int(raw.max()) > 0
    _, d, cand0 = sc.score_head_plain(
        _t(co), view, kw["x_off_c"], kw["y_off_c"], kw["scale"],
        kw["coarse_angle_offset"], kw["coarse_angle_res"], kw["na_coarse"])
    np.testing.assert_array_equal(
        d.numpy(), np.asarray(jax_tables(jnp.asarray(ang.numpy()),
                                         jnp.asarray(local),
                                         np.float32(jm.scale))))
    cx = np.floor((co[0] + jm._xy_coarse[0] - co[3]) * jm.scale + 0.5)
    assert cand0.dtype == torch.int32 and abs(int(cand0[0]) - cx) <= 1


def _jax_score(jm, grid, co, local, finite, penalize, refine, pallas):
    args = dict(jm._score_args, penalize=np.bool_(penalize),
                grid_size=jm.G, na_coarse=jm._na_coarse,
                na_fine=jm._na_fine, acc_r=jm._acc_r, refine=refine)
    if not pallas:
        return np.asarray(jax_score(jnp.asarray(grid), None, jnp.asarray(co),
                                    jnp.asarray(local), jnp.asarray(finite),
                                    **args))
    G = jm.G
    pg = mp.prepare_parity_grid(jnp.asarray(grid[:-1].reshape(G, G)),
                                jm._acc_r)
    return np.asarray(jax_score(pg.reshape(-1), pg, jnp.asarray(co),
                                jnp.asarray(local), jnp.asarray(finite),
                                **args))


def _assert_packed(got, ref):
    """best and mean within 1e-5, the covariance within COV_RTOL of its
    scale (its largest diagonal entry)."""
    np.testing.assert_allclose(got[:4], ref[:4], atol=1e-5)
    scale = max(np.abs(ref[[4, 8, 12]]).max(), 1e-6)
    np.testing.assert_allclose(got[4:], ref[4:], rtol=0,
                               atol=sc.COV_RTOL * scale)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """JAX's window kernel in interpret mode (its _score_impl calls it
    without the flag, which on the CPU has no Mosaic to compile for)."""
    monkeypatch.setattr(mp, "score_windows",
                        functools.partial(mp.score_windows, interpret=True))


@pytest.mark.parametrize("tag,kind,penalize,refine,pallas", [
    ("seq", "scans", True, True, True),
    ("seq", "scans", False, True, False),
    ("seq", "random", True, False, True),
    ("loop", "scans", False, False, True),
    ("loop", "random", False, True, False),
])
def test_score_matches_jax_score_impl(matchers, sim, pallas_interpret, tag,
                                      kind, penalize, refine, pallas):
    """score_windows_head -> score_tail against JAX's _score_impl; the
    coarse sums equal JAX's, the packed row within the stated
    tolerances."""
    jm, tm = matchers[tag]
    grid, co, local, finite = _raster_case(tm, sim, kind, seed=1)
    ang, raw, packed = _port_score(tm, grid, co, local, finite, penalize,
                                   refine)
    assert raw.dtype == torch.int32 and int(raw.max()) > 0
    np.testing.assert_array_equal(
        raw.numpy(), _jax_coarse(jm, grid, co, local, finite)[1])
    ref = _jax_score(jm, grid, co, local, finite, penalize, refine, pallas)
    _assert_packed(packed.numpy(), ref)


@pytest.mark.parametrize("kind,tag", [
    ("no_finite", "seq"), ("zeros", "seq"), ("ties", "seq"),
    ("edge", "loop"), ("nonzero_sink", "loop"),
])
def test_score_edge_cases_match_jax(matchers, sim, kind, tag):
    """No finite beam and an all-zero raster (best 0: MAX_VARIANCE and
    var_th on the diagonal, the angular 1000 step^2), a flat raster (every
    cell ties), a lattice past the grid's edge and a raster whose sink
    cell is not 0: against JAX's XLA path, refined, penalized but on the
    flat raster (where the penalties would break the ties)."""
    jm, tm = matchers[tag]
    grid, co, local, finite = _raster_case(tm, sim, kind, seed=2)
    aux = torch.zeros(sc.aux_len(tm._na_fine))
    pen = kind != "ties"
    *_, packed = _port_score(tm, grid, co, local, finite, pen, True, aux)
    ref = _jax_score(jm, grid, co, local, finite, pen, True, False)
    _assert_packed(packed.numpy(), ref)
    got = packed.numpy()
    step = tm._score_args["fine_angle_res"]
    if kind in ("no_finite", "zeros"):
        assert got[0] == 0.0
        assert got[4] == got[8] == np.float32(500.0)
        assert got[12] == np.float32(1000.0) * np.float32(step * step)
    if kind == "ties":
        assert aux[0] > 50 and aux[5] > 3
    if kind == "edge":
        assert int(aux[10]) < 0 or int(aux[13]) < 0


def test_score_tail_aux_holds_the_plain_parts(matchers, sim):
    """The aux vector of score_tail_plain: the coarse tie count and mean
    equal to the packed row's path, and the fine parts equal to
    fine_parts_plain at that mean (what chip_smoke and the card tests
    hold the kernel's aux to)."""
    _, tm = matchers["seq"]
    grid, co, local, finite = _raster_case(tm, sim, "scans", seed=3)
    aux = torch.zeros(sc.aux_len(tm._na_fine))
    *_, packed = _port_score(tm, grid, co, local, finite, True, True, aux)
    kw = tm._score_args
    fp = sc.fine_parts_plain(
        _t(grid), tm.G, _t(co), _t(local), _t(finite), aux[2:5], aux[7:10],
        kw["x_off_f"], kw["y_off_f"], kw["scale"], kw["fine_angle_offset"],
        kw["fine_angle_res"], True,
        (kw["dist_var_penalty"], kw["ang_var_penalty"], kw["min_dist_pen"],
         kw["min_ang_pen"]), kw["na_fine"])
    again = torch.zeros_like(aux)
    again[:5] = aux[:5]
    sc.fill_aux_fine(again, fp, aux[7:10])
    assert torch.equal(again, aux)
    assert aux[6] == packed[0] and torch.equal(aux[7:10], packed[1:4])
    assert aux[0] >= 1 and aux[5] >= 1
    assert int(aux[sc.AUX_HEAD:].abs().sum()) > 0


# -- K8: the state update -----------------------------------------------------
def test_stream_update_matches_jax_over_a_run(sim, monkeypatch):
    """From an empty ring (the first scan), 14 steps with packed rows
    given to both packages: the ring fills, evicts by count (slow steps)
    and by distance (fast steps), and the 8-row result ring wraps; head,
    count, ridx and the ring's packs equal JAX's at every step, poses and
    rows within 1e-6, the step advanced once per update."""
    rbs, rmax = 5, np.float32(1.0)
    max_sq = float(rmax * rmax - np.float32(1e-6))
    st = _step_state(sim, [], 0, 1)
    jstate = _jax_layout(st)
    offset = np.asarray([0.1, -0.05, 0.02], np.float32)
    eye9 = torch.eye(3).reshape(-1)
    rng = np.random.default_rng(4)
    x, evict_count, evict_dist = 0.0, 0, 0
    for k in range(14):
        x += 0.1 if k < 8 else 0.6
        packed = np.concatenate([
            [0.5 + 0.01 * k, x, 0.2, 0.1 * k],
            rng.normal(0, 0.01, 9)]).astype(np.float32)
        co = np.float32([x - 0.05, 0.21, 0.1 * k, 0.0, 0.0])
        pack = sim["packs"][k % len(sim["packs"])]
        odom = sim["odoms"][k]
        monkeypatch.setattr(js, "_score_impl",
                            lambda *a, p=packed, **kw: jnp.asarray(p))
        jstate = js._stream_update_impl(
            None, None, jnp.asarray(co), None, jstate, jnp.asarray(pack),
            jnp.asarray(odom), jnp.asarray(offset), np.int32(rbs), rmax, {})
        count0 = int(st["count"])
        sc.stream_update(_t(packed), _t(co), _t(pack), _t(odom),
                         _t(offset), eye9, st, rbs, max_sq)
        assert int(st["step"]) == k + 1
        assert int(st["head"]) == int(jstate["head"])
        assert int(st["count"]) == int(jstate["count"])
        assert int(st["ridx"]) == int(jstate["n_results"]) % 8
        np.testing.assert_array_equal(st["ring_slot_valid"].numpy(),
                                      np.asarray(jstate["ring_slot_valid"]))
        np.testing.assert_array_equal(st["ring_pack"][:, :, 0:2].numpy(),
                                      np.asarray(jstate["ring_local"]))
        np.testing.assert_allclose(st["ring_pose"].numpy(),
                                   np.asarray(jstate["ring_pose"]), atol=1e-6)
        np.testing.assert_allclose(st["results"].numpy(),
                                   np.asarray(jstate["results"]), atol=1e-6)
        np.testing.assert_allclose(st["last_corrected"].numpy(),
                                   np.asarray(jstate["last_corrected"]),
                                   atol=1e-6)
        np.testing.assert_array_equal(st["last_odom"].numpy(), odom)
        if k == 0:      # the first scan: the center, response 0, identity
            row = st["results"][0].numpy()
            assert row[0] == 0.0 and np.array_equal(row[1:4], co[:3])
            assert np.array_equal(row[4:], np.eye(3).reshape(-1))
        dropped = count0 + 1 - int(st["count"])
        if dropped and count0 + 1 > rbs:
            evict_count += 1
        elif dropped:
            evict_dist += 1
    assert evict_count >= 1 and evict_dist >= 1
    assert int(st["ridx"]) == 14 % 8


# -- the wrappers ---------------------------------------------------------------
NEW = ("ring_points", "score_tail", "stream_update")


def test_new_sources_are_kernels_and_built(tmp_path, monkeypatch):
    """The step's sources are in KERNELS, their launch counts start at 0,
    and build_kernels compiles each (a stub compiler records the
    sources) with the port's flags; score_head's source, folded into
    score_windows.cu, is gone from KERNELS and from csrc/."""
    assert set(NEW) <= set(mc.KERNELS)
    assert all(name in mc.LAUNCHES for name in NEW)
    assert "score_head" not in mc.KERNELS and "score_head" not in mc.LAUNCHES
    assert not os.path.exists(mc._source("score_head"))
    assert not hasattr(sc, "score_head")
    seen = []

    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **kw):
            seen.append(cmd)
            open(cmd[cmd.index("-o") + 1], "w").close()

        def communicate(self):
            return "", None

    monkeypatch.setattr(mc, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(mc.subprocess, "Popen", FakeProc)
    mc.build_kernels(force=True)
    srcs = {cmd[-1] for cmd in seen}
    for name in NEW:
        assert mc._source(name) in srcs
        assert (tmp_path / f"lib{name}.so").exists()
    assert all("--fmad=false" in cmd and "arch=compute_90a,code=sm_90a" in
               cmd for cmd in seen)


def test_wrappers_on_cpu_take_the_plain_versions(sim, matchers, monkeypatch):
    """Given CPU tensors every wrapper runs its plain version, loads no
    library and counts no launch."""
    def no_lib(name):
        raise AssertionError(f"{name}: a library was loaded for CPU tensors")

    monkeypatch.setattr(mc, "_lib", no_lib)
    mc.reset_launch_counts()
    calls = []
    for name in ("ring_points_plain", "ring_points_step_plain",
                 "score_windows_head_plain", "score_head_plain",
                 "score_tail_plain", "stream_update_plain"):
        real = getattr(sc, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(sc, name, spy)
    _, tm = matchers["seq"]
    st = _step_state(sim, [1, 2, 3], 0, 2)
    offset = torch.zeros(3)
    half = ts._f32(0.5 * (tm.G - 1) * tm.resolution)
    ts._stream_step(st, tm, offset, half, 10, 9.0,
                    dict(tm._score_args, penalize=True, refine=True),
                    torch.eye(3).reshape(-1))
    sc.ring_points(st["ring_pack"], st["ring_pose"], None,
                   st["center_off"][:2])
    # (the step mode's plain version forms its points with the chain's)
    assert calls == ["ring_points_step_plain", "ring_points_plain",
                     "score_windows_head_plain", "score_head_plain",
                     "score_tail_plain", "stream_update_plain",
                     "ring_points_plain"]
    assert not any(mc.LAUNCHES.values())


def test_wrappers_hold_no_fallback(sim, monkeypatch):
    """No wrapper catches a failure or asks whether a card is present: on
    a CUDA tensor a wrapper launches or raises (here the build fails),
    and a tensor on any other device raises."""
    for fn in (sc.ring_points, sc.ring_points_step, sc.score_windows_head,
               sc.score_tail, sc.stream_update, sc._launch_ring_points,
               sc._launch_score_tail, sc.score_tail_launch,
               sc.tail_clusters, sc._launch_stream_update,
               sc.ring_scratch_bytes, mc.smear_scratch_bytes):
        src = inspect.getsource(fn)
        assert "try:" not in src and "except" not in src
        assert "is_available" not in src
    assert "is_available" not in inspect.getsource(sc)

    def failed_build(name):
        raise RuntimeError(f"nvcc failed for {name}")

    monkeypatch.setattr(mc, "_lib", failed_build)
    monkeypatch.setattr(mc, "_on_cuda", lambda dev: True)
    st = _step_state(sim, [1, 2], 0, 1)
    with pytest.raises(RuntimeError, match="ring_points"):
        sc.ring_points_step(st, torch.zeros(3), 1.0)
    with pytest.raises(RuntimeError, match="stream_update"):
        sc.stream_update(torch.zeros(13), torch.zeros(5),
                         torch.zeros(B_SIM, 8), torch.zeros(3),
                         torch.zeros(3), torch.eye(3).reshape(-1), st, 5, 1.0)

    def head(dev):
        z = functools.partial(torch.zeros, device=dev)
        return sc.score_windows_head(
            z(10, dtype=torch.int8), 3, z(5), z(4, 2), z(4, dtype=torch.bool),
            z(3), z(3), 1.0, 0.1, 0.1, 3)

    with pytest.raises(RuntimeError, match="score_windows"):
        head("cpu")
    monkeypatch.undo()
    with pytest.raises(ValueError, match="device"):
        head("meta")


# -- score_tail's launch geometry --------------------------------------------
def _align_matcher():
    """The matcher api/merge.py auto_align builds, at its defaults."""
    return TorchMatcher(
        search_size=8.0, resolution=0.05, smear_deviation=0.03,
        range_threshold=10.0, coarse_angle_offset=np.deg2rad(20.0),
        coarse_angle_resolution=np.deg2rad(2.0),
        fine_angle_offset=np.deg2rad(0.2), dist_var_penalty=0.09,
        ang_var_penalty=0.1218, min_dist_penalty=0.5, min_ang_penalty=0.9,
        device=CPU)


def _port_geometry(tag):
    """(na, ny, nx, B, na_fine) of a matcher the port runs: bench.py's
    sequential (26 x 26) and loop (81 x 81) matchers at 1,081 beams, the
    CLI's (ONLINE_SYNC) at the CARMEN fixture's 271 beams, auto_align's."""
    import chip_smoke as cs
    from slam_toolbox_tpu_torch.core.params import ONLINE_SYNC
    from slam_toolbox_tpu_torch.mapper import Mapper

    if tag.startswith("bench"):
        cfg, laser, _ = cs.bench_workload(0)
        B, rth = laser.n_beams, laser.range_threshold
    elif tag.startswith("cli"):
        cfg, B, rth = ONLINE_SYNC, 271, 80.0
    if tag == "align":   # on bench.py's laser, as chip_smoke's merge
        m, B = _align_matcher(), cs.bench_workload(0)[1].n_beams
    else:
        mapper = Mapper(cfg, device=CPU)
        mapper.initialize(rth)
        m = (mapper.sequential_matcher if tag.endswith("seq")
             else mapper.loop_matcher)
    n = len(m._xy_coarse)
    return m._na_coarse, n, n, B, m._na_fine


def _wide_loop_geometry():
    """bench.py's loop matcher with a 20 m loop search at its 0.05 m (a
    201 x 201 lattice) and 1,081 beams."""
    import dataclasses

    import chip_smoke as cs
    from slam_toolbox_tpu_torch.mapper import Mapper

    cfg, laser, _ = cs.bench_workload(0)
    cfg = dataclasses.replace(cfg, loop_search_space_dimension=20.0)
    mapper = Mapper(cfg, device=CPU)
    mapper.initialize(laser.range_threshold)
    m = mapper.loop_matcher
    n = len(m._xy_coarse)
    return m._na_coarse, n, n, laser.n_beams, m._na_fine


@pytest.mark.parametrize("tag,lattice", [
    ("bench seq", 26), ("bench loop", 81), ("cli seq", 26),
    ("cli loop", 81), ("align", 81), ("bench loop 20 m", 201),
    ("200 x 200, 16 beams", 200)])
def test_score_tail_launch_fits_every_port_geometry(tag, lattice):
    """Every geometry the port runs at its defaults takes one cluster of
    2-16 CTAs of at most 1,024 threads in the resident mode: its dynamic
    shared memory (the coarse responses and cell maxima of a CTA's cells,
    the beams) and static part fit 227 KB a CTA. A 20 m loop search
    (201 x 201) and the CPU test's 200 x 200 lattice at 16 beams do not
    fit and take the streamed mode, whose dynamic part is the beams."""
    if tag == "bench loop 20 m":
        na, ny, nx, B, naf = _wide_loop_geometry()
    elif tag.startswith("200"):
        na, ny, nx, B, naf = 21, 200, 200, 16, 11
    else:
        na, ny, nx, B, naf = _port_geometry(tag)
    assert (ny, nx, na, naf) == (lattice, lattice, 21, 11)
    cluster, threads, smem, mode = sc.score_tail_launch(na, ny, nx, B, naf)
    assert 1 < cluster <= sc.TAIL_MAX_CLUSTER
    assert 32 <= threads <= sc.TAIL_MAX_THREADS and threads % 32 == 0
    per_cta = -(-(ny * nx) // cluster)
    resident = sc.score_tail_smem(na, ny, nx, B, cluster)
    assert resident == 4 * (na + 1) * per_cta + 8 * B
    if lattice <= 81:
        assert mode == sc.TAIL_RESIDENT and smem == resident
    else:
        assert resident > sc.TAIL_ROOM
        assert mode == sc.TAIL_STREAMED and smem == 8 * B == (
            sc.score_tail_smem(na, ny, nx, B, cluster, sc.TAIL_STREAMED))
    assert smem + sc.TAIL_STATIC_SMEM <= sc.TAIL_SMEM_PER_CTA == 232448


def _tail_inputs(na, ny, nx, B=16, G=9):
    """score_tail's arguments on the CPU at an (na, ny, nx) lattice."""
    kw = dict(
        scale=10.0, fine_angle_offset=0.01, fine_angle_res=0.002,
        coarse_angle_res=0.02, penalize=True, dist_var_penalty=0.5,
        ang_var_penalty=1.0, min_dist_pen=0.5, min_ang_pen=0.9)
    return (
        torch.zeros((na, ny, nx), dtype=torch.int32),
        torch.zeros(G * G + 1, dtype=torch.int8), torch.zeros(5),
        torch.zeros((B, 2)), torch.ones(B, dtype=torch.bool),
        torch.zeros(na), torch.arange(nx, dtype=torch.float32),
        torch.arange(ny, dtype=torch.float32), torch.zeros(3),
        torch.zeros(3), kw["scale"], kw["fine_angle_offset"],
        kw["fine_angle_res"], kw["coarse_angle_res"], kw["penalize"],
        kw["dist_var_penalty"], kw["ang_var_penalty"], kw["min_dist_pen"],
        kw["min_ang_pen"], G)


@pytest.mark.parametrize("what,na,ny,nx,B,na_fine,mode", [
    ("headings", sc.TAIL_MAX_HEADINGS + 1, 3, 3, 16, 11, sc.TAIL_STREAMED),
    ("fine headings", 21, 3, 3, 16, sc.TAIL_MAX_FINE + 1, sc.TAIL_WIDE),
    ("lattice", 1, 700, 700, 16, 11, sc.TAIL_STREAMED),
    ("beams", 21, 3, 3, sc.TAIL_ROOM // 8 + 1, 11, sc.TAIL_WIDE)])
def test_score_tail_raises_where_its_kernel_cannot(what, na, ny, nx, B,
                                                   na_fine, mode):
    """No geometry of a match makes the wrapper or the launch geometry
    raise, on the CPU or for a card: above kMaxHeadings coarse headings
    and on a lattice whose responses do not fit 16 CTAs' shared memory
    the kernel takes its streamed mode; above kMaxFine fine headings and
    for beams whose 8 bytes each pass a CTA's room (about 27,000) its
    wide mode, with no dynamic shared memory. On the CPU the wrapper
    computes each (its plain version, never consulting the launch
    geometry). One heading, fine heading or beam fewer, or a lattice that
    fits, takes the mode before. Only arguments no match has raise: no
    heading, no fine heading, no beam."""
    geometry = sc.score_tail_launch(na, ny, nx, B, na_fine)
    assert geometry[3] == mode
    assert geometry[2] == sc.score_tail_smem(na, ny, nx, B, geometry[0],
                                             mode)
    assert (geometry[2] == 0) == (mode == sc.TAIL_WIDE)
    out = sc.score_tail(*_tail_inputs(na, ny, nx, B), na_fine, True)
    assert out.shape == (13,) and bool(torch.isfinite(out).all())
    before = {"headings": ((na - 1, ny, nx, B, na_fine), sc.TAIL_RESIDENT),
              "lattice": ((na, 600, 600, B, na_fine), sc.TAIL_RESIDENT),
              "fine headings": ((na, ny, nx, B, na_fine - 1),
                                sc.TAIL_RESIDENT),
              "beams": ((na, ny, nx, B - 1, na_fine), sc.TAIL_STREAMED)}
    shape, prev = before[what]
    assert sc.score_tail_launch(*shape)[3] == prev
    for bad in ((0, ny, nx, B, na_fine), (na, ny, nx, B, 0),
                (na, ny, nx, 0, na_fine)):
        with pytest.raises(ValueError, match="score_tail"):
            sc.score_tail_launch(*bad)


# -- score_tail past its resident mode, against JAX ---------------------------
def _streamed_kw(what):
    """Matcher arguments whose match passes the kernel's resident mode:
    a 200 x 200 lattice at 21 headings (0.1 m cells, a 39.8 m search, G
    409), or 600 headings (a 2.995 rad offset at 0.01 rad) on a 3 x 3
    lattice (G 15); or its streamed mode: 65 fine headings (a 0.064 rad
    coarse step over 0.001 rad) on a 3 x 3 lattice at 3 headings, or
    that lattice at 3 headings and 7 fine headings, given 27,009 beams."""
    if what == "lattice":
        kw = _kw(39.8, 0.1, 0.5)
        kw.update(coarse_angle_resolution=np.deg2rad(1.0))
        return kw
    kw = _kw(0.4, 0.1, 0.5)
    if what == "headings":
        kw.update(coarse_angle_offset=2.995, coarse_angle_resolution=0.01,
                  fine_angle_offset=0.001)
    elif what == "fine headings":
        kw.update(coarse_angle_offset=0.064, coarse_angle_resolution=0.064,
                  fine_angle_offset=0.001)
    else:
        kw.update(coarse_angle_offset=0.02, coarse_angle_resolution=0.02)
    return kw


@pytest.mark.parametrize("what,lattice,na,na_fine,B,mode", [
    ("lattice", 200, 21, 6, 16, sc.TAIL_STREAMED),
    ("headings", 3, 600, 11, 16, sc.TAIL_STREAMED),
    ("fine headings", 3, 3, 65, 16, sc.TAIL_WIDE),
    ("beams", 3, 3, 7, sc.TAIL_ROOM // 8 + 1, sc.TAIL_WIDE)])
def test_score_tail_streamed_geometry_matches_jax(what, lattice, na, na_fine,
                                                  B, mode):
    """score_windows_head -> score_tail where the kernel takes its streamed
    mode (a 200 x 200 lattice, 600 coarse headings) or its wide mode (65
    fine headings; 27,009 beams), on a random raster, penalized and
    refined, against JAX's _score_impl on its XLA path, with
    test_score_matches_jax_score_impl's tolerances. B is 16 but where the
    beams are the point (it keeps both sides' gathers, 21 x 40,000 x 16,
    within a worker's time and memory)."""
    kw = _streamed_kw(what)
    jm, tm = JaxMatcher(**kw), TorchMatcher(**kw, device=CPU)
    n = len(tm._xy_coarse)
    assert (n, tm._na_coarse, tm._na_fine) == (lattice, na, na_fine) == (
        len(jm._xy_coarse), jm._na_coarse, jm._na_fine)
    rng = np.random.default_rng(11)
    G = tm.G
    assert G == jm.G and G <= 409
    grid = np.zeros(G * G + 1, np.int8)
    grid[:-1] = rng.integers(0, 101, G * G)
    local = rng.uniform(-2.0, 2.0, (B, 2)).astype(np.float32)
    finite = np.ones(B, bool)
    finite[3] = False
    center = np.float32([0.3, -0.2, 0.1])
    off = center[:2] - np.float32(0.5 * (G - 1) * tm.resolution)
    co = np.concatenate([center, off]).astype(np.float32)
    geometry = sc.score_tail_launch(na, n, n, B, tm._na_fine)
    assert geometry[3] == mode
    _, raw, packed = _port_score(tm, grid, co, local, finite, True, True)
    assert int(raw.max()) > 0
    ref = _jax_score(jm, grid, co, local, finite, True, True, False)
    _assert_packed(packed.numpy(), ref)


# -- the checks before a launch ----------------------------------------------
def test_score_tail_cluster_check_names_the_card(monkeypatch):
    """Where the CUDA runtime reports no active cluster for a launch
    geometry (cudaOccupancyMaxActiveClusters 0, as on a card or partition
    that cannot schedule 16 CTAs in a cluster), the launch raises a
    RuntimeError naming the card and the cluster's shape before the
    kernel is called; a failed query raises the same way."""
    class StubLib:
        def __init__(self, err):
            self.err, self.launched = err, 0

        def score_tail_clusters(self, ctas, threads, smem, mode, count):
            assert (ctas, threads, mode) == (16, 512, sc.TAIL_RESIDENT)
            count[0] = 0
            return self.err

        def score_tail(self, *a):
            self.launched += 1
            return 0

    monkeypatch.setattr(sc, "_TAIL_CLUSTERS", {})
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "Stub Hopper (MIG 1g.10gb)")
    na, n, B, naf = 21, 81, 1081, 11
    args = _tail_inputs(na, n, n, B) + (naf, True)
    geometry = sc.score_tail_launch(na, n, n, B, naf)
    for err in (0, 801):
        lib = StubLib(err)
        with pytest.raises(RuntimeError) as info:
            sc._launch_score_tail(args, None, geometry, lib)
        msg = str(info.value)
        assert "Stub Hopper (MIG 1g.10gb)" in msg
        assert f"16 CTAs x 512 threads with {geometry[2]}" in msg
        assert "resident mode" in msg and f"cudaError {err}" in msg
        assert lib.launched == 0 and not sc._TAIL_CLUSTERS


@pytest.mark.parametrize("kernel", ["stream_update pack",
                                    "stream_update ring_pack",
                                    "ring_points packs",
                                    "ring_points_step batch_packs"])
def test_pack_kernels_raise_on_a_misaligned_pack(sim, kernel):
    """stream_update's and ring_points' kernels move packs as 16-byte
    vectors: a pack buffer that starts off a 16-byte boundary (here 4
    bytes past one) raises ValueError at the launch, before the kernel's
    library is loaded. On the CPU the wrapper takes its plain version,
    which needs no alignment: it gives what it gives on aligned copies."""
    def shifted(t):
        out = torch.zeros(t.numel() + 1)[1:].view(*t.shape)
        assert out.data_ptr() % 16
        return out.copy_(t)

    def state():
        return _step_state(sim, [1, 2], 0, 2)

    if kernel.startswith("stream_update"):
        args = (torch.zeros(13), torch.zeros(5), None, torch.zeros(3),
                torch.zeros(3))
        runs = []
        for misaligned in (False, True):
            st = state()
            pack = st["scan_pack"].clone()
            if misaligned and kernel.endswith(" pack"):
                pack = shifted(pack)
            elif misaligned:
                st["ring_pack"] = shifted(st["ring_pack"])
            sc.stream_update(*args[:2], pack, *args[3:],
                             torch.eye(3).reshape(-1), st, 5, 1.0)
            runs.append(st)
        for k in sc.UPDATE_STATE:
            assert torch.equal(runs[0][k], runs[1][k]), k
        with pytest.raises(ValueError, match="16-byte"):
            sc._launch_stream_update(*args[:2], pack, *args[3:], st, 5, 1.0)
    elif kernel == "ring_points packs":
        st = state()
        view = (st["ring_pose"], None, torch.zeros(2))
        packs = shifted(st["ring_pack"])
        for a, b in zip(sc.ring_points(st["ring_pack"], *view),
                        sc.ring_points(packs, *view)):
            assert torch.equal(a, b)
        with pytest.raises(ValueError, match="16-byte"):
            sc._launch_ring_points(packs, *view, 0)
    else:
        runs = []
        for misaligned in (False, True):
            st = state()
            if misaligned:
                st["batch_packs"] = shifted(st["batch_packs"])
            runs.append((sc.ring_points_step(st, torch.zeros(3), 1.0), st))
        for a, b in zip(runs[0][0], runs[1][0]):
            assert torch.equal(a, b)
        for k in sc.STEP_OUTPUTS:
            assert torch.equal(runs[0][1][k], runs[1][1][k]), k
        step = {k: st[k] for k in sc.STEP_INPUTS + sc.STEP_OUTPUTS}
        step.update(offset_pose=torch.zeros(3), half_span=1.0)
        with pytest.raises(ValueError, match="16-byte"):
            sc._launch_ring_points(st["ring_pack"], st["ring_pose"],
                                   st["ring_slot_valid"], None, 0, step)
