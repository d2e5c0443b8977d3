"""The port's occupancy renderer (kernels/occupancy.py) and the session's
grid cache against the JAX package on the CPU: the same seeded beams and
posed scans through both, pass and hit counters and cell states bit for
bit, on the native host route and on the tensor route."""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_toolbox_tpu.api import SlamSession as JaxSession
from slam_toolbox_tpu.core.params import MapperConfig as JaxConfig
from slam_toolbox_tpu.core.scan import LaserConfig as JaxLaser
from slam_toolbox_tpu.core.scan import LocalizedScan as JaxScan
from slam_toolbox_tpu.io.dataset import LidarSimulator, SegmentWorld
from slam_toolbox_tpu.kernels import occupancy as jocc
from slam_toolbox_tpu_torch.api import SlamSession
from slam_toolbox_tpu_torch.core.scan import LocalizedScan
from slam_toolbox_tpu_torch.interop import config_from_dict, laser_from_dict
from slam_toolbox_tpu_torch.kernels import occupancy as occ

torch.set_num_threads(1)

ROUTES = ("native", "tensor")


def pin_route(monkeypatch, native: bool):
    """Send every render through one route: the native host Bresenham
    (native=True) or trace_beams, here on the CPU."""
    for name in ("create_from_scans", "add_scans_incremental"):
        monkeypatch.setattr(occ, name, functools.partial(
            getattr(occ, name), native=native))


@pytest.fixture
def route(request, monkeypatch):
    pin_route(monkeypatch, request.param == "native")
    return request.param


def _posed_scans(n=24, seed=5, world=None, range_noise=0.01, poses=None):
    """n posed scans in both packages from one seeded simulator: random
    poses in a rooms world, some beams past the range threshold (clamped,
    no hit) and past the maximum range (no return)."""
    laser = JaxLaser(min_range=0.05, max_range=6.0, range_threshold=4.0,
                     angular_resolution=np.deg2rad(1.0))
    sim = LidarSimulator(world or SegmentWorld.rooms(16.0, 10.0), laser,
                         range_noise=range_noise, seed=seed)
    rng = np.random.default_rng(seed)
    tlaser = laser_from_dict(dataclasses.asdict(laser))
    jax_scans, port_scans = [], []
    if poses is None:
        poses = [(rng.uniform(-6, 6), rng.uniform(-4, 4),
                  rng.uniform(-np.pi, np.pi)) for _ in range(n)]
    for pose in poses:
        pose = np.asarray(pose, np.float64)
        r = sim.scan_at(pose)
        jax_scans.append(JaxScan(laser, r, pose))
        port_scans.append(LocalizedScan(tlaser, r, pose))
    return jax_scans, port_scans


def _assert_grid_equal(got, ref):
    np.testing.assert_array_equal(got.pass_cnt, np.asarray(ref.pass_cnt))
    np.testing.assert_array_equal(got.hit_cnt, np.asarray(ref.hit_cnt))
    np.testing.assert_array_equal(got.cells, np.asarray(ref.cells))
    np.testing.assert_array_equal(got.offset, ref.offset)
    assert got.resolution == ref.resolution
    assert isinstance(got.cells, np.ndarray) and got.cells.dtype == np.uint8
    assert isinstance(got.pass_cnt, np.ndarray)


def _random_beams(n, W, H, seed):
    """Random cells around a W x H grid, with steep, flipped, vertical,
    horizontal, zero-length and off-grid beams, a saturated int32 cell on
    an invalid beam, and random beam and endpoint validity."""
    rng = np.random.default_rng(seed)
    st = rng.integers(-25, max(W, H) + 25, size=(n, 2)).astype(np.int32)
    en = rng.integers(-25, max(W, H) + 25, size=(n, 2)).astype(np.int32)
    en[:10] = st[:10]                    # zero length
    en[10:20, 0] = st[10:20, 0]          # vertical (steep)
    en[20:30, 1] = st[20:30, 1]          # horizontal
    en[30:40] = st[30:40] + [[3, 40]]    # steep, going up
    en[40:50] = st[40:50] - [[40, 3]]    # flipped (x decreasing)
    bv = rng.random(n) < 0.9
    ev = rng.random(n) < 0.7
    st[50] = [np.iinfo(np.int32).min, 5]
    bv[50] = False
    return st, en, bv, ev


@pytest.mark.parametrize("W,H,max_steps", [(64, 50, 128), (37, 90, 64)])
def test_trace_beams_matches_jax(W, H, max_steps):
    st, en, bv, ev = _random_beams(400, W, H, seed=W)
    rng = np.random.default_rng(1)
    p0 = rng.integers(0, 5, (H, W)).astype(np.int32)
    h0 = rng.integers(0, 3, (H, W)).astype(np.int32)
    pj, hj = jocc.trace_beams(
        jnp.asarray(p0), jnp.asarray(h0), jnp.asarray(st), jnp.asarray(en),
        jnp.asarray(bv), jnp.asarray(ev), W, H, max_steps)
    pt, ht = occ.trace_beams(
        torch.from_numpy(p0), torch.from_numpy(h0), torch.from_numpy(st),
        torch.from_numpy(en), torch.from_numpy(bv), torch.from_numpy(ev),
        W, H, max_steps)
    assert pt.dtype == torch.int32 and pt.shape == (H, W)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    assert pt.numpy().sum() > p0.sum()


@pytest.mark.parametrize("threshold", [0.1, 0.3, 0.65, 1.0 / 3.0])
def test_update_cells_matches_jax(threshold):
    """Random counters plus every hit/pass ratio near the threshold
    (hit k of pass 10k and its neighbours), where the f32 ratio decides."""
    rng = np.random.default_rng(7)
    p = rng.integers(0, 40, 2000)
    h = np.minimum(rng.integers(0, 10, 2000), p)
    edge_p, edge_h = [], []
    for pas in range(1, 200):
        for hit in {int(threshold * pas) + d for d in (-1, 0, 1)}:
            if 0 <= hit <= pas:
                edge_p.append(pas)
                edge_h.append(hit)
    p = np.concatenate([p, edge_p]).astype(np.int32).reshape(1, -1)
    h = np.concatenate([h, edge_h]).astype(np.int32).reshape(1, -1)
    for mpt in (0, 2):
        ref = jocc.update_cells(jnp.asarray(p), jnp.asarray(h),
                                jnp.int32(mpt), jnp.float32(threshold))
        got = occ.update_cells(torch.from_numpy(p), torch.from_numpy(h),
                               mpt, threshold)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the case the f32 comparison decides: hit 1 of pass 10 at 0.1
    one = occ.update_cells(torch.tensor([[10]], dtype=torch.int32),
                           torch.tensor([[1]], dtype=torch.int32), 2, 0.1)
    assert int(one) == occ.FREE


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("resolution", [0.05, 0.1])
def test_create_from_scans_matches_jax(route, resolution):
    jax_scans, port_scans = _posed_scans()
    ref = jocc.create_from_scans(jax_scans, resolution)
    got = occ.create_from_scans(port_scans, resolution, device="cpu",
                                chunk=8)
    _assert_grid_equal(got, ref)
    counts = np.bincount(got.cells.ravel(), minlength=256)
    assert counts[occ.FREE] > 1000 and counts[occ.OCCUPIED] > 100


def test_native_and_tensor_routes_agree_with_several_chunks():
    _, port_scans = _posed_scans(n=20, seed=9)
    grids = {}
    for native in (True, False):
        grids[native] = occ.create_from_scans(port_scans, 0.05, chunk=6,
                                              device="cpu", native=native)
    _assert_grid_equal(grids[False], grids[True])


@pytest.mark.parametrize("device,native,loads,want", [
    ("cpu", None, True, True), ("cpu", None, False, False),
    ("cuda", None, True, False), ("cpu", False, True, False),
    ("cuda", True, True, True),
])
def test_route_follows_the_device(monkeypatch, device, native, loads, want):
    """The native library renders for the CPU while it loads, trace_beams
    for a card; an explicit `native` overrides either."""
    from slam_toolbox_tpu_torch import native as lib_mod

    lib = type("Lib", (), {"occupancy_raster": None})() if loads else None
    monkeypatch.setattr(lib_mod, "get_lib", lambda: lib)
    assert occ._use_native(torch.device(device), native) is want


def test_native_route_raises_without_the_library(monkeypatch):
    from slam_toolbox_tpu_torch import native as lib_mod

    monkeypatch.setattr(lib_mod, "get_lib", lambda: None)
    with pytest.raises(RuntimeError, match="native occupancy"):
        occ._use_native(torch.device("cpu"), True)


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_incremental_equals_full_rebuild(route):
    jax_scans, port_scans = _posed_scans(n=12, seed=3)
    full = occ.create_from_scans(port_scans, 0.1, min_pass_through=1,
                                 device="cpu")
    base = occ.OccupancyGrid(
        np.zeros_like(full.cells), full.offset, full.resolution,
        pass_cnt=np.zeros_like(full.pass_cnt),
        hit_cnt=np.zeros_like(full.hit_cnt),
    )
    inc = occ.add_scans_incremental(base, port_scans[:5], min_pass_through=1,
                                    device="cpu")
    inc = occ.add_scans_incremental(inc, port_scans[5:], min_pass_through=1,
                                    device="cpu")
    _assert_grid_equal(inc, full)
    jbase = jocc.OccupancyGrid(
        np.zeros_like(full.cells), full.offset, full.resolution,
        pass_cnt=np.zeros_like(full.pass_cnt),
        hit_cnt=np.zeros_like(full.hit_cnt),
    )
    jinc = jocc.add_scans_incremental(jbase, jax_scans[:5],
                                      min_pass_through=1)
    jinc = jocc.add_scans_incremental(jinc, jax_scans[5:], min_pass_through=1)
    _assert_grid_equal(inc, jinc)


def test_ray_cast_matches_jax():
    jax_scans, port_scans = _posed_scans(
        seed=1, world=SegmentWorld.box(4.0), range_noise=0.0,
        poses=[(-2, 0, 0.0), (2, 0, np.pi), (0, 0, 1.0)])
    ref = jocc.create_from_scans(jax_scans, 0.1, min_pass_through=1)
    got = occ.create_from_scans(port_scans, 0.1, min_pass_through=1,
                                device="cpu")
    rng = np.random.default_rng(2)
    for _ in range(20):
        pose = np.array([rng.uniform(-2, 2), rng.uniform(-2, 2),
                         rng.uniform(-np.pi, np.pi)])
        assert got.ray_cast(pose, 8.0) == ref.ray_cast(pose, 8.0)
        xy = rng.uniform(-5, 5, size=(7, 2))
        np.testing.assert_array_equal(got.world_to_grid(xy),
                                      ref.world_to_grid(xy))
    d = got.ray_cast(np.array([0.0, 0.0, 0.0]), 8.0)
    assert 3.4 < d < 4.4


def test_cuda_tensor_route_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, port_scans = _posed_scans(n=2)
    with pytest.raises(RuntimeError):
        occ.create_from_scans(port_scans, 0.1, device="cuda")
    with pytest.raises(RuntimeError):
        occ.create_from_scans(port_scans, 0.1)


# -- the session's grid cache (tests/test_occupancy_cache.py on the port) --

LASER91 = dict(beam_count=91, min_angle=-np.pi / 2, max_angle=np.pi / 2,
               min_range=0.05, max_range=12.0, range_threshold=10.0,
               is_360=False)
CFG_UNMATCHED = dict(use_scan_matching=False, minimum_travel_distance=0.0,
                     minimum_time_interval=0.0)


def _make_ranges(i, r=5.0):
    # deterministic: varying the base range controls the scan bbox
    return np.full(91, r) + 0.2 * np.sin(np.linspace(0, 3, 91) + 0.1 * i)


@pytest.fixture
def sess():
    return SlamSession(config_from_dict(CFG_UNMATCHED),
                       laser_from_dict(LASER91), device="cpu")


def _count_calls(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(module, name, spy)
    return calls


def _full(sess, **kw):
    return occ.create_from_scans(
        sess.mapper.all_processed_scans(), sess.config.map_resolution,
        sess.config.min_pass_through, sess.config.occupancy_threshold,
        device="cpu", **kw)


def test_steady_state_publish_is_incremental(sess, monkeypatch):
    for i, x in enumerate(np.linspace(-3.0, 3.0, 8)):
        sess.process_scan(_make_ranges(i), [x, 0.0, 0.0], time=i)
    sess.get_occupancy_grid()
    inc_calls = _count_calls(monkeypatch, occ, "add_scans_incremental")
    full_calls = _count_calls(monkeypatch, occ, "create_from_scans")
    for i, x in enumerate(np.linspace(-1.0, 1.0, 4)):
        sess.process_scan(_make_ranges(10 + i, r=3.0), [x, 0.0, 0.0],
                          time=10 + i)
    g2 = sess.get_occupancy_grid()
    assert len(inc_calls) == 1 and len(full_calls) == 0
    _assert_grid_equal(g2, _full(sess))
    g3 = sess.get_occupancy_grid()
    assert g3 is g2
    assert len(inc_calls) == 1 and len(full_calls) == 1  # the _full call


def test_extent_growth_forces_full_rebuild(sess, monkeypatch):
    for i, x in enumerate(np.linspace(-1.0, 1.0, 4)):
        sess.process_scan(_make_ranges(i), [x, 0.0, 0.0], time=i)
    sess.get_occupancy_grid()
    full_calls = _count_calls(monkeypatch, occ, "create_from_scans")
    sess.process_scan(_make_ranges(9), [15.0, 0.0, 0.0], time=9)
    g = sess.get_occupancy_grid()
    assert len(full_calls) == 1
    np.testing.assert_array_equal(g.cells, _full(sess).cells)


def test_pose_revision_and_resolution_invalidate(sess, monkeypatch):
    for i, x in enumerate(np.linspace(-1.0, 1.0, 6)):
        sess.process_scan(_make_ranges(i), [x, 0.0, 0.0], time=i)
    sess.get_occupancy_grid()
    full_calls = _count_calls(monkeypatch, occ, "create_from_scans")
    sess.mapper.graph.pose_revision += 1
    sess.get_occupancy_grid()
    assert len(full_calls) == 1
    sess.get_occupancy_grid(resolution=0.1)
    assert len(full_calls) == 2
    sess.get_occupancy_grid(resolution=0.1)
    assert len(full_calls) == 2


def test_reset_drops_the_cached_grid(sess):
    """After reset() the unique ids restart at 0, so a cache keyed on the
    scan count and the last uid would fold the new session's scans into
    the old session's grid. The JAX session keeps its cache across reset;
    the port drops it."""
    for i, x in enumerate(np.linspace(-1.0, 1.0, 4)):
        sess.process_scan(_make_ranges(i), [x, 0.0, 0.0], time=i)
    sess.get_occupancy_grid()
    sess.reset()
    for i, x in enumerate(np.linspace(-0.5, 0.5, 5)):
        sess.process_scan(_make_ranges(i, r=3.0), [x, 0.0, 0.0], time=i)
    _assert_grid_equal(sess.get_occupancy_grid(), _full(sess))


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_session_grid_matches_jax_session(route):
    """Unmatched scans (use_scan_matching=False) keep their odometry
    poses, so both sessions render the same posed scans: a full rebuild,
    an incremental fold and a rebuild at another resolution."""
    jsess = JaxSession(JaxConfig(**CFG_UNMATCHED), JaxLaser(**LASER91))
    tsess = SlamSession(config_from_dict(CFG_UNMATCHED),
                        laser_from_dict(LASER91), device="cpu")
    steps = [(np.linspace(-3.0, 3.0, 8), 5.0), (np.linspace(-1, 1, 4), 3.0)]
    t = 0
    for xs, r in steps:
        for x in xs:
            for s in (jsess, tsess):
                s.process_scan(_make_ranges(t, r), [x, 0.0, 0.1 * t], time=t)
            t += 1
        _assert_grid_equal(tsess.get_occupancy_grid(),
                           jsess.get_occupancy_grid())
    _assert_grid_equal(tsess.get_occupancy_grid(resolution=0.1),
                       jsess.get_occupancy_grid(resolution=0.1))
