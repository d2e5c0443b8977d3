"""The port's row-band sharded raster (dist/submap.py) under a gloo group of
1, 2 and 4 subprocess ranks: counters and cells bit-equal to the port's
create_from_scans and to the JAX package's sharded raster on a CPU mesh of
the same size, on test_submap.py's posed scans (rooms 16 x 10 m, 361
beams), at 0.05 m with the 10 m range threshold (the exchange multi-hop:
halo 202 rows against bands of at most 200) and at 0.35 m with a 4 m
threshold (halo 14 rows: on 1 and 2 ranks it fits one band, the
single-hop case); the halo refresh with local_window (windows of 40 rows
each side of a band's first, middle and last rows equal to slices of the
full counters); and the sharded= gate."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from slam_toolbox_tpu.core.scan import LaserConfig as JaxLaser
from slam_toolbox_tpu.core.scan import LocalizedScan as JaxScan
from slam_toolbox_tpu.dist import submap as jsubmap
from slam_toolbox_tpu.io.dataset import LidarSimulator, SegmentWorld
from slam_toolbox_tpu_torch.core.scan import LaserConfig, LocalizedScan
from slam_toolbox_tpu_torch.dist import submap
from slam_toolbox_tpu_torch.kernels import occupancy as occ
from test_torch_multihost import run_ranks

CASES = ((0.05, 10.0), (0.35, 4.0))   # (resolution, range threshold)
HALO_RES = 0.1
LASER = dict(min_range=0.05, max_range=12.0, range_threshold=10.0,
             angular_resolution=np.deg2rad(1.0))
WAYPOINTS = np.array([
    (-6.0, -3.5), (1.5, -3.5), (5.5, -3.5), (5.5, 0.5), (5.5, 3.5),
    (1.0, 3.5), (-3.0, 3.5), (-6.0, 3.0), (-6.5, -1.0),
])

SCANS = """
from slam_toolbox_tpu_torch.core.scan import LaserConfig, LocalizedScan

def posed_scans(rt=10.0):
    laser = LaserConfig(min_range=0.05, max_range=12.0, range_threshold=rt,
                        angular_resolution=np.deg2rad(1.0))
    scans = []
    for i, (r, odo, tp) in enumerate(zip(inp["ranges"], inp["odom"],
                                         inp["true"])):
        s = LocalizedScan(laser, r, odo, time=i * 0.1)
        s.set_corrected_pose(tp)
        scans.append(s)
    return scans

scans = posed_scans()
"""

RASTER = SCANS + """
from slam_toolbox_tpu_torch.dist import multihost, submap
mesh = multihost.global_mesh("cpu")
for k, (res, rt) in enumerate(inp["cases"]):
    g = submap.sharded_occupancy(mesh, posed_scans(rt), float(res))
    out[f"pass{k}"], out[f"hit{k}"] = g.pass_cnt, g.hit_cnt
    out[f"cells{k}"], out[f"offset{k}"] = g.cells, g.offset
# the halo refresh: this rank's owned band of the full counters, its
# refreshed band + 2 * halo view, and windows around its mid-band rows
full = inp["full_pass"]
height, width = full.shape
halo = int(np.ceil(10.0 / float(inp["halo_res"]))) + 2
band, _ = submap._band_geometry(height, mesh.size, halo)
padded = np.zeros((band * mesh.size, width), np.int32)
padded[:height] = full
owned = torch.from_numpy(padded[mesh.rank * band:(mesh.rank + 1) * band])
view = submap.make_halo_refresh(mesh, band, halo, width)(owned).numpy()
wins = []
for mid in (mesh.rank * band + band // 2, mesh.rank * band,
            (mesh.rank + 1) * band - 1):
    # 40 rows each side (the loop matcher's 8 m window at 0.1 m cells,
    # inside the 102-row halo), clipped to the grid
    lo, hi = max(mid - 40, 0), min(mid + 40, band * mesh.size)
    got, _ = submap.local_window(view, view, band, halo, mesh.rank, lo, hi)
    wins.append(bool(np.array_equal(got, padded[lo:hi])))
out["windows"] = np.array(wins)
"""


@pytest.fixture(scope="module")
def posed():
    """test_submap.py's ground-truth-posed scans (the JAX package's
    simulator), as arrays and as the port's scans."""
    laser = JaxLaser(**LASER)
    sim = LidarSimulator(SegmentWorld.rooms(16.0, 10.0), laser,
                         range_noise=0.01, odom_noise=(0.0, 0.0), seed=3)
    data = sim.simulate(WAYPOINTS, step=0.6)
    arrays = dict(ranges=np.stack([s.ranges for s, _ in data]),
                  odom=np.stack([s.odom_pose for s, _ in data]),
                  true=np.stack([tp for _, tp in data]))
    return arrays, _scans(arrays, LaserConfig, LocalizedScan)


def _scans(arrays, laser_cls, cls, rt=10.0):
    laser = laser_cls(**dict(LASER, range_threshold=rt))
    out = []
    for i, (r, odo, tp) in enumerate(zip(arrays["ranges"], arrays["odom"],
                                         arrays["true"])):
        s = cls(laser, r, odo, time=i * 0.1)
        s.set_corrected_pose(tp)
        out.append(s)
    return out


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_sharded_raster_bit_exact(tmp_path, posed, n_dev):
    torch.set_num_threads(1)
    arrays, scans = posed
    full = occ.create_from_scans(scans, HALO_RES, device="cpu")
    outs = run_ranks(tmp_path, n_dev, RASTER, dict(
        arrays, cases=np.array(CASES), halo_res=np.float64(HALO_RES),
        full_pass=full.pass_cnt))
    mesh = JaxMesh(np.array(jax.devices()[:n_dev]), (jsubmap.AXIS,))
    for k, (res, rt) in enumerate(CASES):
        ref = occ.create_from_scans(_scans(arrays, LaserConfig,
                                           LocalizedScan, rt), res,
                                    device="cpu")
        jref = jsubmap.sharded_occupancy(
            mesh, _scans(arrays, JaxLaser, JaxScan, rt), res)
        np.testing.assert_array_equal(ref.pass_cnt, jref.pass_cnt)
        np.testing.assert_array_equal(ref.cells, jref.cells)
        for o in outs:
            np.testing.assert_array_equal(o[f"pass{k}"], ref.pass_cnt)
            np.testing.assert_array_equal(o[f"hit{k}"], ref.hit_cnt)
            np.testing.assert_array_equal(o[f"cells{k}"], ref.cells)
            np.testing.assert_array_equal(o[f"hit{k}"], jref.hit_cnt)
            assert o[f"offset{k}"].tolist() == \
                np.asarray(ref.offset).tolist()
        # the exchange's shape: multi-hop at 0.05 m on 2 and 4 ranks, one
        # hop at 0.35 m on 1 and 2
        halo = int(np.ceil(rt / res)) + 2
        _, hops = submap._band_geometry(ref.pass_cnt.shape[0], n_dev, halo)
        if res == 0.05 and n_dev > 1:
            assert hops >= 2
        if res == 0.35 and n_dev <= 2:
            assert hops == 1
    for o in outs:
        assert o["windows"].tolist() == [True] * 3


GATE = SCANS + """
from slam_toolbox_tpu_torch.dist import submap
calls = []
orig = submap.sharded_occupancy
def spy(*a, **k):
    calls.append(1)
    return orig(*a, **k)
submap.sharded_occupancy = spy
taken = []
for mode in ("auto", "1", "0"):
    n0 = len(calls)
    g = submap.maybe_sharded_create_from_scans(scans, 0.1, device="cpu",
                                               sharded=mode)
    taken.append(len(calls) - n0)
    out[f"cells_{mode}"] = g.cells
try:
    submap.maybe_sharded_create_from_scans(scans, 0.1, device="cpu",
                                           sharded="yes")
    out["refused"] = np.bool_(False)
except ValueError:
    out["refused"] = np.bool_(True)
out["taken"] = np.array(taken)
"""


def test_sharded_gate(tmp_path, posed, monkeypatch):
    """At 2 ranks on a CPU mesh: "auto" keeps the single-device render (a
    CPU mesh, and ~200 x 160 cells far below the 8 M-cell gate), "1"
    takes the sharded raster, "0" never; every mode gives the same grid;
    an unknown mode is refused. With no process group "1" has no mesh to
    shard over, and the single-device render runs."""
    arrays, scans = posed
    outs = run_ranks(tmp_path, 2, GATE, arrays)
    ref = occ.create_from_scans(scans, 0.1, device="cpu")
    for o in outs:
        assert o["taken"].tolist() == [0, 1, 0]
        assert o["refused"]
        for mode in ("auto", "1", "0"):
            np.testing.assert_array_equal(o[f"cells_{mode}"], ref.cells)

    def fail(*a, **k):
        raise AssertionError("sharded without a group")

    monkeypatch.setattr(submap, "sharded_occupancy", fail)
    got = submap.maybe_sharded_create_from_scans(scans, 0.1, device="cpu",
                                                 sharded="1")
    np.testing.assert_array_equal(got.cells, ref.cells)
    with pytest.raises(ValueError):
        submap.maybe_sharded_create_from_scans(scans, 0.1, device="cpu",
                                               sharded="on")
