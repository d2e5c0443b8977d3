"""CARMEN logs (io/carmen.py) and the command-line driver (api/cli.py) of
the port against the JAX package on the CPU: the recorded fixture parsed
the same, the two round trips of tests/test_carmen.py, `cli run` on a
small simulated dataset against the JAX CLI, `cli merge`, `cli localize`
against a prior of the fixture, and the entry points' device rules."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from slam_toolbox_tpu.api import cli as jcli
from slam_toolbox_tpu.io import carmen as jcarmen
from slam_toolbox_tpu.io.dataset import LidarSimulator, SegmentWorld
from slam_toolbox_tpu_torch.api import cli
from slam_toolbox_tpu_torch.core.scan import LaserConfig
from slam_toolbox_tpu_torch.io.carmen import (
    is_carmen_log, read_carmen, write_carmen,
)
from slam_toolbox_tpu_torch.kernels import occupancy as occ

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "loop_rooms.clf.gz")

# tests/test_carmen.py's two old-format FLASER records
_OLD_LOG = """\
# comment line
PARAM robot_front_laser_max 81.92
TRUEPOS 1.0 2.0 0.5 0.9 1.9 0.45 100.10 host 100.10
FLASER 4 1.50 2.25 81.91 3.75 0.90 1.90 0.45 0.90 1.90 0.45 100.12 host 100.12
ODOM 0.95 1.95 0.46 0.1 0.0 0.0 100.15 host 100.15
FLASER 4 1.40 2.20 3.10 81.92 1.00 2.00 0.50 1.00 2.00 0.50 100.22 host 100.22
"""


def _assert_logs_equal(got, ref):
    assert got.laser.__dict__ == ref.laser.__dict__
    assert got.params == ref.params
    assert len(got.records) == len(ref.records) > 0
    for a, b in zip(got.records, ref.records):
        np.testing.assert_array_equal(a.ranges, b.ranges)
        np.testing.assert_array_equal(a.odom_pose, b.odom_pose)
        assert a.timestamp == b.timestamp
        for x, y in ((a.laser_pose, b.laser_pose), (a.true_pose, b.true_pose)):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(got.ground_truth(), ref.ground_truth())


def test_read_fixture_matches_jax():
    assert is_carmen_log(FIXTURE) and jcarmen.is_carmen_log(FIXTURE)
    _assert_logs_equal(read_carmen(FIXTURE), jcarmen.read_carmen(FIXTURE))


def test_parse_old_format_flaser(tmp_path):
    p = str(tmp_path / "old.clf")
    with open(p, "w") as f:
        f.write(_OLD_LOG)
    assert is_carmen_log(p)
    log = read_carmen(p)
    _assert_logs_equal(log, jcarmen.read_carmen(p))
    assert len(log.records) == 2
    assert log.params["robot_front_laser_max"] == "81.92"
    las = log.laser
    assert las.n_beams == 4
    assert np.isclose(las.min_angle, -np.pi / 2)
    assert np.isclose(las.angular_resolution, np.pi / 4)
    assert np.isclose(las.max_range, 81.92)
    r0 = log.records[0]
    assert np.isposinf(r0.ranges[2])
    assert np.isclose(r0.ranges[0], 1.50)
    assert np.allclose(r0.odom_pose, [0.90, 1.90, 0.45])
    assert np.allclose(r0.true_pose, [1.0, 2.0, 0.5])
    assert log.records[1].true_pose is None
    assert np.allclose(log.ground_truth()[1], [1.0, 2.0, 0.5])


def test_roundtrip_robotlaser1(tmp_path):
    laser = LaserConfig(
        min_range=0.05, max_range=8.0, range_threshold=7.5,
        min_angle=np.deg2rad(-120.0), max_angle=np.deg2rad(120.0),
        angular_resolution=np.deg2rad(2.0), is_360=False,
        offset_pose=(0.2, -0.05, 0.1),
    )
    rng = np.random.default_rng(3)
    N, B = 7, laser.n_beams
    ranges = rng.uniform(0.5, 7.0, (N, B))
    ranges[2, 5] = np.inf
    odom = rng.normal(0, 1.0, (N, 3))
    gt = odom + 0.01
    p = str(tmp_path / "rt.clf.gz")
    write_carmen(p, laser, ranges, odom, true_poses=gt)
    log = read_carmen(p)
    _assert_logs_equal(log, jcarmen.read_carmen(p))
    las = log.laser
    assert las.n_beams == B
    assert np.isclose(las.min_angle, laser.min_angle, atol=1e-5)
    assert np.isclose(las.angular_resolution, laser.angular_resolution,
                      atol=1e-7)
    got = np.stack([r.ranges for r in log.records])
    assert np.isposinf(got[2, 5])
    fin = np.isfinite(ranges) & (ranges < 8.0 * 0.99)
    assert np.allclose(got[fin], ranges[fin], atol=2e-3)
    assert np.allclose(np.stack([r.odom_pose for r in log.records]), odom,
                       atol=1e-5)
    assert np.allclose(log.ground_truth(), gt, atol=1e-5)
    assert np.allclose(las.offset_pose, laser.offset_pose, atol=1e-4)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A small simulated dataset in the CLI's .npz format."""
    from slam_toolbox_tpu.core.scan import LaserConfig as JaxLaser

    laser = JaxLaser(min_range=0.05, max_range=12.0, range_threshold=10.0,
                     angular_resolution=np.deg2rad(2.0))
    sim = LidarSimulator(SegmentWorld.rooms(16.0, 10.0), laser,
                         range_noise=0.01, odom_noise=(0.015, 0.006), seed=4)
    data = sim.simulate(np.array([(-6.0, -3.5), (1.5, -3.5), (1.5, -1.5)]),
                        step=0.6)
    path = str(tmp_path_factory.mktemp("ds") / "sim.npz")
    np.savez(
        path, ranges=np.stack([s.ranges for s, _ in data]),
        odom=np.stack([s.odom_pose for s, _ in data]),
        times=np.arange(len(data)) * 0.1,
        gt=np.stack([tp for _, tp in data]),
        min_range=laser.min_range, max_range=laser.max_range,
        range_threshold=laser.range_threshold, min_angle=laser.min_angle,
        max_angle=laser.max_angle,
        angular_resolution=laser.angular_resolution,
    )
    return path


def _run_cli(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def cli_runs(dataset, tmp_path_factory):
    """`cli run` on the dataset through both packages' CLIs."""
    d = tmp_path_factory.mktemp("cli")
    out = {}
    for name, main, extra in (("jax", jcli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        prefix = str(d / name)
        assert main(["run", "--dataset", dataset, "--out", prefix]
                    + extra) == 0
        with open(prefix + "_metrics.json") as f:
            out[name] = (prefix, json.load(f))
    return out


def test_cli_run_matches_jax(cli_runs):
    _, ref = cli_runs["jax"]
    out, got = cli_runs["port"]
    assert got["scans_processed"] == ref["scans_processed"] > 10
    assert got["nodes"] == ref["nodes"]
    assert got["edges"] == ref["edges"]
    assert abs(got["ate_rmse_m"] - ref["ate_rmse_m"]) < 0.04
    assert got["ate_odom_m"] == ref["ate_odom_m"]
    for suffix in (".pgm", ".yaml", "_trajectory.txt", ".posegraph.npz",
                   "_metrics.json"):
        assert os.path.exists(out + suffix), suffix
    traj = np.loadtxt(out + "_trajectory.txt")
    assert traj.shape == (got["nodes"], 3)
    # the snapshot the CLI wrote loads in the JAX package
    from slam_toolbox_tpu.io.serialization import load_snapshot

    assert load_snapshot(out + ".posegraph.npz").solver.n_nodes == \
        got["nodes"]


def test_save_pgm_writes_the_jax_bytes(tmp_path):
    rng = np.random.default_rng(0)
    cells = rng.choice(np.array([occ.UNKNOWN, occ.OCCUPIED, occ.FREE],
                                np.uint8), size=(37, 53))
    grid = occ.OccupancyGrid(cells, np.array([-3.25, 1.5]), 0.05)
    cli._save_pgm(grid, str(tmp_path / "port"))
    jcli._save_pgm(grid, str(tmp_path / "jax"))
    for ext in (".pgm", ".yaml"):
        with open(str(tmp_path / "port") + ext, "rb") as f:
            a = f.read()
        with open(str(tmp_path / "jax") + ext, "rb") as f:
            b = f.read()
        assert a.replace(b"port", b"jax") == b, ext


def test_cli_merge_of_two_snapshots(cli_runs, tmp_path, capsys):
    """`cli merge` through `python -m`, on the sessions both CLIs wrote,
    against the JAX CLI's merge of the same two."""
    snaps = [cli_runs[k][0] + ".posegraph.npz" for k in ("jax", "port")]
    merged = str(tmp_path / "merged")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-m", "slam_toolbox_tpu_torch.api.cli", "merge",
         *snaps, "--out", merged, "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr
    dims = json.loads(proc.stdout.strip().splitlines()[-1])
    ref = _run_cli(jcli.main, ["merge", *snaps, "--out",
                               str(tmp_path / "jax_merged")], capsys)
    assert dims == ref and dims["width"] > 10
    with open(merged + ".pgm", "rb") as f:
        a = f.read()
    with open(str(tmp_path / "jax_merged") + ".pgm", "rb") as f:
        assert a == f.read()


def _carmen_prior_and_stream(tmp_path, n_prior=120, n_loc=5):
    """The CARMEN fixture as a localization case: a prior snapshot written
    by the JAX package from every other record of the first `n_prior` at
    its true pose (a skeleton graph, odometry-chain edges, no matching:
    build_prior_snapshot's technique), and the `n_loc` records between
    them from the start in the CLI's .npz format, with ground truth."""
    from slam_toolbox_tpu.core.params import MapperConfig as JaxConfig
    from slam_toolbox_tpu.core.scan import LocalizedScan as JaxScan
    from slam_toolbox_tpu.io.serialization import save_snapshot
    from slam_toolbox_tpu.mapper import Mapper as JaxMapper

    log = jcarmen.read_carmen(FIXTURE)
    laser, gt = log.laser, log.ground_truth()
    m = JaxMapper(JaxConfig(use_scan_matching=False))
    m.initialize(laser.range_threshold)
    prev = None
    for rec, tp in list(zip(log.records, gt))[:n_prior:2]:
        s = JaxScan(laser, rec.ranges, rec.odom_pose, time=rec.timestamp)
        s.set_corrected_pose(tp)
        m.sensor_manager.add_scan(s)
        m.graph.add_vertex(s)
        if prev is not None:
            m.graph.link_scans(prev, s, s.sensor_pose,
                               np.diag([1e-3, 1e-3, 1e-4]))
        m.sensor_manager.set_last_scan(s)
        prev = s
    snap = str(tmp_path / "carmen_prior.npz")
    save_snapshot(m, snap)
    recs = log.records[1:2 * n_loc:2]
    ds = str(tmp_path / "carmen_loc.npz")
    np.savez(
        ds, ranges=np.stack([r.ranges for r in recs]),
        odom=np.stack([r.odom_pose for r in recs]),
        times=np.array([r.timestamp for r in recs]),
        gt=gt[1:2 * n_loc:2], min_range=laser.min_range,
        max_range=laser.max_range, range_threshold=laser.range_threshold,
        min_angle=laser.min_angle, max_angle=laser.max_angle,
        angular_resolution=laser.angular_resolution)
    return snap, ds


def test_cli_localize_is_not_ported(tmp_path, capsys):
    """`cli localize --device cpu` (classic) against a prior of the CARMEN
    fixture, beside the JAX CLI on the same snapshot and scans: the same
    scans localized and buffer nodes (the LOCALIZATION preset's 3), the
    error against ground truth within 0.01 m of the JAX CLI's, and the
    same files written."""
    snap, ds = _carmen_prior_and_stream(tmp_path)
    out = {}
    for name, main, extra in (("jax", jcli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        prefix = str(tmp_path / name)
        out[name] = (prefix, _run_cli(
            main, ["localize", "--snapshot", snap, "--dataset", ds,
                   "--out", prefix] + extra, capsys))
    (prefix, got), (_, ref) = out["port"], out["jax"]
    assert got["scans_localized"] == ref["scans_localized"] == 5
    assert got["buffer_nodes"] == ref["buffer_nodes"] == 3
    assert abs(got["err_rmse_m"] - ref["err_rmse_m"]) <= 0.01
    assert got["err_rmse_m"] < 0.1
    poses = np.loadtxt(prefix + "_localization.txt")
    assert poses.shape == (5, 3) and np.all(np.isfinite(poses))
    with open(prefix + "_metrics.json") as f:
        assert json.load(f) == got


def test_cli_defaults_to_the_card(dataset, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for argv in (["run", "--dataset", dataset],
                 ["demo"],
                 ["merge", str(tmp_path / "a.npz")]):
        with pytest.raises(RuntimeError):
            cli.main(argv + ["--out", str(tmp_path / "x")])


@pytest.mark.slow
def test_fixture_end_to_end(tmp_path, capsys):
    """tests/test_carmen.py's end-to-end run on the recorded log, through
    the port's CLI on the CPU: map and trajectory out, a loop closure,
    ATE bounded and below odometry's."""
    from slam_toolbox_tpu_torch.api import SlamSession
    from slam_toolbox_tpu_torch.core.params import ONLINE_SYNC

    out = str(tmp_path / "clfrun")
    m = _run_cli(cli.main, ["run", "--dataset", FIXTURE, "--out", out,
                            "--device", "cpu"], capsys)
    assert m["nodes"] > 100
    assert m["ate_rmse_m"] < 0.30
    assert m["ate_rmse_m"] < m["ate_odom_m"]
    assert os.path.exists(out + ".pgm")
    assert os.path.exists(out + "_trajectory.txt")
    sess = SlamSession(ONLINE_SYNC, read_carmen(FIXTURE).laser, device="cpu")
    sess.deserialize(out + ".posegraph.npz")
    spans = [abs(e.source.state_id - e.target.state_id)
             for e in sess.mapper.graph.edges]
    assert max(spans) > 20, "no loop-closure edge in the graph"
