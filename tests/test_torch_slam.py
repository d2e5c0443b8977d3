"""The slice end to end: SlamSession on the classic synchronous path, the
port (device="cpu", plain versions) against the JAX package on the CPU,
from one configuration carried across with interop. Both must accept the
same scans, build the same edges and close the same loops, with positions
inside PARITY.md's 4 cm engine envelope."""
import dataclasses

import numpy as np
import pytest

from slam_toolbox_tpu.api import SlamSession as JaxSession
from slam_toolbox_tpu.core.params import MapperConfig
from slam_toolbox_tpu.core.scan import LaserConfig
from slam_toolbox_tpu.io.dataset import LidarSimulator, SegmentWorld, ate_rmse
from slam_toolbox_tpu_torch.api import SlamSession as TorchSession
from slam_toolbox_tpu_torch.interop import config_from_dict, laser_from_dict

LAP = [
    (-6.0, -3.5), (1.5, -3.5), (5.5, -3.5), (5.5, 0.5), (5.5, 3.5),
    (1.0, 3.5), (-3.0, 3.5), (-6.0, 3.0), (-6.5, -1.0),
]


def _workload(resolution, beam_deg, waypoints, step):
    """bench.py's world and mapper settings at a chosen grid resolution."""
    laser = LaserConfig(min_range=0.05, max_range=12.0, range_threshold=10.0,
                        angular_resolution=np.deg2rad(beam_deg))
    cfg = MapperConfig(
        minimum_travel_distance=0.2, minimum_time_interval=3600.0,
        scan_buffer_size=10, link_match_minimum_response_fine=0.1,
        link_scan_maximum_distance=1.5, loop_search_maximum_distance=3.0,
        loop_match_minimum_response_coarse=0.35,
        loop_match_minimum_response_fine=0.45,
        loop_match_maximum_variance_coarse=3.0,
        correlation_search_space_dimension=0.5,
        correlation_search_space_resolution=resolution,
        correlation_search_space_smear_deviation=0.1,
        distance_variance_penalty=0.5, angle_variance_penalty=1.0,
    )
    sim = LidarSimulator(SegmentWorld.rooms(16.0, 10.0), laser,
                         range_noise=0.01, odom_noise=(0.015, 0.006),
                         seed=42)
    return cfg, laser, sim.simulate(np.array(waypoints), step=step)


def _run(sess, data):
    closures = []
    sess.mapper.listeners.append(closures.append)
    est, gt, odo = [], [], []
    for i, (scan, tp) in enumerate(data):
        out = sess.process_scan(scan.ranges, scan.odom_pose, time=i * 0.1)
        if out is not None:
            est.append(out[0])
            gt.append(tp)
            odo.append(scan.odom_pose)
    return dict(est=np.stack(est), gt=np.stack(gt), odo=np.stack(odo),
                closures=len(closures), edges=len(sess.mapper.graph.edges),
                traj=sess.trajectory)


def _compare(cfg, laser, data):
    ref = _run(JaxSession(cfg, laser), data)
    got = _run(TorchSession(config_from_dict(dataclasses.asdict(cfg)),
                            laser_from_dict(dataclasses.asdict(laser)),
                            device="cpu"), data)
    assert len(got["est"]) == len(ref["est"])
    assert got["edges"] == ref["edges"]
    assert got["closures"] == ref["closures"] >= 1
    gap = np.hypot(*(got["traj"][:, :2] - ref["traj"][:, :2]).T)
    assert gap.max() < 0.04, gap.max()
    assert ate_rmse(got["traj"], got["gt"]) < ate_rmse(got["odo"], got["gt"])
    return ref, got


def test_classic_session_matches_jax_reduced_geometry():
    """0.05 m correlation grid, 361 beams, a lap and a half (79 scans,
    loop closures on the revisit)."""
    cfg, laser, data = _workload(0.05, 1.0, LAP + [LAP[0], LAP[1]], 0.6)
    _, got = _compare(cfg, laser, data)
    assert len(got["est"]) >= 60


@pytest.mark.slow
def test_classic_session_matches_jax_bench_geometry():
    """bench.py's geometry (0.01 m grid, G = 2051, 1081 beams), one lap
    and a half at 0.45 m steps."""
    cfg, laser, data = _workload(0.01, 1.0 / 3, LAP + [LAP[0], LAP[1]], 0.45)
    _, got = _compare(cfg, laser, data)
    assert len(got["est"]) >= 100


def test_session_reports_pose_and_transform():
    cfg, laser, data = _workload(0.05, 1.0, LAP[:2], 0.6)
    sess = TorchSession(config_from_dict(dataclasses.asdict(cfg)),
                        laser_from_dict(dataclasses.asdict(laser)),
                        device="cpu")
    out = None
    for i, (scan, _) in enumerate(data[:8]):
        out = sess.process_scan(scan.ranges, scan.odom_pose, time=i * 0.1) \
            or out
    pose, cov = out
    assert cov.shape == (3, 3) and np.all(np.isfinite(pose))
    from slam_toolbox_tpu_torch.core import geometry

    recon = np.asarray(geometry.compose(sess.map_to_odom, data[7][0].odom_pose))
    np.testing.assert_allclose(recon[:2], sess.trajectory[-1][:2], atol=1e-6)
    nodes, edges = sess.get_graph()
    assert len(nodes) == len(sess.trajectory) and edges
    sess.flush()
    grid = sess.get_occupancy_grid()
    assert grid.cells.ndim == 2 and (grid.cells == 100).any()
    from slam_toolbox_tpu_torch.api import MatchType

    with pytest.raises(NotImplementedError):
        sess.deserialize("unused.npz", MatchType.LOCALIZE_AT_POSE,
                         initial_pose=np.zeros(3))
