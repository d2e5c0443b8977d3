"""A classic SlamSession run in lockstep by 2 gloo ranks (the contract of
the port's dist/ routes: every rank runs the same session on the same
scans) against the same session in one process without a group: the
bench world at 0.05 m, 361 beams, two laps and a bit at 0.6 m steps (144
scans; the last attempts see two candidate chains, so the coarse fan-out
takes the sharded chain match). Both ranks' trajectories, edge counts and
closures must equal the single process's bit for bit."""
import numpy as np
import torch

from test_torch_multihost import run_ranks

SESSION = """
from slam_toolbox_tpu_torch.api import SlamSession
from slam_toolbox_tpu_torch.core.params import MapperConfig
from slam_toolbox_tpu_torch.core.scan import LaserConfig
from slam_toolbox_tpu_torch.io.dataset import LidarSimulator, SegmentWorld

LAP = [(-6.0, -3.5), (1.5, -3.5), (5.5, -3.5), (5.5, 0.5), (5.5, 3.5),
       (1.0, 3.5), (-3.0, 3.5), (-6.0, 3.0), (-6.5, -1.0)]


def session_run():
    laser = LaserConfig(min_range=0.05, max_range=12.0, range_threshold=10.0,
                        angular_resolution=np.deg2rad(1.0))
    cfg = MapperConfig(
        minimum_travel_distance=0.2, minimum_time_interval=3600.0,
        scan_buffer_size=10, link_match_minimum_response_fine=0.1,
        link_scan_maximum_distance=1.5, loop_search_maximum_distance=3.0,
        loop_match_minimum_response_coarse=0.35,
        loop_match_minimum_response_fine=0.45,
        loop_match_maximum_variance_coarse=3.0,
        correlation_search_space_dimension=0.5,
        correlation_search_space_resolution=0.05,
        correlation_search_space_smear_deviation=0.1,
        distance_variance_penalty=0.5, angle_variance_penalty=1.0)
    sim = LidarSimulator(SegmentWorld.rooms(16.0, 10.0), laser,
                         range_noise=0.01, odom_noise=(0.015, 0.006),
                         seed=42)
    data = sim.simulate(np.array(LAP * 2 + [LAP[0], LAP[1]]), step=0.6)
    sess = SlamSession(cfg, laser, device="cpu")
    closures = []
    sess.mapper.listeners.append(closures.append)
    for i, (scan, _) in enumerate(data):
        sess.process_scan(scan.ranges, scan.odom_pose, time=i * 0.1)
    return dict(traj=sess.trajectory,
                counts=np.array([len(closures),
                                 len(sess.mapper.graph.edges)]))
"""

RANK = SESSION + """
import slam_toolbox_tpu_torch.dist.match_dist as md
calls = []
orig = md.match_chains_sharded
def spy(*a, **k):
    calls.append(len(a[2]))
    return orig(*a, **k)
md.match_chains_sharded = spy
out.update(session_run())
out["calls"] = np.array(calls)
"""


def test_two_rank_session_equals_single_process(tmp_path):
    torch.set_num_threads(1)
    outs = run_ranks(tmp_path, 2, RANK)
    ns = {"np": np}
    exec(SESSION, ns)
    ref = ns["session_run"]()
    assert ref["counts"][0] >= 1
    for o in outs:
        assert o["calls"].size >= 1 and o["calls"].min() > 1
        np.testing.assert_array_equal(o["counts"], ref["counts"])
        np.testing.assert_array_equal(o["traj"], ref["traj"])
