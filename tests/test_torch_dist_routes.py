"""The routes into the port's dist/ package under a gloo group of
subprocess ranks, against the port without a group and the JAX package on
its 8-device CPU mesh:

  - match_chains_sharded at 1, 2 and 4 ranks: rows bit-equal to the
    port's match_scans_batch on every rank, and within test_dist.py's
    tolerances of the JAX package's sharded match (response and pose
    1e-5, covariance 1e-4);
  - try_close_loop at 2 ranks routes its classic coarse fan-out there and
    closes the same loop as the port without a group (poses bit-equal);
  - PoseGraphSolver.compute at 2 and 3 ranks with dist_edge_threshold
    lowered routes to the distributed solve; the loop closes and the poses
    are within 2 cm of the host sparse solve's, the same on every rank;
  - a fault injected into each route (the distributed solve, the sharded
    match, the sharded raster) raises instead of falling through."""
import numpy as np
import pytest

from slam_toolbox_tpu_torch.core.params import SolverConfig
from slam_toolbox_tpu_torch.interop import solver_from_arrays
from test_torch_multihost import run_ranks

GRAPH = """
def build():
    # test_dist.py's out-and-back corridor, driven twice, so the final
    # scan sees two candidate chains
    from slam_toolbox_tpu_torch.core.params import MapperConfig
    from slam_toolbox_tpu_torch.core.scan import LaserConfig, LocalizedScan
    from slam_toolbox_tpu_torch.mapper.mapper import Mapper

    laser = LaserConfig(beam_count=181, min_angle=-np.pi / 2,
                        max_angle=np.pi / 2, min_range=0.05,
                        max_range=12.0, range_threshold=10.0, is_360=False)
    cfg = MapperConfig(loop_match_minimum_chain_size=4,
                       minimum_travel_distance=0.0,
                       minimum_time_interval=0.0)
    m = Mapper(cfg, device="cpu")
    m.initialize(laser.range_threshold)
    rng = np.random.default_rng(3)
    cov = np.eye(3) * 1e-3
    xs = (list(np.arange(0, 7.0, 0.35))
          + list(np.arange(7.0, -0.01, -0.35))) * 2
    sm = m.sensor_manager
    scans, prev = [], None
    for i, x in enumerate(xs):
        ranges = 4.0 + 0.5 * np.sin(
            np.linspace(0, 3, laser.n_beams)
        ) + rng.normal(0, 0.01, laser.n_beams)
        s = LocalizedScan(laser, ranges, [x, 0.0, 0.0], time=i)
        sm.add_scan(s)
        m.graph.add_vertex(s)
        if prev is not None:
            m.graph.link_scans(prev, s, s.sensor_pose, cov)
        prev = s
        scans.append(s)
    return m, laser, scans


def widen(chains):
    # 5 chains: at 2 and 4 ranks the last rank holds a padding slot
    c = chains[0]
    return chains + [c[:len(c) // 2 + 4], c[2:], c[1:-1], c[:-2]][
        :max(0, 5 - len(chains))]


def rows(results):
    return np.array([[r.response, *r.sensor_pose, *r.covariance.ravel()]
                     for r in results])
"""

MATCH = GRAPH + """
from slam_toolbox_tpu_torch.dist.match_dist import match_chains_sharded
m, laser, scans = build()
query = scans[-1]
chains, _ = m.graph._sweep_chains(query, laser.name, 0)
chains = widen(chains)
out["ids"] = np.array([[c[0].unique_id, len(c)] for c in chains])
out["ref"] = rows(m.loop_matcher.match_scans_batch(
    query, chains, penalize=False, refine=False))
out["got"] = rows(match_chains_sharded(m.loop_matcher, query, chains))
"""


def _graph(pkg):
    """GRAPH's build(), widen() and rows() for the port ("torch") or the
    JAX package ("jax"), from the one source."""
    src = GRAPH
    if pkg == "jax":
        src = src.replace("slam_toolbox_tpu_torch", "slam_toolbox_tpu")
        src = src.replace('Mapper(cfg, device="cpu")', "Mapper(cfg)")
    ns = {"np": np}
    exec(src, ns)
    return ns


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_match_chains_sharded(tmp_path, n_dev):
    from slam_toolbox_tpu.dist.match_dist import (
        match_chains_sharded as jax_sharded,
    )

    outs = run_ranks(tmp_path, n_dev, MATCH)
    g = _graph("jax")
    m, laser, scans = g["build"]()
    chains, _ = m.graph._sweep_chains(scans[-1], laser.name, 0)
    assert len(chains) == 2
    chains = g["widen"](chains)
    ref = g["rows"](jax_sharded(m.loop_matcher, scans[-1], chains))
    for o in outs:
        assert o["ids"][:, 1].tolist() == [len(c) for c in chains]
        np.testing.assert_array_equal(o["got"], o["ref"])
        np.testing.assert_array_equal(o["got"], outs[0]["got"])
        np.testing.assert_allclose(o["got"][:, :4], ref[:, :4], atol=1e-5)
        np.testing.assert_allclose(o["got"][:, 4:], ref[:, 4:], atol=1e-4)


CLOSE = GRAPH + """
import slam_toolbox_tpu_torch.dist.match_dist as md
calls = []
orig = md.match_chains_sharded
def spy(*a, **k):
    calls.append(len(a[2]))
    return orig(*a, **k)
md.match_chains_sharded = spy
m, laser, scans = build()
out["closed"] = np.bool_(m.graph.try_close_loop(scans[-1], laser.name))
out["calls"] = np.array(calls)
out["poses"] = np.stack([s.corrected_pose for s in scans])
"""


def test_try_close_loop_routes_to_sharded_match(tmp_path):
    outs = run_ranks(tmp_path, 2, CLOSE)
    # the port without a group: the same attempt on match_scans_batch
    m, laser, scans = _graph("torch")["build"]()
    closed = m.graph.try_close_loop(scans[-1], laser.name)
    poses = np.stack([s.corrected_pose for s in scans])
    jm, jlaser, jscans = _graph("jax")["build"]()
    assert closed == jm.graph.try_close_loop(jscans[-1], jlaser.name)
    for o in outs:
        assert o["calls"].size >= 1 and o["calls"].min() > 1
        assert bool(o["closed"]) == closed
        np.testing.assert_array_equal(o["poses"], poses)


def _ring(n=300, seed=0):
    """test_dist.py's routing graph: a noisy 300-node ring, one closure."""
    cov = np.diag([1e-4, 1e-4, 1e-5])
    rng = np.random.default_rng(seed)
    step = np.array([0.5, 0.0, 2 * np.pi / n])
    pose = np.zeros(3)
    poses, edges = [pose], []
    for i in range(1, n):
        noisy = step + rng.normal(0, 0.01, 3)
        c, sn = np.cos(pose[2]), np.sin(pose[2])
        pose = np.array([pose[0] + c * noisy[0] - sn * noisy[1],
                         pose[1] + sn * noisy[0] + c * noisy[1],
                         pose[2] + noisy[2]])
        poses.append(pose)
        edges.append((i - 1, i, step, cov))
    edges.append((n - 1, 0, step, cov))
    return np.stack(poses), edges


COMPUTE = """
from slam_toolbox_tpu_torch.core.params import SolverConfig
from slam_toolbox_tpu_torch.interop import solver_from_arrays
from slam_toolbox_tpu_torch.solver.se2_solver import PoseGraphSolver
routed = []
orig = PoseGraphSolver._compute_distributed
def spy(self, n, e):
    routed.append((n, e))
    return orig(self, n, e)
PoseGraphSolver._compute_distributed = spy
edges = [(int(a), int(b), r, c) for a, b, r, c in zip(
    inp["a"], inp["b"], inp["rel"], inp["cov"])]
s = solver_from_arrays(range(len(inp["poses"])), inp["poses"], edges,
                       SolverConfig(dist_edge_threshold=256), device="cpu")
corr = dict(s.compute())
out["poses"] = np.stack([corr[i] for i in range(len(inp["poses"]))])
out["routed"] = np.array(routed)
out["cg"] = np.array(s.last_stats["cg_iters"])
"""


def _check_compute_route(tmp_path, ranks):
    poses, edges = _ring()
    n = len(poses)
    a, b, rel, cov = (np.array(x) for x in zip(*edges))
    outs = run_ranks(tmp_path, ranks, COMPUTE, dict(poses=poses, a=a, b=b,
                                                    rel=rel, cov=cov))
    s = solver_from_arrays(range(n), poses, edges,
                           SolverConfig(dist_edge_threshold=256),
                           device="cpu")
    corr = dict(s.compute())      # no group: the host sparse solve
    ref = np.stack([corr[i] for i in range(n)])
    for o in outs:
        assert o["routed"].tolist() == [[n, len(edges)]]
        assert o["cg"].size >= 1
        np.testing.assert_array_equal(o["poses"], outs[0]["poses"])
        assert np.hypot(*(o["poses"][n - 1, :2] - o["poses"][0, :2])) < 1.5
        assert np.hypot(*(o["poses"][:, :2] - ref[:, :2]).T).max() < 2e-2


def test_compute_routes_to_distributed_solve(tmp_path):
    _check_compute_route(tmp_path, 2)


def test_compute_routes_to_distributed_solve_on_three_ranks(tmp_path):
    # a rank count that is not a power of two: the nodes pad to a
    # multiple of it (300 -> 3 x 128), not to the next power of two
    _check_compute_route(tmp_path, 3)


FAULTS = GRAPH + """
import slam_toolbox_tpu_torch.dist.match_dist as md
import slam_toolbox_tpu_torch.dist.solver_dist as sd
import slam_toolbox_tpu_torch.dist.submap as sm
from slam_toolbox_tpu_torch.core.params import SolverConfig
from slam_toolbox_tpu_torch.solver.se2_solver import PoseGraphSolver

def broken(*a, **k):
    raise RuntimeError("injected")

raised = []
def expect(name, fn):
    try:
        fn()
    except RuntimeError as err:
        if "injected" in str(err):
            raised.append(name)

md.match_chains_sharded = broken
sd.distributed_lm_solve = broken
sm.sharded_occupancy = broken
m, laser, scans = build()
expect("match", lambda: m.graph.try_close_loop(scans[-1], laser.name))
s = PoseGraphSolver(SolverConfig(dist_edge_threshold=1), device="cpu")
s.add_node(0, [0.0, 0.0, 0.0])
s.add_node(1, [1.0, 0.0, 0.0])
s.add_constraint(0, 1, [1.1, 0.0, 0.0], np.eye(3) * 1e-2)
expect("solve", s.compute)
expect("raster", lambda: sm.maybe_sharded_create_from_scans(
    scans, 0.1, device="cpu", sharded="1"))
out["raised"] = np.array(raised)
"""


def test_faults_in_dist_routes_raise(tmp_path):
    for o in run_ranks(tmp_path, 2, FAULTS):
        assert o["raised"].tolist() == ["match", "solve", "raster"]
