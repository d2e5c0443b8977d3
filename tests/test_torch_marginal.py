"""graph/marginal.py of the port against the JAX package's, following
tests/test_marginal.py: on the same graphs (poses and covariances from a
numpy seed, built in both packages), marginal_factors gives the same
factors to 1e-12 (both are f64 NumPy), and after marginalize_and_remove
a solve gives the same surviving poses within 1e-6 m. Then the mapper:
remove_node_from_graph with marginalize_on_removal replaces the node's
edges with the composed factors in both packages."""
import dataclasses

import numpy as np
import pytest
import torch

from slam_toolbox_tpu.core import geometry as jgeo
from slam_toolbox_tpu.core.params import MapperConfig as JaxConfig
from slam_toolbox_tpu.graph import marginal as jmarg
from slam_toolbox_tpu.graph.pose_graph import Edge as JaxEdge
from slam_toolbox_tpu.graph.pose_graph import PoseGraph as JaxGraph
from slam_toolbox_tpu.mapper import Mapper as JaxMapper
from slam_toolbox_tpu.solver.se2_solver import PoseGraphSolver as JaxSolver
from slam_toolbox_tpu_torch.core import geometry as tgeo
from slam_toolbox_tpu_torch.core.params import MapperConfig as TorchConfig
from slam_toolbox_tpu_torch.graph import marginal as tmarg
from slam_toolbox_tpu_torch.graph.pose_graph import Edge as TorchEdge
from slam_toolbox_tpu_torch.graph.pose_graph import PoseGraph as TorchGraph
from slam_toolbox_tpu_torch.interop import config_from_dict, laser_from_dict
from slam_toolbox_tpu_torch.mapper import Mapper as TorchMapper
from slam_toolbox_tpu_torch.solver.se2_solver import (
    PoseGraphSolver as TorchSolver,
)

torch.set_num_threads(1)

PKGS = {
    "jax": (jmarg, JaxGraph, JaxEdge, lambda: JaxSolver(), JaxConfig, jgeo),
    "torch": (tmarg, TorchGraph, TorchEdge,
              lambda: TorchSolver(device="cpu"), TorchConfig, tgeo),
}


class _Laser:
    name = "fake"
    offset_pose = (0.0, 0.0, 0.0)


class _Scan:
    def __init__(self, uid, pose):
        self.unique_id = uid
        self.state_id = uid
        self.laser = _Laser()
        self.corrected_pose = np.asarray(pose, np.float64)
        self.sensor_pose = self.corrected_pose

    def reference_pose(self, use_bc):
        return self.corrected_pose


class _MapperShell:
    def __init__(self, solver, config):
        self.solver = solver
        self.config = config
        self.stats = None


def _graph_with(pkg, poses, edge_pairs, cov_scale=1.0, seed=None):
    """A PoseGraph of package `pkg` with its solver over fake scans; edges
    carry the true relative pose with a covariance drawn from `seed`
    (identity times cov_scale without one)."""
    _, graph_cls, edge_cls, make_solver, config_cls, geo = PKGS[pkg]
    rng = None if seed is None else np.random.default_rng(seed)
    solver = make_solver()
    g = graph_cls.__new__(graph_cls)
    g.mapper = _MapperShell(solver, config_cls())
    g.vertices, g.edges, g.adjacency = {}, [], {}
    g._version = 0
    g.pose_revision = 0
    g._q_dirty = True
    g._q_xy_stale = "ALL"
    g._q_uid_to_idx = {}
    g._q_tombstones = 0
    scans = [_Scan(i, p) for i, p in enumerate(poses)]
    for s in scans:
        g.vertices.setdefault("fake", {})[s.state_id] = s
        g.adjacency[s.unique_id] = []
        solver.add_node(s.unique_id, s.corrected_pose)
    for a, b in edge_pairs:
        rel = np.asarray(geo.relative_pose(scans[a].corrected_pose,
                                           scans[b].corrected_pose))
        if rng is not None:
            q = rng.normal(0, 0.3, (3, 3))
            cov = cov_scale * (q @ q.T + np.eye(3) * 0.05)
        else:
            cov = np.eye(3) * cov_scale
        e = edge_cls.__new__(edge_cls)
        e.source, e.target = scans[a], scans[b]
        e.rel_pose, e.covariance = rel, cov
        e._list_idx = len(g.edges)
        g.edges.append(e)
        g.adjacency[scans[a].unique_id].append(e)
        g.adjacency[scans[b].unique_id].append(e)
        solver.add_constraint(scans[a].unique_id, scans[b].unique_id,
                              rel, cov)
    return g, solver, scans


def _ring(n=8):
    true = [np.array([np.cos(t), np.sin(t), t + 0.5])
            for t in np.linspace(0, 2 * np.pi * (n - 1) / n, n)]
    pairs = [(i, i + 1) for i in range(n - 1)] + [(0, n - 1), (2, 6)]
    return true, pairs


def _factor_ids(factors):
    return [(a.unique_id, b.unique_id) for a, b, _, _ in factors]


@pytest.mark.parametrize("uid", [1, 2, 4, 6], ids=lambda u: f"node{u}")
def test_marginal_factors_match_jax(uid):
    """The factors replacing one node of the ring (degree 2 and degree 3,
    parallel-edge dedup by covariance trace, the chain's inflation):
    endpoints equal, rel and cov within 1e-12."""
    poses, pairs = _ring()
    out = {}
    for pkg in PKGS:
        g, _, scans = _graph_with(pkg, poses, pairs, cov_scale=0.02, seed=0)
        out[pkg] = PKGS[pkg][0].marginal_factors(g, scans[uid])
    assert _factor_ids(out["torch"]) == _factor_ids(out["jax"])
    assert len(out["torch"]) >= 1
    for (_, _, rt, ct), (_, _, rj, cj) in zip(out["torch"], out["jax"]):
        np.testing.assert_allclose(rt, rj, rtol=0, atol=1e-12)
        np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-12)


def test_compose_with_cov_matches_jax():
    rng = np.random.default_rng(5)
    for _ in range(20):
        r1, r2 = rng.normal(0, 1, 3), rng.normal(0, 1, 3)
        q1, q2 = rng.normal(0, 0.2, (3, 3)), rng.normal(0, 0.2, (3, 3))
        c1, c2 = q1 @ q1.T, q2 @ q2.T
        for a, b in zip(tmarg.compose_with_cov(r1, c1, r2, c2),
                        jmarg.compose_with_cov(r1, c1, r2, c2)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


@pytest.mark.parametrize("marginalize", [True, False],
                         ids=["marginalized", "deleted"])
def test_solve_after_removal_matches_jax(marginalize):
    """test_marginal.test_marginalized_solve_matches_full in both
    packages: remove node 4 of the ring (marginalized or deleted), add a
    perturbing edge, solve; the survivors' poses equal the JAX solve's
    within 1e-6 m, and marginalizing keeps them closer to the full
    graph's solution than deleting does."""
    poses, pairs = _ring()

    def solve(pkg, remove_uid=None, marg=False):
        g, solver, scans = _graph_with(pkg, poses, pairs, cov_scale=0.01,
                                       seed=3)
        if remove_uid is not None:
            if marg:
                PKGS[pkg][0].marginalize_and_remove(g, scans[remove_uid])
            else:
                g.remove_vertex(scans[remove_uid])
        rel = np.asarray(PKGS[pkg][5].relative_pose(poses[1], poses[5]))
        solver.add_constraint(1, 5, rel + np.array([0.05, -0.04, 0.02]),
                              np.eye(3) * 0.01)
        return dict(solver.compute()), len(g.edges), solver.n_edges

    got, ne_t, se_t = solve("torch", 4, marginalize)
    ref, ne_j, se_j = solve("jax", 4, marginalize)
    assert sorted(got) == sorted(ref) and 4 not in got
    assert (ne_t, se_t) == (ne_j, se_j)
    for uid in ref:
        assert np.hypot(*(got[uid][:2] - ref[uid][:2])) < 1e-6, uid
        assert abs(got[uid][2] - ref[uid][2]) < 1e-6, uid
    if marginalize:
        full, _, _ = solve("torch")
        dele, _, _ = solve("torch", 4, False)
        err_m = max(np.linalg.norm(got[u][:2] - full[u][:2]) for u in got)
        err_d = max(np.linalg.norm(dele[u][:2] - full[u][:2]) for u in got)
        assert err_m <= err_d + 1e-12 and err_m < 0.02, (err_m, err_d)


def test_duplicate_pair_skipped_as_in_jax():
    """A factor whose endpoints are already linked is dropped, not added
    twice, in both packages."""
    poses = [np.zeros(3), np.array([1.0, 0, 0]), np.array([2.0, 0, 0])]
    counts = {}
    for pkg in PKGS:
        g, solver, scans = _graph_with(pkg, poses, [(0, 1), (1, 2), (0, 2)])
        PKGS[pkg][0].marginalize_and_remove(g, scans[1])
        counts[pkg] = (len(g.edges), solver.n_edges)
    assert counts["torch"] == counts["jax"] == (1, 1)


def test_mapper_removal_marginalizes_as_in_jax():
    """Mapper.remove_node_from_graph with marginalize_on_removal on a real
    mapper (no scan matching, a chain with one cross link): the same edges
    remain, the composed factor's rel and cov equal the JAX one's to
    1e-12, and both count one marginal factor."""
    from slam_toolbox_tpu.core.scan import LaserConfig as JaxLaser
    from slam_toolbox_tpu.core.scan import LocalizedScan as JaxScan
    from slam_toolbox_tpu_torch.core.scan import LocalizedScan as TorchScan

    laser = JaxLaser(min_range=0.05, max_range=12.0, range_threshold=10.0,
                     angular_resolution=np.deg2rad(2.0))
    cfg = JaxConfig(use_scan_matching=False, marginalize_on_removal=True)
    rng = np.random.default_rng(9)
    poses = np.cumsum(rng.normal([0.4, 0.1, 0.05], 0.05, (6, 3)), axis=0)
    ranges = rng.uniform(1.0, 5.0, laser.n_beams)
    out = {}
    for pkg in PKGS:
        if pkg == "jax":
            m, las, scan_cls = JaxMapper(cfg), laser, JaxScan
        else:
            m = TorchMapper(config_from_dict(dataclasses.asdict(cfg)),
                            device="cpu")
            las, scan_cls = laser_from_dict(dataclasses.asdict(laser)), \
                TorchScan
        m.stats.enabled = True
        m.initialize(las.range_threshold)
        scans = []
        for i, p in enumerate(poses):
            s = scan_cls(las, ranges, p, time=float(i))
            m.sensor_manager.add_scan(s)
            m.graph.add_vertex(s)
            if scans:
                m.graph.link_scans(scans[-1], s, s.sensor_pose,
                                   np.diag([1e-3, 1e-3, 1e-4]))
            scans.append(s)
        m.graph.link_scans(scans[1], scans[4], scans[4].sensor_pose,
                           np.diag([4e-3, 4e-3, 4e-4]))
        m.remove_node_from_graph(scans[2])
        out[pkg] = (
            [(e.source.unique_id, e.target.unique_id, e.rel_pose,
              e.covariance) for e in m.graph.edges],
            m.solver.n_nodes, m.solver.n_edges,
            m.stats.counts["marginal_factor_added"])
    got, ref = out["torch"], out["jax"]
    assert got[1:] == ref[1:] and got[3] == 1
    assert [e[:2] for e in got[0]] == [e[:2] for e in ref[0]]
    assert (1, 3) in [e[:2] for e in got[0]]
    for a, b in zip(got[0], ref[0]):
        np.testing.assert_allclose(a[2], b[2], rtol=0, atol=1e-12)
        np.testing.assert_allclose(a[3], b[3], rtol=0, atol=1e-12)
