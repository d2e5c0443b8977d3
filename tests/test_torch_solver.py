"""The port's pose-graph solver against the JAX package's on one graph,
carried across with interop.solver_from_arrays: the host block-sparse path
(identical f64 arithmetic) to 1e-9, the dense f32 device path to 1e-4.
Then the port's own host route: the native assembly bit-equal to its NumPy
twins, the resident edge and pose arrays read back as the dict of edges
they stand for, and whole solves equal to a fresh solver's and to the
NumPy assembly's."""
import numpy as np
import pytest

from slam_toolbox_tpu.core.params import SolverConfig as JaxSolverConfig
from slam_toolbox_tpu.solver.se2_solver import (
    PoseGraphSolver as JaxSolver, _sqrt_info_3x3 as jax_sqrt_info,
)
from slam_toolbox_tpu_torch import native
from slam_toolbox_tpu_torch.core.params import SolverConfig
from slam_toolbox_tpu_torch.interop import solver_from_arrays
from slam_toolbox_tpu_torch.solver import se2_solver as ts


def _graph(seed, n=60, n_loops=8):
    """A noisy odometry chain around a loop plus a few loop closures."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    truth = np.stack([4 * np.cos(t), 3 * np.sin(t), t + np.pi / 2], 1)

    def rel(a, b):
        c, s = np.cos(a[2]), np.sin(a[2])
        d = b[:2] - a[:2]
        h = np.arctan2(np.sin(b[2] - a[2]), np.cos(b[2] - a[2]))
        return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1], h])

    cov = np.diag([0.01, 0.01, 0.003])
    edges = []
    for i in range(n - 1):
        edges.append((i, i + 1, rel(truth[i], truth[i + 1])
                      + rng.normal(0, [0.02, 0.02, 0.01]), cov))
    for _ in range(n_loops):
        i, j = sorted(rng.choice(n, 2, replace=False))
        edges.append((int(i), int(j), rel(truth[i], truth[j])
                      + rng.normal(0, [0.01, 0.01, 0.005]), cov * 0.5))
    # initial guess: dead reckoning of the noisy odometry
    poses = [truth[0]]
    for _, _, r, _ in edges[: n - 1]:
        p = poses[-1]
        c, s = np.cos(p[2]), np.sin(p[2])
        poses.append(np.array([p[0] + c * r[0] - s * r[1],
                               p[1] + s * r[0] + c * r[1], p[2] + r[2]]))
    return list(range(100, 100 + n)), np.stack(poses), [
        (100 + i, 100 + j, r, c) for i, j, r, c in edges]


def _jax_solver(ids, poses, edges, cfg):
    s = JaxSolver(cfg)
    for i, p in zip(ids, poses):
        s.add_node(i, p)
    for a, b, r, c in edges:
        s.add_constraint(a, b, r, c)
    return s


def _solve_both(seed, **cfg_kw):
    ids, poses, edges = _graph(seed)
    ref = dict(_jax_solver(ids, poses, edges,
                           JaxSolverConfig(**cfg_kw)).compute())
    got = dict(solver_from_arrays(ids, poses, edges,
                                  SolverConfig(**cfg_kw),
                                  device="cpu").compute())
    assert sorted(ref) == sorted(got) == ids
    return (np.stack([ref[i] for i in ids]), np.stack([got[i] for i in ids]),
            poses)


@pytest.mark.parametrize("seed", [0, 1])
def test_host_sparse_matches_jax(seed):
    ref, got, init = _solve_both(seed)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9)
    assert np.max(np.abs(ref - init)) > 1e-3  # the solve moved the graph


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_matches_jax(seed):
    ref, got, init = _solve_both(seed, host_sparse_min_nodes=10 ** 9)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    assert np.max(np.abs(ref - init)) > 1e-3


def test_sqrt_info_matches_jax():
    rng = np.random.default_rng(4)
    for _ in range(20):
        a = rng.normal(size=(3, 3))
        cov = a @ a.T + 0.1 * np.eye(3)
        np.testing.assert_array_equal(ts._sqrt_info_3x3(cov),
                                      jax_sqrt_info(cov))


def test_past_dense_ceiling_without_native_raises(monkeypatch):
    """Past the dense ceiling without the native library compute() runs
    the PCG tier (padded to 4,096 nodes, so the PCR chain preconditioner)
    and matches the JAX package's compute(), which runs its lm_solve on
    the same padded inputs, to 1e-4. (The name is the old one, kept: the
    port raised here before it had the tier.)"""
    from slam_toolbox_tpu import native as jax_native

    n = ts.DENSE_MAX_NODES + 1
    s = ts.PoseGraphSolver(device="cpu")
    sj = JaxSolver(JaxSolverConfig())
    for i in range(n):
        s.add_node(i, [0.1 * i, 0.0, 0.0])
        sj.add_node(i, [0.1 * i, 0.0, 0.0])
    s.add_constraint(0, 1, [0.12, 0.01, 0.02], np.eye(3) * 1e-2)
    sj.add_constraint(0, 1, [0.12, 0.01, 0.02], np.eye(3) * 1e-2)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    got, ref = dict(s.compute()), dict(sj.compute())
    assert s.last_stats["tier"] == "pcg"
    got = np.stack([got[i] for i in range(n)])
    ref = np.stack([ref[i] for i in range(n)])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1], [0.12, 0.01, 0.02], atol=1e-4)


# -- the native assembly ----------------------------------------------------

def _random_edges(rng, n, e, parallel=0):
    """e random edges over n nodes (src may equal dst), `parallel` of
    them repeating an earlier edge's endpoints."""
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    for k in range(e - parallel, e):
        j = int(rng.integers(0, max(e - parallel, 1)))
        src[k], dst[k] = src[j], dst[j]
    rel = rng.normal(size=(e, 3)) * [1.0, 1.0, 2.0]
    si = np.stack([ts._sqrt_info_3x3(a @ a.T + 0.05 * np.eye(3))
                   for a in rng.normal(size=(e, 3, 3))])
    return src, dst, rel, si


@pytest.mark.parametrize("case", ["random", "parallel", "single",
                                  "isolated", "wide"])
@pytest.mark.parametrize("seed", [0, 1])
def test_native_assembly_is_the_numpy_twins(case, seed):
    """native.normal_blocks and native.chi2 equal _np_normal_blocks and
    _np_chi2 bit for bit: same IEEE operations in the same order, NumPy's
    own trig passed in. `isolated` leaves nodes without an edge, `wide`
    puts headings far past pi, so the residual wraps; host_sparse_lm's
    gauge and non-free rows enter after the assembly, and
    test_native_lm_takes_the_numpy_steps covers them."""
    rng = np.random.default_rng(seed)
    n, e, parallel = {"random": (40, 150, 0), "parallel": (12, 60, 30),
                      "single": (2, 1, 0), "isolated": (300, 40, 5),
                      "wide": (50, 200, 10)}[case]
    poses = rng.normal(size=(n, 3)) * [8.0, 8.0, 3.0]
    if case == "wide":
        poses[:, 2] *= 10.0
    src, dst, rel, si = _random_edges(rng, n, e, parallel)
    trig = ts._edge_trig(poses, src, dst, rel)
    ref = ts._np_normal_blocks(poses, src, dst, rel, si)
    got = native.normal_blocks(poses, src, dst, rel, si, trig)
    for r, g in zip(ref[:3], got[:3]):
        assert r.shape == g.shape
        np.testing.assert_array_equal(g, r)
    assert got[3] == ref[3] == ts._np_chi2(poses, src, dst, rel, si)
    assert native.chi2(poses, src, dst, rel, si, trig) == ref[3]


@pytest.mark.parametrize("bad", ["node_past_end", "negative_node",
                                 "short_rel", "short_trig"])
def test_native_assembly_refuses_edges_it_cannot_read(bad):
    """The binding checks shapes and node indices before it hands the
    native pass a pointer."""
    rng = np.random.default_rng(2)
    poses = rng.normal(size=(5, 3))
    src, dst, rel, si = _random_edges(rng, 5, 8)
    trig = ts._edge_trig(poses, src, dst, rel)
    if bad == "node_past_end":
        src = src.copy()
        src[3] = 5
    elif bad == "negative_node":
        dst = dst.copy()
        dst[0] = -1
    elif bad == "short_rel":
        rel = rel[:7]
    else:
        trig = (trig[0][:7],) + trig[1:]
    for f in (native.normal_blocks, native.chi2):
        with pytest.raises(ValueError):
            f(poses, src, dst, rel, si, trig)


# -- the resident arrays ----------------------------------------------------

COV = np.diag([0.01, 0.02, 0.005])


def _rows(s):
    """The solver's live edge rows in row order, read back as
    (key, rel, sqrt_info), and its nodes as {id: pose}."""
    live = np.flatnonzero(s._alive[:s._ne])
    rows = [((s._ids[s._src[k]], s._ids[s._dst[k]]), s._rel[k],
             s._sqrt_info[k]) for k in live]
    nodes = {i: s._poses[r] for i, r in s._id_to_idx.items()}
    return rows, nodes


def _assert_holds(s, edges, nodes):
    """`s` holds the plain dict `edges` {key: (rel, sqrt_info)} in its
    order, and the node poses `nodes`."""
    rows, got_nodes = _rows(s)
    assert [k for k, _, _ in rows] == list(edges) == list(s._edge_row)
    for (k, rel, si), (rel_d, si_d) in zip(rows, edges.values()):
        np.testing.assert_array_equal(rel, rel_d)
        np.testing.assert_array_equal(si, si_d)
    assert [s._edge_row[k] for k, _, _ in rows] == list(
        np.flatnonzero(s._alive[:s._ne]))
    assert sorted(got_nodes) == sorted(nodes) == sorted(s._ids)
    for i, p in nodes.items():
        np.testing.assert_array_equal(got_nodes[i], p)
    assert s._ids == [s._ids[r] for r in range(len(s._ids))]
    assert all(s._id_to_idx[i] == r for r, i in enumerate(s._ids))
    assert s._first_id == (s._ids[0] if s._ids else None)
    assert s.n_nodes == len(nodes) and s.n_edges == len(edges)
    # every live edge is listed at both its node rows, and only there
    at = {}
    for r, keys in enumerate(s._node_edges):
        for k in keys:
            at.setdefault(k, set()).add(r)
    assert at == {k: {s._id_to_idx[k[0]], s._id_to_idx[k[1]]}
                  for k in edges}


class DictModel:
    """The plain dict of edges and nodes the solver's arrays stand for."""

    def __init__(self, solver):
        self.s, self.edges, self.nodes = solver, {}, {}

    def node(self, i, pose):
        self.s.add_node(i, pose)
        self.nodes.setdefault(i, np.asarray(pose, np.float64))

    def edge(self, a, b, rel):
        ok = self.s.add_constraint(a, b, rel, COV)
        if a in self.nodes and b in self.nodes and (b, a) not in self.edges:
            self.edges[(a, b)] = (np.asarray(rel, np.float64),
                                  ts._sqrt_info_3x3(COV))
            assert ok
        else:
            assert not ok

    def unlink(self, a, b):
        self.s.remove_constraint(a, b)
        self.edges.pop((a, b), None)
        self.edges.pop((b, a), None)

    def drop(self, i):
        for k in [k for k in self.edges if i in k]:
            self.unlink(*k)
        self.s.remove_node(i)
        self.nodes.pop(i, None)


def _lap_poses(n):
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.stack([4 * np.cos(t), 3 * np.sin(t), t + np.pi / 2], 1)


def _sequence(seed):
    """A solver through add, overwrite, remove, swap-with-last, re-add,
    growth past the first capacities (64 node and 128 edge rows) and
    compaction, checked against the dict after every step."""
    rng = np.random.default_rng(seed)
    s = ts.PoseGraphSolver(device="cpu")
    m = DictModel(s)
    n = 70
    truth = _lap_poses(n)
    noisy = truth + rng.normal(0, [0.05, 0.05, 0.02], truth.shape)

    def rel(a, b):
        return (truth[b] - truth[a]) + rng.normal(0, 0.01, 3)

    steps = [("node", i) for i in range(n)]
    steps += [("edge", i, i + 1) for i in range(n - 1)]
    for i in range(0, n - 4, 2):
        steps += [("edge", i, i + 4), ("edge", i + 3, i)]
    steps += [("edge", 5, 4),                 # reversed duplicate: refused
              ("edge", 3, 4),                 # overwrite in place
              ("edge", 99, 4),                # unknown node: refused
              ("edge", 7, 7),                 # self loop
              ("edge", 7, 7),                 # self loop again: refused
              ("unlink", 10, 11), ("unlink", 14, 10),  # either direction
              ("edge", 10, 11),               # re-added: a new last row
              ("drop", 0),                    # the gauge: last row moves in
              ("drop", 17), ("drop", n - 1), ("drop", n - 2),
              ("node", 17), ("edge", 17, 16), ("edge", 18, 17),
              ("edge", 6, 8), ("edge", 6, 8)]
    steps += [("drop", i) for i in range(20, 30)]
    steps += [("unlink", i, i + 1) for i in range(30, n - 3)]
    for i in range(20, 24):
        steps += [("node", i), ("edge", i, 19)]
    # dead rows left for the solve to compact
    steps += [("unlink", 1, 2), ("unlink", 2, 3)]
    rows, compactions = s._ne, 0
    for st in steps:
        if st[0] == "node":
            m.node(st[1], noisy[st[1]])
        elif st[0] == "edge":
            m.edge(st[1], st[2], rel(st[1] % n, st[2] % n))
        elif st[0] == "unlink":
            m.unlink(st[1], st[2])
        else:
            m.drop(st[1])
        _assert_holds(s, m.edges, m.nodes)
        compactions += s._ne < rows
        rows = s._ne
    assert len(s._alive) > 128 and len(s._poses) > 64 and compactions
    return s, m


@pytest.mark.parametrize("seed", [0, 1])
def test_resident_arrays_hold_the_dict_of_edges(seed):
    s, m = _sequence(seed)
    assert s._n_dead > 0       # the last unlinks are still dead rows
    nodes, edges = s.get_graph()
    assert edges == list(m.edges)
    # reads are copies: nothing handed out is a view of the resident rows
    p = s.get_node_pose(s._ids[3])
    p[:] = 1e9
    g = nodes[s._ids[3]]
    g[:] = 1e9
    assert not np.any(s._poses[:s.n_nodes] == 1e9)
    corr = s.compute()
    assert s._n_dead == 0 and s._ne == len(m.edges)  # compacted
    _assert_holds(s, m.edges, {i: p for i, p in corr})
    for _, p in corr:
        assert not np.shares_memory(p, s._poses)


def _fresh(s):
    """A solver fed the same graph anew: nodes in row order (so the same
    gauge), edges in the dict's order."""
    f = ts.PoseGraphSolver(device="cpu")
    for i in s._ids:
        f.add_node(i, s.get_node_pose(i))
    for (a, b), k in s._edge_row.items():
        assert f.add_constraint(a, b, s._rel[k], COV)
        np.testing.assert_array_equal(f._sqrt_info[f._edge_row[(a, b)]],
                                      s._sqrt_info[k])
    return f


@pytest.mark.parametrize("route", ["compute", "window"])
def test_resident_solves_equal_a_fresh_solver(route):
    s, _ = _sequence(2)
    f = _fresh(s)
    if route == "compute":
        got, ref = dict(s.compute()), dict(f.compute())
        assert s.last_stats["lm_iters"] > 0
    else:
        active = [i for i in s._ids if 5 <= i <= 14]
        before = {i: s.get_node_pose(i) for i in s._ids}
        got = dict(s.compute_window(active))
        ref = dict(f.compute_window(active))
        assert s.last_stats["window"] and s.last_stats["lm_iters"] > 0
        assert sorted(got) == sorted(active)
        # the anchors and the rest of the graph stay where they were
        for i in s._ids:
            if i not in got:
                np.testing.assert_array_equal(s.get_node_pose(i), before[i])
    assert sorted(got) == sorted(ref)
    for i in got:
        np.testing.assert_array_equal(got[i], ref[i])
    # the write-back: every node where the fresh solver put it
    for i in s._ids:
        np.testing.assert_array_equal(s.get_node_pose(i),
                                      f.get_node_pose(i))


# -- a whole solve, native assembly against NumPy's ---------------------------

def _laps_graph(laps=40, per_lap=25, seed=3):
    """A 40-lap graph of laps * per_lap nodes: each node linked to the one
    before it and to one or two nodes of the previous lap (2.4 edges a
    node), started from dead reckoning of the noisy odometry."""
    rng = np.random.default_rng(seed)
    lap = _lap_poses(per_lap)
    truth = np.concatenate([lap + rng.normal(0, [0.02, 0.02, 0.0], lap.shape)
                            for _ in range(laps)])
    truth[:, 2] += 2 * np.pi * np.repeat(np.arange(laps), per_lap)

    def rel(a, b, sd):
        c, s_ = np.cos(truth[a, 2]), np.sin(truth[a, 2])
        d = truth[b, :2] - truth[a, :2]
        h = np.arctan2(np.sin(truth[b, 2] - truth[a, 2]),
                       np.cos(truth[b, 2] - truth[a, 2]))
        return np.array([c * d[0] + s_ * d[1], -s_ * d[0] + c * d[1], h]) \
            + rng.normal(0, sd)

    n = laps * per_lap
    edges = [(i, i + 1, rel(i, i + 1, [0.02, 0.02, 0.01]))
             for i in range(n - 1)]
    for i in range(per_lap, n):
        for off in ((0, 1) if rng.random() < 0.4 else (0,)):
            j = i - per_lap + off
            edges.append((i, j, rel(i, j, [0.01, 0.01, 0.005])))
    poses = [truth[0]]
    for _, _, r in edges[: n - 1]:
        p = poses[-1]
        c, s_ = np.cos(p[2]), np.sin(p[2])
        poses.append(np.array([p[0] + c * r[0] - s_ * r[1],
                               p[1] + s_ * r[0] + c * r[1], p[2] + r[2]]))
    src = np.array([a for a, _, _ in edges])
    dst = np.array([b for _, b, _ in edges])
    rels = np.stack([r for _, _, r in edges])
    si = np.tile(ts._sqrt_info_3x3(COV), (len(edges), 1, 1))
    return np.stack(poses), src, dst, rels, si


def _recorded_lm(monkeypatch, poses, src, dst, rel, si, free, numpy_twins):
    """host_sparse_lm with the native assembly or the NumPy twins in its
    place; returns its result and the chi2 of every pose set it tried."""
    seen = []
    if numpy_twins:
        def nb(p, s_, d, r, q, trig):
            return ts._np_normal_blocks(p, s_, d, r, q)

        def c2(p, s_, d, r, q, trig):
            seen.append(ts._np_chi2(p, s_, d, r, q))
            return seen[-1]
    else:
        real_c2 = native.chi2
        nb = native.normal_blocks

        def c2(*a):
            seen.append(real_c2(*a))
            return seen[-1]
    with monkeypatch.context() as mp:
        mp.setattr(native, "normal_blocks", nb)
        mp.setattr(native, "chi2", c2)
        res = ts.host_sparse_lm(poses.copy(), src, dst, rel, si, free,
                                SolverConfig())
    return res, seen


def _verdicts(seen):
    """The LM's accept (True) / reject (False) of each tried step."""
    cur, out = seen[0], []
    for c in seen[1:]:
        out.append(c <= cur)
        if c <= cur:
            cur = c
    return out


def test_native_lm_takes_the_numpy_steps(monkeypatch):
    """A 1,000-node graph of 40 laps: host_sparse_lm with the native
    assembly takes the NumPy assembly's steps, accepts and rejects the
    same ones and ends on the same poses, bit for bit."""
    poses, src, dst, rel, si = _laps_graph()
    assert len(poses) == 1000 and 2.3 < len(src) / len(poses) < 2.5
    free = np.ones(len(poses))
    free[0] = 0.0
    (p_nat, c_nat, it_nat), seen_nat = _recorded_lm(
        monkeypatch, poses, src, dst, rel, si, free, numpy_twins=False)
    (p_np, c_np, it_np), seen_np = _recorded_lm(
        monkeypatch, poses, src, dst, rel, si, free, numpy_twins=True)
    assert it_nat == it_np >= 2
    assert len(seen_nat) == it_nat + 1
    assert seen_nat == seen_np
    assert _verdicts(seen_nat) == _verdicts(seen_np)
    assert c_nat == c_np < seen_nat[0]
    np.testing.assert_array_equal(p_nat, p_np)
    assert np.max(np.abs(p_nat - poses)) > 1e-2  # the solve moved them
