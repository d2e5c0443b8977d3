"""The reference's last device loops in the port, on the CPU: the CG loops
of solve_pcg, lm_solve's PCG step (its LMLoop's CGLoop) and the
distributed solve as chunked programs
(solver.se2_solver.CGLoop: CG_CHUNK masked iterations per program, one
host read per chunk) and the exact two-call match as programs
(kernels.match: the raster and each pass on static buffers).

Bit for bit: each CGLoop against the per-iteration loop the port ran
before (tests/torch_cg_reference.py) on the same operators, for the
block-Jacobi solve, the PCG step with PCR at 4,096 nodes and with Thomas, a
stop at every position of a chunk, budgets that are not a multiple of
the chunk, a zero-iteration stop and runs across restarts; the
distributed step's chunks at 1 and 2 gloo ranks, a stalled stop among
them; the exact match's programs against its fresh-tensor route.
Against JAX: odd CG budgets through js.solve_pcg, js.lm_solve at 4,096
nodes and jsd.distributed_lm_solve, within the bounds of
test_torch_chain_precond.py and test_torch_dist.py; the exact path within
test_torch_match.py's 1e-6 (1e-4 in position where every candidate ties,
as test_response_expansion_path holds it)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import slam_toolbox_tpu.dist.solver_dist as jsd
from slam_toolbox_tpu.solver import se2_solver as js
from slam_toolbox_tpu_torch.core.params import SolverConfig
from slam_toolbox_tpu_torch.dist import multihost
from slam_toolbox_tpu_torch.dist.solver_dist import distributed_lm_solve
from slam_toolbox_tpu_torch.kernels.match import Matcher
from slam_toolbox_tpu_torch.solver import chain_precond as cp
from slam_toolbox_tpu_torch.solver import se2_solver as ts
from test_torch_chain_precond import _normal, _padded, j, t
from test_torch_match import _matchers, _pack, _pair, scans  # noqa: F401
from test_torch_multihost import run_ranks, snake_inputs
from torch_cg_reference import lm_pcg_step, reference_cg

K = ts.CG_CHUNK

torch.set_num_threads(1)


def _ops(diag, hab, grad, src, dst, free, lam, route):
    """(mv, prec, b, stop factor) of the port's CG on these blocks, built
    as solve_pcg and lm_solve's PCG step build them."""
    n = diag.shape[0]
    diag_d = ts._damped(diag, lam)
    b = grad * free[:, None]

    def mv(x):
        return ts._hx(x, diag_d, hab, src, dst, free)

    if route == "jacobi":
        eye = torch.eye(3, dtype=diag.dtype)
        minv = torch.linalg.inv(diag_d + 1e-6 * eye)

        def prec(r):
            return torch.einsum("nij,nj->ni", minv, r) * free[:, None]
    else:
        U = cp.build_chain_offdiag(hab, src, dst, n, free)
        if route == "pcr":
            steps = int(math.ceil(math.log2(n))) + 1

            def prec(r):
                return cp.pcr_solve(diag_d, U, r, free, steps)
        else:
            fac = cp.factorize(diag_d, U, free)

            def prec(r):
                return cp.apply(*fac, r, free)
    return mv, prec, b, torch.clamp_min(torch.sum(b * b), 1e-30)


def _chunked(route, blocks, lam, cg_iters, cg_tol):
    diag, hab, grad, src, dst, free = blocks
    if route == "jacobi":
        x = ts.solve_pcg(diag, hab, grad, src, dst, free, lam, cg_iters,
                         cg_tol)
        return x, ts.solve_pcg.last_loop.state["i"].item()
    x, i, _ = lm_pcg_step(diag, hab, grad, src, dst, free, lam, cg_iters,
                          cg_tol)
    return x, i


def _check(route, blocks, lam, cg_iters, cg_tol):
    """The chunked loop against the reference loop, bit for bit; returns
    the reference's (iterations, r·r history)."""
    mv, prec, b, bb = _ops(*blocks, lam, route)
    period = None if route == "jacobi" else 64
    ref, n_ref, hist, _ = reference_cg(mv, prec, b, cg_tol * bb, cg_iters,
                                       period)
    got, n_got = _chunked(route, blocks, lam, cg_iters, cg_tol)
    assert n_got == n_ref
    assert torch.equal(got, ref), (route, cg_iters, cg_tol)
    return n_ref, hist


@pytest.fixture(scope="module")
def small():
    """The solver test's 60-node loop graph's normal blocks, f64."""
    _, (poses, src, dst, rel, si, free) = _normal()
    diag, hab, grad, _ = ts.build_normal_blocks(poses, src, dst, rel, si)
    return diag, hab, grad, src, dst, free


@pytest.fixture(scope="module")
def snake4k():
    """scripts/bench_dist.py's snake graph at 2,100 nodes, padded to 4,096
    as compute() pads it (f32): the PCR route."""
    from bench_dist import build_snake_graph

    _, init, edges = build_snake_graph(2100, aisle_len=60)
    args = _padded(init, edges, 4096, 4096)
    poses, src, dst, rel, si, em, free = args
    tt = (t(poses), t(src).long(), t(dst).long(), t(rel), t(si))
    diag, hab, grad, _ = ts.build_normal_blocks(*tt)
    return args, (diag, hab, grad, tt[1], tt[2], t(free))


@pytest.mark.parametrize("route,cg_iters,cg_tol,capped", [
    ("jacobi", 200, 1e-10, False),   # stops by tolerance, no restart
    ("jacobi", 13, 1e-24, True),     # a cap that is not a multiple of K
    ("thomas", 200, 1e-24, False),   # Thomas to convergence
    ("thomas", 21, 1e-24, True),
])
def test_chunked_cg_equals_reference(small, route, cg_iters, cg_tol, capped):
    n, _ = _check(route, small, 1e-3, cg_iters, cg_tol)
    assert 0 < n <= cg_iters and (n == cg_iters) == capped


@pytest.mark.parametrize("cg_iters,cg_tol", [
    (70, 1e-14),    # across the restart at iteration 63, stopped at a cap
    (37, 1e-14),    # a cap that is not a multiple of K
    (200, 1e-6),    # stopped by tolerance
])
def test_pcg_step_pcr_equals_reference(snake4k, cg_iters, cg_tol):
    _, blocks = snake4k
    n, _ = _check("pcr", blocks, 1e-4, cg_iters, cg_tol)
    if cg_tol < 1e-10:
        assert n == cg_iters


def test_stop_at_every_chunk_position(small):
    """cg_tol chosen from the reference's residual history so the loop
    stops at each of the K positions of a chunk: the chunked loop stops
    at the same iteration with the same x."""
    mv, prec, b, bb = _ops(*small, 1e-3, "jacobi")
    _, _, hist, _ = reference_cg(mv, prec, b, 1e-24 * bb, 300)
    targets = {}
    for s in range(K, len(hist)):
        if hist[s] < min(hist[:s]) and s % K not in targets:
            targets[s % K] = s
    assert sorted(targets) == list(range(K))
    for s in targets.values():
        stop = 0.5 * (hist[s] + min(hist[:s]))
        n, _ = _check("jacobi", small, 1e-3, 300, stop / float(bb))
        assert n == s


@pytest.mark.parametrize("route", ["jacobi", "thomas"])
def test_zero_iteration_stop(small, route):
    """b = 0: the loop stops before its first iteration; one chunk, all
    masked, and x = 0."""
    diag, hab, grad, src, dst, free = small
    blocks = (diag, hab, torch.zeros_like(grad), src, dst, free)
    n, _ = _check(route, blocks, 1e-3, 200, 1e-10)
    assert n == 0
    x, _ = _chunked(route, blocks, 1e-3, 200, 1e-10)
    assert not x.any()


def test_host_reads_per_lm_step(snake4k, monkeypatch):
    """lm_solve's PCG tier on the CPU runs the device loop's functions
    from a Python loop: it reads the LM loop's flag before each LM step
    and once after the last, the CG loop's flag before each chunk and
    once after the last, and the results once, 2 + sum(ceil(iters / K) +
    2) reads in all (on a card one read: the card tests)."""
    args, _ = snake4k
    poses, src, dst, rel, si, em, free = args
    reads = [0]
    read = ts._host_read

    def counted(x):
        reads[0] += 1
        return read(x)

    monkeypatch.setattr(ts, "_host_read", counted)
    _, _, it = ts.lm_solve(
        t(poses), t(src).long(), t(dst).long(), t(rel), t(si), t(free),
        1e-4, 1e-3, 1e-10, 1e-10, 3, cg_tol=1e-6, cg_iters=45)
    stats = ts.lm_solve.last_stats
    cg_log, chunks = stats["cg_iters"], stats["cg_chunks"]
    assert len(cg_log) == it == 3 and all(c > 0 for c in cg_log)
    assert chunks == [math.ceil(c / K) for c in cg_log]
    assert stats["tier"] == "pcr" and stats["route"] == "host loop"
    assert reads[0] == stats["host_reads"] == 2 + sum(
        c + 2 for c in chunks), (reads, cg_log)


def test_odd_budgets_match_jax(small, snake4k):
    """js.solve_pcg and js.lm_solve at 4,096 nodes with CG budgets that are
    not a multiple of K, against the port: test_solve_pcg_matches_jax's
    1e-4 and test_lm_solve_pcr_tier_matches_jax's 1e-3 m / 1e-3 rad / 1%
    chi2, the same LM iterations."""
    (poses, src, dst, rel, si, em, free), _ = _normal()
    n = len(poses)
    diag, hab, grad, _ = js.build_normal_blocks(
        j(poses), j(src), j(dst), j(rel), j(si), j(em), n_nodes=n)
    ref = np.asarray(js.solve_pcg(diag, hab, grad, j(src), j(dst), j(free),
                                  jnp.float32(1e-3), cg_iters=29,
                                  cg_tol=jnp.float32(1e-10)))
    got = ts.solve_pcg(t(np.asarray(diag)), t(np.asarray(hab)),
                       t(np.asarray(grad)), t(src).long(), t(dst).long(),
                       t(free), 1e-3, 29, 1e-10).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)

    args, _ = snake4k
    poses, src, dst, rel, si, em, free = args
    cfg = SolverConfig()
    scal = [np.float32(v) for v in (cfg.initial_lm_lambda,
                                    cfg.function_tolerance,
                                    cfg.gradient_tolerance,
                                    cfg.parameter_tolerance,
                                    cfg.cg_tolerance)]
    ref, chi2_ref, it_ref = js.lm_solve(
        *map(j, args), *map(jnp.float32, scal), n_nodes=4096,
        max_iterations=3, cg_iters=37)
    got, chi2, it = ts.lm_solve(
        t(poses), t(src).long(), t(dst).long(), t(rel), t(si), t(free),
        *map(float, scal[:4]), 3, cg_tol=float(scal[4]), cg_iters=37)
    ref, got = np.asarray(ref)[:2100], got.numpy()[:2100]
    assert int(it) == int(it_ref)
    np.testing.assert_allclose(got[:, :2], ref[:, :2], rtol=0, atol=1e-3)
    dh = got[:, 2] - ref[:, 2]
    assert np.abs(np.arctan2(np.sin(dh), np.cos(dh))).max() < 1e-3
    assert abs(float(chi2) - float(chi2_ref)) <= 0.01 * float(chi2_ref)


@pytest.mark.parametrize("period", [16, 64])
def test_device_restart_equals_reference(small, period):
    """The device loop's chunk, which picks its restart on the device
    ((i % period) == period - 1, one body for every chunk), run from the
    CPU's Python loop across restarts: x and the iterations bit-equal to
    the reference loop and to the chunked route's static restarts
    (run_eager)."""
    mv, prec, b, bb = _ops(*small, 1e-3, "jacobi")
    stop = 1e-26 * bb
    ref, n_ref, _, _ = reference_cg(mv, prec, b, stop, 150, period)
    assert n_ref > 64   # past a restart at either period

    def ops(t):
        return mv, prec

    inputs = dict(b=b, stop=stop)
    loop = ts.CGLoop(inputs, ops, 150, period=period, device_loop=True)
    x, n = loop.run(inputs)
    assert n == n_ref and torch.equal(x, ref)
    assert loop.chunks == math.ceil(n / K)
    x_e, n_e = loop.run_eager(inputs)
    assert n_e == n and torch.equal(x_e, x)


def test_lm_loop_keeps_one_bucket_per_tier(monkeypatch):
    """lm_loop keeps each tier's last bucket: the same bucket gives the
    same LMLoop; a bucket of another shape in the same tier replaces it
    and closes the old one, its program and its CG loop's programs
    closed and dropped; the other tiers keep theirs."""
    class Program:
        def __init__(self):
            self.closed = False

        def close(self):
            self.closed = True

    monkeypatch.setattr(ts, "_LM_LOOPS", {})
    bucket = ("thomas", 300, 512, torch.float64, "cpu", 4, 40)
    old = ts.lm_loop(*bucket)
    dense = ts.lm_loop("dense", 256, 512, torch.float32, "cpu", 4, 40)
    assert ts.lm_loop(*bucket) is old
    progs = [Program(), Program()]
    old.program, old.cg.programs["while"] = progs
    new = ts.lm_loop(*bucket[:5], 1, 40)
    assert new is not old and all(p.closed for p in progs)
    assert old.program is None and old.cg.programs == {}
    assert ts._LM_LOOPS == {"thomas": new, "dense": dense}


def _lm_args(args):
    poses, src, dst, rel, si, em, free = args
    return (t(poses), t(src).long(), t(dst).long(), t(rel), t(si), t(free))


def _scalars():
    cfg = SolverConfig()
    return cfg, [np.float32(v) for v in (
        cfg.initial_lm_lambda, cfg.function_tolerance, cfg.gradient_tolerance,
        cfg.parameter_tolerance, cfg.cg_tolerance)]


def _both_lm(args, n_nodes, max_iterations, cg_iters):
    """js.lm_solve and the port's on the same arrays."""
    _, scal = _scalars()
    ref = js.lm_solve(*map(j, args), *map(jnp.float32, scal),
                      n_nodes=n_nodes, max_iterations=max_iterations,
                      cg_iters=cg_iters)
    got = ts.lm_solve(*_lm_args(args), *map(float, scal[:4]),
                      max_iterations, cg_tol=float(scal[4]),
                      cg_iters=cg_iters)
    return ref, got


def _fault_graph(scale_edge):
    """The solver test's 40-node graph padded as compute() pads it (256
    nodes, 512 edges), f32, edge 5's sqrt_info changed by
    `scale_edge`."""
    from test_torch_solver import _graph

    _, poses, edges = _graph(0, n=40)
    args = list(_padded(poses, [(a - 100, b - 100, r, c)
                                for a, b, r, c in edges], 256, 512))
    args[4] = args[4].copy()
    scale_edge(args[4][5])
    return args


def test_dense_nan_weight_rejects_every_step():
    """A NaN in one edge's sqrt_info: the dense factorization fails on
    every LM step, which gives a NaN step as JAX's Cholesky does (the
    port raised from torch.linalg.cholesky before); every step is
    rejected in both until lambda reaches its cap: the same iterations,
    chi2 NaN, the input's poses."""
    def nan(si):
        si[0, 0] = np.nan

    args = _fault_graph(nan)
    cfg, _ = _scalars()
    (ref, chi2_ref, it_ref), (got, chi2, it) = _both_lm(
        args, 256, cfg.max_iterations, cfg.cg_max_iterations)
    assert int(it_ref) == it == 11
    assert np.isnan(float(chi2_ref)) and np.isnan(float(chi2))
    np.testing.assert_array_equal(got.numpy(), args[0])
    np.testing.assert_array_equal(np.asarray(ref), args[0])
    assert ts.lm_solve.last_stats["tier"] == "dense"


def test_dense_huge_weight_returns(capsys):
    """One edge's sqrt_info scaled by 1e19 (its normal blocks overflow
    f32): the port returns without raising, with finite poses; its
    iterations and chi2 are printed beside JAX's (with -s)."""
    def huge(si):
        si *= np.float32(1e19)

    args = _fault_graph(huge)
    cfg, _ = _scalars()
    (ref, chi2_ref, it_ref), (got, chi2, it) = _both_lm(
        args, 256, cfg.max_iterations, cfg.cg_max_iterations)
    with capsys.disabled():
        print(f"\n# 1e19 weight: port {it} LM steps, chi2 {float(chi2)}; "
              f"JAX {int(it_ref)} LM steps, chi2 {float(chi2_ref)}")
    assert torch.isfinite(got).all() and it >= 1
    assert np.isfinite(np.asarray(ref)).all()


def test_lm_solve_thomas_tier_matches_jax(monkeypatch):
    """lm_solve's Thomas tier (the chain preconditioner by the block
    Thomas sweeps, K9's plain version here) against JAX's: DENSE_MAX_NODES
    patched to 256 in both packages, so the 300-node snake (a node count
    no other test traces: JAX reads the constant at trace time) takes the
    PCG step below 4,096 nodes in both; 4 LM steps of at most 40 CG
    iterations, test_lm_solve_pcr_tier_matches_jax's bounds (1e-3 m,
    1e-3 rad, chi2 within 1%) and the same LM iterations."""
    from bench_dist import build_snake_graph

    monkeypatch.setattr(ts, "DENSE_MAX_NODES", 256)
    monkeypatch.setattr(js, "DENSE_MAX_NODES", 256)
    _, init, edges = build_snake_graph(300, aisle_len=60)
    args = _padded(init, edges, 300, 512)
    (ref, chi2_ref, it_ref), (got, chi2, it) = _both_lm(args, 300, 4, 40)
    stats = ts.lm_solve.last_stats
    assert stats["tier"] == "thomas" and len(stats["cg_iters"]) == it
    ref, got = np.asarray(ref), got.numpy()
    assert int(it) == int(it_ref) == 4
    np.testing.assert_allclose(got[:, :2], ref[:, :2], rtol=0, atol=1e-3)
    dh = got[:, 2] - ref[:, 2]
    assert np.abs(np.arctan2(np.sin(dh), np.cos(dh))).max() < 1e-3
    assert abs(float(chi2) - float(chi2_ref)) <= 0.01 * float(chi2_ref)
    assert np.abs(got - init).max() > 0.1   # the solve moved the graph


# the distributed step's CGLoop against the reference loop on its own
# operators, in each rank; cases (dtype, schwarz, cg_rtol, cg_iters): the
# defaults, a stalled stop (rtol 0: only the stagnation probe ends it), the
# chain preconditioner across restarts in f64, an odd budget
DIST_CASES = (("float32", True, None, 200), ("float32", True, 0.0, 200),
              ("float64", False, None, 200), ("float32", True, 1e-9, 45))
DIST_WORKER = """
sys.path.insert(0, os.path.join(sys.path[0], "tests"))
from torch_cg_reference import lm_pcg_step, reference_cg
from slam_toolbox_tpu_torch.dist import multihost
from slam_toolbox_tpu_torch.dist import solver_dist as sd
mesh = multihost.global_mesh()
n, size = len(inp["poses"]), mesh.size
(src2, dst2, rel2, si2, em2, pl2), se = sd.partition_edges(
    inp["src"], inp["dst"], inp["rel"], inp["si"], inp["em"], size,
    n // size, 64)
lo, hi = mesh.rank * se, (mesh.rank + 1) * se
rows = []
for dt, schwarz, rtol, cg_iters in CASES:
    dt = getattr(torch, dt)
    step = sd.make_distributed_gn_step(
        mesh, n, cg_iters=cg_iters, schwarz=schwarz, block=64, cblock=16,
        cg_rtol=rtol)
    def put(a, d=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype=d)
    args = (put(inp["poses"], dt), put(src2[lo:hi]), put(dst2[lo:hi]),
            put(rel2[lo:hi], dt), put(si2[lo:hi], dt), put(em2[lo:hi]),
            put(pl2[lo:hi]), put(inp["free"], dt))
    for lam in (1e-4, 1e-6):
        _, _, i = step(*args, lam)
        L = step.cg_loop
        x, i_ref, hist, stalled = reference_cg(
            L.mv, L.prec, L.inp["b"], L.inp["stop"], cg_iters, 32, True)
        rows.append([i, i_ref, int(stalled), len(hist),
                     int(torch.equal(x, L.state["x"])), L.chunks])
out["rows"] = np.array(rows)
"""


@pytest.mark.parametrize("n_dev", [1, 2])
def test_distributed_chunks_equal_reference(tmp_path, n_dev):
    """Each case's chunked CG in every rank bit-equal to the reference
    loop on the same operators (the all_reduces inside), with the same
    iterations; one case stalls; one host read per chunk."""
    inputs, _ = snake_inputs(256, n_dev=n_dev)
    worker = f"CASES = {DIST_CASES!r}\n" + DIST_WORKER
    outs = run_ranks(tmp_path, n_dev, worker, inputs)
    for o in outs:
        rows = o["rows"]
        np.testing.assert_array_equal(rows, outs[0]["rows"])
        assert (rows[:, 0] == rows[:, 1]).all() and rows[:, 4].all(), rows
        # a stalled stop reports cg_iters after fewer iterations
        stalled = rows[rows[:, 2] == 1]
        assert len(stalled) and (stalled[:, 3] < stalled[:, 0]).all(), rows
        # reads: ceil(iterations run / K), at least one; a stalled loop
        # ran as many iterations as it tested r·r
        ran = np.where(rows[:, 2] == 1, rows[:, 3], rows[:, 0])
        assert (rows[:, 5] == np.maximum(1, -(-ran // K))).all(), rows


def test_distributed_odd_budget_matches_jax(tmp_path):
    """distributed_lm_solve at 1 rank with a CG budget of 45 against
    jsd.distributed_lm_solve on a 1-device mesh: test_torch_dist.py's f32
    bounds (1e-3 m, chi2 1e-4 relative, CG counts within 2, the same LM
    steps)."""
    inputs, _ = snake_inputs(256, n_dev=1)
    args = [inputs[k] for k in ("poses", "src", "dst", "rel", "si", "em",
                                "free")]
    mesh = JaxMesh(np.array(jax.devices()[:1]), ("graph",))
    j_poses, j_chi2 = jsd.distributed_lm_solve(mesh, *args, cg_iters=45,
                                               block=64, dtype=np.float32)
    j_cg = list(jsd.distributed_lm_solve.last_cg_iters)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path}/store", rank=0, world_size=1)
    try:
        poses, chi2 = distributed_lm_solve(
            multihost.global_mesh("cpu"), *args, cg_iters=45, block=64)
    finally:
        torch.distributed.destroy_process_group()
    cg = distributed_lm_solve.last_cg_iters
    n = int(inputs["n"])
    assert len(cg) == len(j_cg)
    assert max(abs(a - b) for a, b in zip(cg, j_cg)) <= 2, (cg, j_cg)
    assert np.abs(poses[:n, :2] - np.asarray(j_poses)[:n, :2]).max() < 1e-3
    assert abs(chi2 - j_chi2) <= 1e-4 * j_chi2


# -- the exact two-call match ------------------------------------------------
def _eager(monkeypatch):
    monkeypatch.setattr(Matcher, "build_grid", Matcher.build_grid_eager)
    monkeypatch.setattr(Matcher, "_run_pass", Matcher._run_pass_eager)


@pytest.mark.parametrize("penalize,refine", [(True, True), (False, True),
                                             (False, False)])
def test_exact_programs_equal_eager(scans, monkeypatch, penalize, refine):
    """match_scan(exact=True) through its programs bit-equal to the
    fresh-tensor route, query after query on the same static buffers,
    and to JAX's exact path within 1e-6."""
    jm, tm = _matchers(0.05, 0.1)
    jb, tb = _pair(scans, range(5))
    got = []
    for k in (5, 7, 8):
        (jq,), (tq,) = _pair(scans, [k])
        got.append(_pack(tm.match_scan(tq, tb, penalize=penalize,
                                       refine=refine, exact=True)))
        ref = jm.match_scan(jq, jb, penalize=penalize, refine=refine,
                            exact=True)
        np.testing.assert_allclose(got[-1], _pack(ref), rtol=1e-6,
                                   atol=1e-6)
    kinds = sorted({key[0] for key in tm._programs})
    assert kinds == ["pass", "raster"]
    _eager(monkeypatch)
    _, fresh = _matchers(0.05, 0.1)
    for k, g in zip((5, 7, 8), got):
        (tq,) = _pair(scans, [k])[1]
        e = fresh.match_scan(tq, tb, penalize=penalize, refine=refine,
                             exact=True)
        np.testing.assert_array_equal(g, _pack(e))
    assert not fresh._programs


def test_expansion_buckets_equal_eager(scans, monkeypatch):
    """Response expansion (test_response_expansion_path's setup): an
    empty base set takes the exact path through the coarse pass and its
    three expansions (21, 41, 61 and 81 headings) and the fine pass (11);
    a real base set then reuses the 21- and 11-heading programs. Every
    result bit-equal to the fresh-tensor route, and the empty set's to
    JAX's within the existing 1e-4."""
    jm, tm = _matchers(0.05, 0.1, use_expansion=True)
    (jq,), (tq,) = _pair(scans, [5])
    _, tb = _pair(scans, range(5))
    empty = tm.match_scan(tq, [])
    full = tm.match_scan(tq, tb, exact=True)
    ref = jm.match_scan(jq, [])
    assert empty.response == ref.response == 0.0
    np.testing.assert_allclose(_pack(empty), _pack(ref), rtol=1e-6,
                               atol=1e-4)
    na = sorted(key[1] for key in tm._programs if key[0] == "pass")
    assert na == [11, 21, 41, 61, 81]
    _eager(monkeypatch)
    _, em = _matchers(0.05, 0.1, use_expansion=True)
    np.testing.assert_array_equal(_pack(empty), _pack(em.match_scan(tq, [])))
    np.testing.assert_array_equal(
        _pack(full), _pack(em.match_scan(tq, tb, exact=True)))
