"""The port's chain preconditioner (solver/chain_precond.py) and PCG tier
(se2_solver.py: solve_pcg, lm_solve's PCG step, lm_solve past
DENSE_MAX_NODES)
against the JAX package's on the same inputs.

Tolerances: the block-tridiagonal solves take test_chain_precond.py's
(rtol 1e-5 / atol 1e-6 against a dense solve for Thomas, rtol 1e-4 /
atol 1e-5 for PCR), and the port (f64 here) agrees with JAX (f32 on the
CPU) to rtol 1e-4 / atol 1e-5; block-Jacobi PCG within 1e-4 of JAX's
(both f32); the Thomas step within 1e-8 of a dense numpy solve (f64); the PCR tier
of lm_solve on a 2,100-node snake padded to 4,096 nodes within 1e-3 m /
1e-3 rad of JAX's lm_solve, chi2 within 1%."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_toolbox_tpu.core.params import SolverConfig as JaxSolverConfig
from slam_toolbox_tpu.solver import PoseGraphSolver as JaxSolver
from slam_toolbox_tpu.solver import chain_precond as jcp
from slam_toolbox_tpu.solver import se2_solver as js
from slam_toolbox_tpu_torch import native
from slam_toolbox_tpu_torch.core.params import SolverConfig
from slam_toolbox_tpu_torch.solver import PoseGraphSolver
from slam_toolbox_tpu_torch.solver import chain_precond as cp
from slam_toolbox_tpu_torch.solver import se2_solver as ts
from test_chain_precond import random_spd_chain
from test_torch_multihost import REPO  # noqa: F401  (scripts/ on sys.path)
from torch_cg_reference import lm_pcg_step


def t(a):
    return torch.from_numpy(np.array(a))


def j(a):
    return jnp.asarray(a)


def _close_to_jax(z, zj):
    np.testing.assert_allclose(z, np.asarray(zj), rtol=1e-4, atol=1e-5)


def test_apply_solves_tridiagonal_exactly():
    n = 40
    D, U, M = random_spd_chain(n, seed=3)
    free = np.ones(n, np.float64)
    r = np.random.default_rng(1).normal(0, 1, (n, 3))
    z = cp.apply(*cp.factorize(t(D), t(U), t(free)), t(r), t(free)).numpy()
    z_ref = np.linalg.solve(M, r.reshape(-1)).reshape(n, 3)
    np.testing.assert_allclose(z, z_ref, rtol=1e-5, atol=1e-6)
    _close_to_jax(z, jcp.apply(*jcp.factorize(j(D), j(U), j(free)), j(r),
                               j(free)))


def test_pcr_matches_dense_solve():
    n = 37  # non-power-of-two on purpose
    D, U, M = random_spd_chain(n, seed=7)
    free = np.ones(n, np.float64)
    r = np.random.default_rng(4).normal(0, 1, (n, 3))
    steps = int(math.ceil(math.log2(n))) + 1
    z = cp.pcr_solve(t(D), t(U), t(r), t(free), steps).numpy()
    z_ref = np.linalg.solve(M, r.reshape(-1)).reshape(n, 3)
    np.testing.assert_allclose(z, z_ref, rtol=1e-4, atol=1e-5)
    _close_to_jax(z, jcp.pcr_solve(j(D), j(U), j(r), j(free), steps))


def test_pcr_matches_thomas():
    n = 64
    D, U, M = random_spd_chain(n, seed=8)
    free = np.ones(n, np.float64)
    free[0] = 0.0
    r = np.random.default_rng(5).normal(0, 1, (n, 3))
    Um = U * (free[:-1] * free[1:])[:, None, None]
    z_thomas = cp.apply(*cp.factorize(t(D), t(Um), t(free)), t(r),
                        t(free)).numpy()
    z_pcr = cp.pcr_solve(t(D), t(Um), t(r), t(free),
                         int(math.ceil(math.log2(n))) + 1).numpy()
    np.testing.assert_allclose(z_pcr, z_thomas, rtol=1e-4, atol=1e-5)
    _close_to_jax(z_thomas, jcp.apply(*jcp.factorize(j(D), j(Um), j(free)),
                                      j(r), j(free)))


def test_apply_respects_fixed_nodes():
    n = 10
    D, U, M = random_spd_chain(n, seed=5)
    free = np.ones(n, np.float64)
    free[0] = 0.0
    r = np.random.default_rng(2).normal(0, 1, (n, 3))
    z = cp.apply(*cp.factorize(t(D), t(U), t(free)), t(r), t(free)).numpy()
    np.testing.assert_allclose(z[0], 0.0, atol=1e-12)
    _close_to_jax(z, jcp.apply(*jcp.factorize(j(D), j(U), j(free)), j(r),
                               j(free)))


@pytest.mark.parametrize("n", [1, 2, 37, 300])
def test_chain_thomas_plain_matches_jax(n):
    """K9's wrappers on CPU tensors (the plain factorize and apply)
    against JAX's chain_precond on the same f32 inputs with fixed nodes
    (node 0 and every 7th, their couplings dropped): Sinv, T, W and z
    within 1e-5 of each one's largest magnitude."""
    from chip_smoke import thomas_case

    D, U, r, free = thomas_case(n, torch.float64, "cpu", seed=n)
    fixed = np.arange(n) % 7 == 0
    f = np.where(fixed, 0.0, 1.0).astype(np.float32)
    Um = (U.numpy() * (f[:-1] * f[1:])[:, None, None]).astype(np.float32)
    D32, r32 = D.numpy().astype(np.float32), r.numpy().astype(np.float32)
    got = cp.chain_factorize(t(D32), t(Um), t(f))
    z = cp.chain_apply(*got, t(r32), t(f))
    ref = jcp.factorize(j(D32), j(Um), j(f))
    z_ref = jcp.apply(*ref, j(r32), j(f))
    for a, b in zip((*got, z), (*ref, z_ref)):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == torch.float32
        if b.size:
            assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()
    assert not z.numpy()[fixed].any()


def test_chain_thomas_wrappers_hold_no_fallback(monkeypatch):
    """K9's wrappers and the loops around them take no route by asking
    for a card: CPU tensors go to the plain versions (no library loads),
    a tensor on another device raises, and no wrapper or loop runner
    catches a failure."""
    import inspect

    from slam_toolbox_tpu_torch.kernels import match_cuda as mc

    for fn in (cp.chain_factorize, cp.chain_apply, ts.LMLoop.run,
               ts.LMLoop._run, ts.CGLoop.run, ts.CGLoop._run_device_loop,
               mc.WhileProgram.__init__, mc.WhileProgram.launch):
        src = inspect.getsource(fn)
        assert "except" not in src and "is_available" not in src

    def no_lib(name):
        raise AssertionError(f"{name}: a library was loaded for CPU tensors")

    monkeypatch.setattr(mc, "_lib", no_lib)
    D, U, r, free = (t.float() for t in _chain_case())
    got = cp.chain_apply(*cp.chain_factorize(D, U, free), r, free)
    ref = cp.apply(*cp.factorize(D, U, free), r, free)
    assert torch.equal(got, ref)
    with pytest.raises(ValueError):
        cp.chain_factorize(D.to("meta"), U.to("meta"), free.to("meta"))
    with pytest.raises(TypeError):
        cp.chain_factorize(D.half(), U.half(), free.half())


def _chain_case(n=9):
    from chip_smoke import thomas_case

    return thomas_case(n, torch.float64, "cpu")


def _ring(n, seed=0):
    """A noisy odometry ring of n nodes closed by one edge; returns (init
    poses, edges (i, j, rel, cov))."""
    rng = np.random.default_rng(seed)
    cov = np.diag([1e-4, 1e-4, 1e-5])
    step = np.array([0.5, 0.0, 2 * np.pi / n])
    pose = np.zeros(3)
    init, edges = [pose], []
    for i in range(1, n):
        noisy = step + rng.normal(0, 0.01, 3)
        c, sn = np.cos(pose[2]), np.sin(pose[2])
        pose = np.array([pose[0] + c * noisy[0] - sn * noisy[1],
                         pose[1] + sn * noisy[0] + c * noisy[1],
                         pose[2] + noisy[2]])
        init.append(pose)
        edges.append((i - 1, i, step, cov))
    edges.append((n - 1, 0, step, cov))
    return np.stack(init), edges


def test_large_ring_converges_fast():
    """A 2000-node noisy ring with one loop closure closes tightly (host
    sparse tier in both packages; they agree to 1e-9)."""
    n = 2000
    init, edges = _ring(n)
    s = PoseGraphSolver(SolverConfig(dist_edge_threshold=10**9),
                        device="cpu")
    sj = JaxSolver(JaxSolverConfig(dist_edge_threshold=10**9))
    for i, p in enumerate(init):
        s.add_node(i, p)
        sj.add_node(i, p)
    for a, b, r, c in edges:
        s.add_constraint(a, b, r, c)
        sj.add_constraint(a, b, r, c)
    corr, corr_j = dict(s.compute()), dict(sj.compute())
    assert np.hypot(*(corr[n - 1][:2] - corr[0][:2])) < 1.0
    got = np.stack([corr[i] for i in range(n)])
    ref = np.stack([corr_j[i] for i in range(n)])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9)


def _padded(init, edges, n_pad, e_pad):
    """compute()'s padded f32 arrays: padding nodes not free, padding
    edges at the last node with zero weight."""
    n = len(init)
    poses = np.zeros((n_pad, 3), np.float32)
    poses[:n] = init
    src = np.full(e_pad, n_pad - 1, np.int32)
    dst = np.full(e_pad, n_pad - 1, np.int32)
    rel = np.zeros((e_pad, 3), np.float32)
    si = np.zeros((e_pad, 3, 3), np.float32)
    em = np.zeros(e_pad, bool)
    for k, (a, b, r, c) in enumerate(edges):
        src[k], dst[k], rel[k] = a, b, r
        si[k] = js._sqrt_info_3x3(np.asarray(c, np.float64))
        em[k] = True
    free = np.ones(n_pad, np.float32)
    free[n:] = 0.0
    free[0] = 0.0
    return poses, src, dst, rel, si, em, free


def _normal(n=60, seed=0):
    """Normal-equation blocks of the solver test's loop graph (f64)."""
    from test_torch_solver import _graph

    _, poses, edges = _graph(seed, n=n)
    args = _padded(poses, [(a - 100, b - 100, r, c) for a, b, r, c in edges],
                   n, len(edges))
    poses, src, dst, rel, si, em, free = args
    return args, [x.double() if x.is_floating_point() else x.long()
                  for x in map(t, (poses, src, dst, rel, si, free))]


def test_solve_pcg_matches_jax():
    (poses, src, dst, rel, si, em, free), _ = _normal()
    n = len(poses)
    diag, hab, grad, _ = js.build_normal_blocks(
        j(poses), j(src), j(dst), j(rel), j(si), j(em), n_nodes=n)
    ref = np.asarray(js.solve_pcg(diag, hab, grad, j(src), j(dst), j(free),
                                  jnp.float32(1e-3), cg_iters=200,
                                  cg_tol=jnp.float32(1e-10)))
    got = ts.solve_pcg(t(np.asarray(diag)), t(np.asarray(hab)),
                       t(np.asarray(grad)), t(src).long(), t(dst).long(),
                       t(free), 1e-3, 200, 1e-10).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    assert np.abs(ref).max() > 1e-3


def test_thomas_step_matches_dense_solve():
    """lm_solve's PCG step below 4,096 nodes (the Thomas tier's CGLoop,
    block Thomas preconditioner), f64, to a tight tolerance: the damped
    normal equations' exact solution."""
    _, (poses, src, dst, rel, si, free) = _normal()
    diag, hab, grad, _ = ts.build_normal_blocks(poses, src, dst, rel, si)
    lam = 1e-3
    x, iters, _ = lm_pcg_step(diag, hab, grad, src, dst, free, lam, 200,
                              1e-24)
    n = len(poses)
    diag_d = ts._damped(diag, lam).numpy()
    H = np.zeros((3 * n, 3 * n))
    for i in range(n):
        H[3 * i:3 * i + 3, 3 * i:3 * i + 3] = diag_d[i]
    for k, (a, b) in enumerate(zip(src.tolist(), dst.tolist())):
        H[3 * a:3 * a + 3, 3 * b:3 * b + 3] += hab[k].numpy()
        H[3 * b:3 * b + 3, 3 * a:3 * a + 3] += hab[k].numpy().T
    f3 = np.repeat(free.numpy(), 3)
    H = H * f3[:, None] * f3[None, :] + np.diag(1.0 - f3)
    ref = np.linalg.solve(H, (grad.numpy() * free.numpy()[:, None])
                          .reshape(-1)).reshape(n, 3)
    np.testing.assert_allclose(x.numpy(), ref, rtol=0, atol=1e-8)
    assert iters < 60


def test_lm_solve_pcr_tier_matches_jax():
    """lm_solve past the dense ceiling at n_nodes = 4,096 (PCR chain
    preconditioner): scripts/bench_dist.py's snake graph at 2,100 nodes
    (aisles of 60), padded as compute() pads it, against the JAX package's
    lm_solve, both held to 4 LM steps of at most 40 CG iterations (the
    chain preconditioner leaves the aisles' loop coupling to CG, which
    runs to its cap here in both)."""
    from bench_dist import build_snake_graph

    torch.set_num_threads(1)
    _, init, edges = build_snake_graph(2100, aisle_len=60)
    args = _padded(init, edges, 4096, 4096)
    poses, src, dst, rel, si, em, free = args
    cfg = SolverConfig()
    scal = [np.float32(v) for v in (cfg.initial_lm_lambda,
                                    cfg.function_tolerance,
                                    cfg.gradient_tolerance,
                                    cfg.parameter_tolerance,
                                    cfg.cg_tolerance)]
    ref, chi2_ref, it_ref = js.lm_solve(
        *map(j, args), *map(jnp.float32, scal), n_nodes=4096,
        max_iterations=4, cg_iters=40)
    got, chi2, it = ts.lm_solve(
        t(poses), t(src).long(), t(dst).long(), t(rel), t(si), t(free),
        *map(float, scal[:4]), 4, cg_tol=float(scal[4]), cg_iters=40)
    ref, got = np.asarray(ref)[:2100], got.numpy()[:2100]
    assert int(it) == int(it_ref)
    np.testing.assert_allclose(got[:, :2], ref[:, :2], rtol=0, atol=1e-3)
    dh = got[:, 2] - ref[:, 2]
    assert np.abs(np.arctan2(np.sin(dh), np.cos(dh))).max() < 1e-3
    assert abs(float(chi2) - float(chi2_ref)) <= 0.01 * float(chi2_ref)
    assert np.abs(got - init).max() > 0.1   # the solve moved the graph


def test_pcg_tier_fault_raises(monkeypatch):
    """Past the ceiling without the native library compute() runs the PCG
    tier; a fault in it propagates."""
    n = ts.DENSE_MAX_NODES + 1
    s = PoseGraphSolver(device="cpu")
    for i in range(n):
        s.add_node(i, [0.1 * i, 0.0, 0.0])
    for i in range(n - 1):
        s.add_constraint(i, i + 1, [0.1, 0.0, 0.0], np.eye(3) * 1e-2)
    monkeypatch.setattr(native, "get_lib", lambda: None)

    def broken(*a, **k):
        raise RuntimeError("injected")

    monkeypatch.setattr(cp, "pcr_solve", broken)
    s.modify_node(5, [0.6, 0.1, 0.0])
    with pytest.raises(RuntimeError, match="injected"):
        s.compute()


@pytest.mark.slow
def test_pcr_tier_snake_12k_matches_jax(capsys):
    """chip_smoke's PCG-tier input on the CPU (slow: about 2 minutes, the
    port's share): the 12,288-node snake padded to 16,384 nodes through
    lm_solve with the default budget (200 CG iterations per LM step) in
    both packages. They agree to 5e-3 m; both end 0.1-0.25 m from the
    f64 host sparse solve, because CG stops at its cap on most steps
    (printed with -s: the figures behind chip_smoke's PCG_TIER_MAX_DXY)."""
    from bench_dist import build_snake_graph

    torch.set_num_threads(4)
    _, init, edges = build_snake_graph(12288)
    n = len(init)
    args = _padded(init, edges, 16384, 16384)
    poses, src, dst, rel, si, em, free = args
    cfg = SolverConfig()
    scal = [np.float32(v) for v in (cfg.initial_lm_lambda,
                                    cfg.function_tolerance,
                                    cfg.gradient_tolerance,
                                    cfg.parameter_tolerance,
                                    cfg.cg_tolerance)]
    ref, chi2_ref, it_ref = js.lm_solve(
        *map(j, args), *map(jnp.float32, scal), n_nodes=16384,
        max_iterations=cfg.max_iterations, cg_iters=cfg.cg_max_iterations)
    got, chi2, it = ts.lm_solve(
        t(poses), t(src).long(), t(dst).long(), t(rel), t(si), t(free),
        *map(float, scal[:4]), cfg.max_iterations, cg_tol=float(scal[4]),
        cg_iters=cfg.cg_max_iterations)
    ref, got = np.asarray(ref)[:n], got.numpy()[:n]
    free_h = np.ones(n)
    free_h[0] = 0.0
    host, host_chi2, _ = ts.host_sparse_lm(
        init.copy(), src[:len(edges)].astype(np.int64),
        dst[:len(edges)].astype(np.int64),
        np.stack([e[2] for e in edges]),
        np.stack([ts._sqrt_info_3x3(e[3]) for e in edges]), free_h, cfg)
    d_got = np.hypot(*(got[:, :2] - host[:, :2]).T).max()
    d_ref = np.hypot(*(ref[:, :2] - host[:, :2]).T).max()
    with capsys.disabled():
        print(f"\n# pcr tier 12k: port chi2 {float(chi2)} ({it} LM), JAX "
              f"{float(chi2_ref)} ({int(it_ref)} LM), host {host_chi2}; "
              f"largest xy difference to the host: port {d_got} m, JAX "
              f"{d_ref} m; port vs JAX "
              f"{np.abs(got[:, :2] - ref[:, :2]).max()} m")
    assert int(it) == int(it_ref)
    np.testing.assert_allclose(got[:, :2], ref[:, :2], rtol=0, atol=5e-3)
    assert d_ref < 0.25 and d_got < 0.25
