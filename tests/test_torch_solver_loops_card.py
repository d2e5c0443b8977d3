"""The solver's device loops and the exact match's programs on a card,
marked `cuda` and skipped without one: K9 (csrc/chain_thomas.cu) against
its plain version at n = 1, 2, 2,100, 3,072 (whole tiles: chip_smoke's
Thomas tier), 4,095 and 100,000 in f32 and f64;
the block-Jacobi, Thomas and PCR CG loops as WHILE programs (K10) and
lm_solve's dense, Thomas and PCR tiers as one program each, bit-equal to
their eager routes with one host read a solve; the distributed CG's
chunks (NCCL's all_reduces inside, a world-size-1 group) bit-equal to
the same chunks launched eagerly (CGLoop.run_eager); the exact match's
raster and pass replays bit-equal to its fresh-tensor route with the
same K1-K3 launches by grid; a function that cannot be captured raises
and leaves no program. The file imports no JAX, so the card's machine,
which has none, runs it from the repository's root with
`python -m pytest --noconftest tests/test_torch_solver_loops_card.py`."""
import dataclasses
import socket

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from slam_toolbox_tpu_torch.dist import multihost
from slam_toolbox_tpu_torch.dist import solver_dist as sd
from slam_toolbox_tpu_torch.kernels import match as km
from slam_toolbox_tpu_torch.kernels import match_cuda as mc
from slam_toolbox_tpu_torch.kernels.match import Matcher
from slam_toolbox_tpu_torch.mapper import Mapper
from slam_toolbox_tpu_torch.solver import chain_precond as cp
from slam_toolbox_tpu_torch.solver import se2_solver as ts
from test_torch_program_graph_card import _counted, cuda_device  # noqa: F401
from test_torch_stream_graph_card import _workload
from torch_cg_reference import lm_pcg_step


def _snake(n_nodes, n_pad, e_pad):
    """chip_smoke's copy of scripts/bench_dist.py's snake graph, packed."""
    from chip_smoke import build_snake_graph, pack_graph

    _, init, edges = build_snake_graph(n_nodes)
    return pack_graph(init, edges, n_pad, e_pad)


def _blocks(dev, n_pad=4096):
    poses, src, dst, rel, si, _, free = (
        torch.from_numpy(a).to(dev) for a in _snake(2100, n_pad, 4096))
    diag, hab, grad, _ = ts.build_normal_blocks(poses, src, dst, rel, si)
    return diag, hab, grad, src, dst, free


def _solve(route, blocks, cg_iters=120):
    if route == "jacobi":
        x = ts.solve_pcg(*blocks, 1e-4, cg_iters, 1e-12)
        loop = ts.solve_pcg.last_loop
        return x, loop.state["i"].item(), loop
    return lm_pcg_step(*blocks, 1e-4, cg_iters, 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("n, dtype", [
    (n, dt) for n in (1, 2, 2100, 3072, 4095, 100000)
    for dt in (torch.float32, torch.float64)])
def test_chain_thomas_matches_plain(cuda_device, n, dtype):
    """K9's factorization and sweeps against factorize and apply on the
    same inputs (a random SPD chain with fixed nodes), within 1e-5 (f32)
    and 1e-12 (f64) of each output's largest magnitude; one launch a
    call."""
    from chip_smoke import thomas_case

    D, U, r, free = thomas_case(n, dtype, cuda_device)
    mc.reset_launch_counts()
    got = cp.chain_factorize(D, U, free)
    z = cp.chain_apply(*got, r, free)
    torch.cuda.synchronize()
    assert mc.LAUNCHES["chain_thomas"] == 2
    cpu = [t.cpu() for t in (D, U, r, free)]
    ref = cp.factorize(*cpu[:2], cpu[3])
    z_ref = cp.apply(*ref, cpu[2], cpu[3])
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for a, b in zip((*got, z), (*ref, z_ref)):
        if b.numel():
            err = (a.cpu() - b).abs().max()
            assert err <= tol * b.abs().max(), (n, dtype, float(err))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["jacobi", "thomas", "pcr"])
def test_cg_replays_equal_eager(cuda_device, monkeypatch, route):
    """120 iterations (a restart's worth) as one WHILE program (the init,
    then the chunk in a WHILE node), then the chunked route eagerly on
    the same buffers: the same iterations and x bit for bit; one launch
    of the program and one host read a solve."""
    blocks = _blocks(cuda_device, 2100 if route == "thomas" else 4096)
    reads = [0]
    read = ts._host_read

    def counted(t):
        reads[0] += 1
        return read(t)

    monkeypatch.setattr(ts, "_host_read", counted)
    x, i, loop = _solve(route, blocks)
    assert sorted(loop.programs) == ["while"] and reads[0] == 1
    prog = loop.programs["while"]
    assert prog.launches == 1 and 0 < i <= 120
    assert loop.chunks == -(-i // ts.CG_CHUNK)
    monkeypatch.setattr(ts.CGLoop, "run", ts.CGLoop.run_eager)
    x_e, i_e, _ = _solve(route, blocks)
    assert i == i_e
    assert torch.equal(x, x_e)


def _tier_inputs(tier, dev):
    """lm_solve's arguments on the snake graph: 200 nodes padded as
    compute() pads (256, 512: the dense tier), 2,100 unpadded (Thomas),
    2,100 padded to 4,096 (PCR)."""
    n, n_pad, e_pad = {"dense": (200, 256, 512), "thomas": (2100, 2100, 4096),
                       "pcr": (2100, 4096, 4096)}[tier]
    poses, src, dst, rel, si, _, free = (
        torch.from_numpy(a).to(dev) for a in _snake(n, n_pad, e_pad))
    return (poses, src, dst, rel, si, free, 1e-4, 1e-3, 1e-10, 1e-10, 6)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["dense", "thomas", "pcr"])
def test_lm_solve_device_loop_equals_eager(cuda_device, monkeypatch, tier):
    """lm_solve as one program (the LM loop a WHILE node, the CG loop one
    nested in it) against the same functions from the host's Python loop
    (LMLoop.run_eager): poses, chi2, LM iterations and CG counts bit for
    bit, the same kernel launches, exactly one host read."""
    args = _tier_inputs(tier, cuda_device)
    reads = [0]
    read = ts._host_read

    def counted(t):
        reads[0] += 1
        return read(t)

    monkeypatch.setattr(ts, "_host_read", counted)
    torch.cuda.synchronize()
    mc.reset_launch_counts()
    poses, chi2, it = ts.lm_solve(*args, cg_iters=60)
    torch.cuda.synchronize()
    graphed, launches = dict(ts.lm_solve.last_stats), dict(mc.LAUNCHES)
    assert reads[0] == 1 == graphed["host_reads"]
    assert graphed["tier"] == tier and graphed["route"] == "device loop"
    assert launches["device_loop"] == 1 and it > 0
    monkeypatch.setattr(ts.LMLoop, "run", ts.LMLoop.run_eager)
    mc.reset_launch_counts()
    poses_e, chi2_e, it_e = ts.lm_solve(*args, cg_iters=60)
    torch.cuda.synchronize()
    eager = ts.lm_solve.last_stats
    assert eager["route"] == "host loop" and eager["host_reads"] > 1
    assert it == it_e and graphed["cg_iters"] == eager["cg_iters"]
    assert graphed["cg_chunks"] == eager["cg_chunks"]
    assert torch.equal(poses, poses_e) and torch.equal(chi2, chi2_e)
    assert dict(mc.LAUNCHES, device_loop=1) == launches
    if tier != "dense":
        assert launches["chain_thomas"] == (0 if tier == "pcr" else 2 * it + (
            ts.CG_CHUNK * sum(graphed["cg_chunks"])))
    assert torch.isfinite(poses).all() and float(chi2) < float(
        ts.chi2_only(args[0], *args[1:5]))


@pytest.mark.cuda
def test_failed_body_capture_raises(cuda_device, monkeypatch):
    """An LM loop whose body reads the device from the host (here K9's
    sweeps) cannot be captured: lm_solve raises, keeps no program and
    runs nothing eagerly instead."""
    apply = cp.chain_apply

    def syncing(Sinv, T, W, r, free):
        float(r[0, 0])
        return apply(Sinv, T, W, r, free)

    monkeypatch.setattr(cp, "chain_apply", syncing)
    monkeypatch.setattr(ts, "_LM_LOOPS", {})
    with pytest.raises(RuntimeError):
        ts.lm_solve(*_tier_inputs("thomas", cuda_device), cg_iters=16)
    (loop,) = ts._LM_LOOPS.values()
    assert loop.program is None


@pytest.fixture
def nccl_mesh(cuda_device):
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(multihost.rank_device(0, "nccl"))
    tdist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                             rank=0, world_size=1)
    try:
        yield multihost.global_mesh()
    finally:
        tdist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("schwarz", [True, False])
def test_distributed_chunks_equal_eager(nccl_mesh, monkeypatch, schwarz):
    """The distributed GN step on 1,024 snake nodes at world size 1 over
    NCCL: its CG chunks as graphs with the all_reduces inside, then the
    same step eagerly: the same iterations and poses bit for bit."""
    n = 1024
    poses, src, dst, rel, si, em, free = _snake(n, n, 2048)
    (s2, d2, r2, si2, em2, pl2), _ = sd.partition_edges(
        src, dst, rel, si, em, 1, n, 512)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(nccl_mesh.device)
            for a in (poses, s2, d2, r2, si2, em2, pl2, free)]
    step = sd.make_distributed_gn_step(nccl_mesh, n, cg_iters=200,
                                       schwarz=schwarz, block=512)
    got, _, i = step(*args, 1e-4)
    assert step.cg_loop.programs
    assert all(p.graph is not None for p in step.cg_loop.programs.values())
    monkeypatch.setattr(ts.CGLoop, "run", ts.CGLoop.run_eager)
    ref, _, i_e = step(*args, 1e-4)
    assert i == i_e > 0
    assert torch.equal(got, ref)


@pytest.fixture
def expansion_mapper(cuda_device):
    """A mapper on the card whose matchers expand the response, and the
    workload's scans at their true poses."""
    from slam_toolbox_tpu_torch.core.scan import LocalizedScan

    cfg, laser, data = _workload()
    cfg = dataclasses.replace(cfg, use_response_expansion=True)
    mapper = Mapper(cfg, device=cuda_device)
    mapper.initialize(laser.range_threshold)
    scans = []
    for scan, tp in data:
        s = LocalizedScan(laser, scan.ranges, scan.odom_pose)
        s.set_corrected_pose(tp)
        scans.append(s)
    return mapper, scans


def _eager(monkeypatch):
    monkeypatch.setattr(Matcher, "build_grid", Matcher.build_grid_eager)
    monkeypatch.setattr(Matcher, "_run_pass", Matcher._run_pass_eager)


def _pack(r):
    return np.concatenate([[r.response], r.sensor_pose, r.covariance.ravel()])


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["sequential", "loop"])
def test_exact_replays_equal_eager(expansion_mapper, monkeypatch, which):
    """match_scan(exact=True) on three base sets and the expansion of an
    empty one as raster and pass replays, then by the fresh-tensor
    route: every result bit for bit, the same K1-K3 launches by grid."""
    mapper, scans = expansion_mapper
    m = getattr(mapper, f"{which}_matcher")
    q = scans[30]
    cases = [(scans[20:30], True, True), (scans[25:29], False, True),
             (scans[10:28], False, False)]

    def run():
        out = [_pack(m.match_scan(q, b, penalize=p, refine=r, exact=True))
               for b, p, r in cases]
        return out + [_pack(m.match_scan(q, []))]

    got, n_graph, g_graph = _counted(run)
    assert {k[0] for k in m._programs} >= {"raster", "pass"}
    assert all(p.graph is not None for p in m._programs.values())
    assert got[-1][0] == 0.0
    _eager(monkeypatch)
    ref, n_eager, g_eager = _counted(run)
    assert n_graph == n_eager and g_graph == g_eager
    # one coarse pass per exact match; the empty set's fused match, then
    # its coarse pass and three expansions
    assert n_graph["score_windows"] == 3 + 1 + 4
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_failed_captures_raise(cuda_device, expansion_mapper, monkeypatch):
    """A preconditioner or an exact pass that reads the device from the
    host cannot be captured: the call raises, no program is kept for it,
    and nothing runs it eagerly instead."""
    pcr = cp.pcr_solve

    def syncing(D, U, r, free, n_steps):
        float(r[0, 0])
        return pcr(D, U, r, free, n_steps)

    blocks = _blocks(cuda_device)
    monkeypatch.setattr(cp, "pcr_solve", syncing)
    monkeypatch.setattr(ts, "_LM_LOOPS", {})
    with pytest.raises(RuntimeError):
        lm_pcg_step(*blocks, 1e-4, 16, 1e-12)
    (loop,) = ts._LM_LOOPS.values()
    assert not loop.cg.programs

    mapper, scans = expansion_mapper
    m = mapper.sequential_matcher
    impl = km._match_pass_impl

    def syncing_pass(grid_flat, *args, **kw):
        float(grid_flat[0])
        return impl(grid_flat, *args, **kw)

    monkeypatch.setattr(km, "_match_pass_impl", syncing_pass)
    mc.reset_launch_counts()
    with pytest.raises(RuntimeError):
        m.match_scan(scans[30], scans[20:30], exact=True)
    assert not [k for k in m._programs if k[0] == "pass"]
    assert mc.LAUNCHES["score_windows"] == 0
