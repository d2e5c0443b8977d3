"""The port's edge-sharded distributed solve (dist/solver_dist.py) against
the JAX package's on a mesh of the same size: scripts/bench_dist.py's
snake graph (256 nodes in aisles of 32, loop edges every 4th node), at 1
rank (a gloo group in the test process), 2 and 4 ranks (subprocess
ranks), in f32 (here) and f64 (test_torch_dist_f64.py), and with the chain (PCR) preconditioner
(schwarz=False, JAX's make_distributed_gn_step given the same keyword).

Tolerances: positions within 1e-3 m of JAX's in f32 and 1e-7 m in f64
(the two sum their reductions in different orders); chi2 within 1e-4
(f32) and 1e-9 (f64) relative; the same number of LM steps; with the
Schwarz preconditioner the CG iterations of every LM step within 2 of
JAX's (f32 rounding moves the stop test by an iteration or two; the chain
preconditioner's late steps run into the 200 cap, where the count is
rounding noise, so it is not compared);
every rank's poses bit-equal to rank 0's; positions within 2 cm (f32)
and 1 cm (f64) of the host sparse solve, whose own LM stops at
function_tolerance 1e-3 (DIST_SCALING_F64.json reads 3.4 mm at 12k nodes)."""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import slam_toolbox_tpu.dist.solver_dist as jsd
from slam_toolbox_tpu_torch.dist import multihost
from slam_toolbox_tpu_torch.dist.solver_dist import distributed_lm_solve
from test_torch_multihost import run_ranks, snake_inputs

TOL = {"f32": (1e-3, 1e-4, 2e-2), "f64": (1e-7, 1e-9, 1e-2)}
WORKER = """
from slam_toolbox_tpu_torch.dist import multihost
from slam_toolbox_tpu_torch.dist.solver_dist import distributed_lm_solve
poses, chi2 = distributed_lm_solve(
    multihost.global_mesh(), inp["poses"], inp["src"], inp["dst"],
    inp["rel"], inp["si"], inp["em"], inp["free"], cg_iters=200,
    block=64, dtype=np.dtype(str(inp["dtype"])), schwarz=bool(inp["schwarz"]))
out["poses"], out["chi2"] = poses, np.float64(chi2)
out["cg"] = np.array(distributed_lm_solve.last_cg_iters)
"""


def _jax_solve(inputs, n_dev, dtype, schwarz):
    mesh = JaxMesh(np.array(jax.devices()[:n_dev]), ("graph",))
    args = [inputs[k] for k in ("poses", "src", "dst", "rel", "si", "em",
                                "free")]
    orig = jsd.make_distributed_gn_step
    jsd.make_distributed_gn_step = functools.partial(orig, schwarz=schwarz)
    try:
        if dtype == np.float64:
            with jax.enable_x64(True):
                out, chi2 = jsd.distributed_lm_solve(
                    mesh, *args, cg_iters=200, block=64, dtype=dtype)
        else:
            out, chi2 = jsd.distributed_lm_solve(
                mesh, *args, cg_iters=200, block=64, dtype=dtype)
    finally:
        jsd.make_distributed_gn_step = orig
    return np.asarray(out), chi2, list(jsd.distributed_lm_solve.last_cg_iters)


def _torch_solve(tmp_path, inputs, n_dev, dtype, schwarz):
    if n_dev > 1:
        outs = run_ranks(tmp_path, n_dev, WORKER, dict(
            inputs, dtype=np.str_(np.dtype(dtype).name),
            schwarz=np.bool_(schwarz)))
        for o in outs[1:]:
            np.testing.assert_array_equal(o["poses"], outs[0]["poses"])
            assert o["chi2"] == outs[0]["chi2"]
        o = outs[0]
        return o["poses"], float(o["chi2"]), o["cg"].tolist()
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path}/store1", rank=0,
        world_size=1)
    try:
        mesh = multihost.global_mesh("cpu")
        assert mesh.size == 1 and mesh.group is not None
        args = [inputs[k] for k in ("poses", "src", "dst", "rel", "si",
                                    "em", "free")]
        poses, chi2 = distributed_lm_solve(
            mesh, *args, cg_iters=200, block=64, dtype=dtype,
            schwarz=schwarz)
    finally:
        torch.distributed.destroy_process_group()
    return poses, chi2, list(distributed_lm_solve.last_cg_iters)


def check_solve(tmp_path, n_dev, prec, schwarz):
    torch.set_num_threads(1)
    dtype = np.float64 if prec == "f64" else np.float32
    inputs, ref = snake_inputs(256, n_dev=n_dev)
    n = len(ref)
    j_poses, j_chi2, j_cg = _jax_solve(inputs, n_dev, dtype, schwarz)
    t_poses, t_chi2, t_cg = _torch_solve(tmp_path, inputs, n_dev, dtype,
                                         schwarz)
    tol_xy, tol_chi2, tol_host = TOL[prec]
    assert t_poses.dtype == dtype
    assert np.abs(t_poses[:n, :2] - j_poses[:n, :2]).max() < tol_xy
    dh = t_poses[:n, 2] - j_poses[:n, 2]
    assert np.abs(np.arctan2(np.sin(dh), np.cos(dh))).max() < tol_xy
    assert abs(t_chi2 - j_chi2) <= tol_chi2 * j_chi2
    assert len(t_cg) == len(j_cg)
    if schwarz:
        assert max(abs(a - b) for a, b in zip(t_cg, j_cg)) <= 2, (t_cg, j_cg)
        assert np.hypot(*(t_poses[:n, :2] - ref[:, :2]).T).max() < tol_host


@pytest.mark.parametrize("n_dev,schwarz", [
    (1, True), (2, True), (4, True), (1, False), (2, False)])
def test_distributed_solve_matches_jax(tmp_path, n_dev, schwarz):
    check_solve(tmp_path, n_dev, "f32", schwarz)
