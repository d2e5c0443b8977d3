"""Multi-process runs of the port's dist/ package on the CPU: the rank
harness the other test_torch_dist* / test_torch_submap files use, and
dist/multihost.py's initialize() from SLAM_COORD / SLAM_NPROCS /
SLAM_PROC_ID (and from torch's own env:// variables) in 2 processes, with
the distributed solve's parity with the host sparse solve (max xy
difference below 2 cm, test_multihost.py's bar).

Each rank is a `python -c` subprocess that imports torch and the port and
never jax (asserted at its end); a gloo group joins them, from a file://
store under the test's tmp_path unless the test initializes it itself.
Inputs and outputs go through .npz files."""
import itertools
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

_HEAD = """
import os, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
rank, size = int(sys.argv[1]), int(sys.argv[2])
store, inp_path, out_path = sys.argv[3], sys.argv[4], sys.argv[5]
inp = dict(np.load(inp_path))
out = {{}}
"""
FILE_INIT = """
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=size)
"""
# the rank saves its output, leaves the group, and exits without the
# interpreter's teardown: torch's TCP store (the group's rendezvous under
# SLAM_COORD or env://) can abort in its destructor while a peer's client
# connection is still closing
_TAIL = """
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "slam_toolbox_tpu"))
assert not bad, bad
np.savez(out_path, **out)
dist.barrier()
dist.destroy_process_group()
sys.stdout.flush()
os._exit(0)
"""
_RUNS = itertools.count()


def run_ranks(tmp_path, size, body, inputs=None, init=FILE_INIT, env=None,
              timeout=240):
    """Run `body` in `size` rank processes (after `init`, which starts the
    group; `inp` holds `inputs`, `out` is saved per rank). Returns the
    ranks' `out` dicts in rank order; fails with the ranks' output if any
    rank fails."""
    k = next(_RUNS)
    inp_path = tmp_path / f"in{k}.npz"
    np.savez(inp_path, **(inputs or {}))
    code = (_HEAD.format(repo=REPO) + init + textwrap.dedent(body)
            + _TAIL)
    base = dict(os.environ)
    base.pop("PYTHONPATH", None)
    procs = []
    for r in range(size):
        e = dict(base, **(env(r) if env else {}))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, str(r), str(size),
             str(tmp_path / f"store{k}"), str(inp_path),
             str(tmp_path / f"out{k}_{r}.npz")],
            env=e, cwd=str(tmp_path), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        ))
    logs, rc = [], 0
    try:
        for p in procs:
            log, _ = p.communicate(timeout=timeout)
            logs.append(log.decode(errors="replace"))
            rc |= p.returncode
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    assert rc == 0, "\n".join(f"--- rank {r}\n{log[-3000:]}"
                              for r, log in enumerate(logs))
    return [dict(np.load(tmp_path / f"out{k}_{r}.npz"))
            for r in range(size)]


def free_port() -> int:
    """A free port below the kernel's ephemeral range: a port the kernel
    handed out (bind to 0) can be handed again, to another test's gloo
    connection, between this check and the store's bind."""
    with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
        low = int(f.read().split()[0])
    rng = np.random.default_rng()
    while True:
        port = int(rng.integers(max(1024, low - 12000), low))
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port


def snake_inputs(n_nodes=512, aisle_len=32, n_dev=2):
    """scripts/bench_dist.py's snake graph, packed for n_dev ranks, with
    the host sparse solve's poses as the reference."""
    from bench_dist import build_snake_graph, pack

    from slam_toolbox_tpu_torch.core.params import SolverConfig
    from slam_toolbox_tpu_torch.interop import solver_from_arrays

    _, init, edges = build_snake_graph(n_nodes, aisle_len=aisle_len)
    poses, src, dst, rel, si, em, free = pack(init, edges, n_dev)
    s = solver_from_arrays(list(range(len(init))), init, edges,
                           SolverConfig(), device="cpu")
    corr = dict(s.compute())
    ref = np.stack([corr[i] for i in range(len(init))])
    return dict(poses=poses, src=src, dst=dst, rel=rel, si=si, em=em,
                free=free, n=np.int64(len(init))), ref


SOLVE = """
from slam_toolbox_tpu_torch.dist import multihost
from slam_toolbox_tpu_torch.dist.solver_dist import distributed_lm_solve
out["ok"] = np.bool_(multihost.initialize())
out["info"] = np.array([multihost.process_info()[k] for k in (
    "process_index", "process_count", "local_devices", "global_devices")])
mesh = multihost.global_mesh()
out["mesh"] = np.array([mesh.rank, mesh.size, mesh.device.type == "cpu"])
poses, chi2 = distributed_lm_solve(
    mesh, inp["poses"], inp["src"], inp["dst"], inp["rel"], inp["si"],
    inp["em"], inp["free"], cg_iters=200, block=128)
out["poses"], out["chi2"] = poses, np.float64(chi2)
"""


@pytest.mark.parametrize("how", ["slam_env", "torch_env"])
def test_initialize_two_processes_solve_parity(tmp_path, how):
    inputs, ref = snake_inputs()
    n = len(ref)
    port = free_port()

    def env(r):
        if how == "slam_env":
            return dict(SLAM_COORD=f"127.0.0.1:{port}", SLAM_NPROCS="2",
                        SLAM_PROC_ID=str(r))
        return dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                    RANK=str(r), WORLD_SIZE="2")

    outs = run_ranks(tmp_path, 2, SOLVE, inputs, init="", env=env)
    for r, o in enumerate(outs):
        assert o["ok"]
        assert o["info"].tolist() == [r, 2, 1, 2]
        assert o["mesh"].tolist() == [r, 2, 1]
        d = np.hypot(*(o["poses"][:n, :2] - ref[:, :2]).T).max()
        assert d < 2e-2, f"rank {r}: max dxy {d}"
    np.testing.assert_array_equal(outs[0]["poses"], outs[1]["poses"])
    assert outs[0]["chi2"] == outs[1]["chi2"]


def test_initialize_single_process_is_false(monkeypatch):
    from slam_toolbox_tpu_torch.dist import multihost

    for var in ("SLAM_COORD", "SLAM_NPROCS", "SLAM_PROC_ID", "MASTER_ADDR",
                "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize() is False
    monkeypatch.setenv("SLAM_COORD", "127.0.0.1:1")
    monkeypatch.setenv("SLAM_NPROCS", "1")
    assert multihost.initialize() is False
    assert multihost.process_info() == {
        "process_index": 0, "process_count": 1, "local_devices": 1,
        "global_devices": 1}
    mesh = multihost.global_mesh("cpu")
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)
