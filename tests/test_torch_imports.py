"""Package rules of the port: it loads no JAX and nothing of the JAX
package (nor do chip_smoke.py, profile_torch.py, workloads_torch.py and
configs_torch.py), its entry points default to the card and raise without
one (configs_torch.py's commands too), and chip_smoke.py fails without a
card."""
import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import json, sys
sys.path.insert(0, {repo!r})
import slam_toolbox_tpu_torch
import slam_toolbox_tpu_torch.api, slam_toolbox_tpu_torch.interop
import slam_toolbox_tpu_torch.kernels.match_cuda
import slam_toolbox_tpu_torch.kernels.step_cuda
import slam_toolbox_tpu_torch.kernels.loop_verify
import slam_toolbox_tpu_torch.mapper.streaming
import slam_toolbox_tpu_torch.io.dataset
import slam_toolbox_tpu_torch.io.carmen
import slam_toolbox_tpu_torch.io.serialization
import slam_toolbox_tpu_torch.kernels.occupancy
import slam_toolbox_tpu_torch.api.cli, slam_toolbox_tpu_torch.api.merge
import slam_toolbox_tpu_torch.api.viz
import slam_toolbox_tpu_torch.api.queue_modes
import slam_toolbox_tpu_torch.core.laser_utils
import slam_toolbox_tpu_torch.graph.marginal
import slam_toolbox_tpu_torch.mapper.lifelong
import slam_toolbox_tpu_torch.dist, slam_toolbox_tpu_torch.dist.multihost
import slam_toolbox_tpu_torch.dist.solver_dist
import slam_toolbox_tpu_torch.dist.match_dist
import slam_toolbox_tpu_torch.dist.submap
import slam_toolbox_tpu_torch.solver.chain_precond
import chip_smoke
import profile_torch
import workloads_torch
import configs_torch
print(json.dumps(sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "slam_toolbox_tpu")
)))
"""


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_and_chip_smoke_load_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(repo=REPO)],
        capture_output=True, text=True, timeout=300, env=_clean_env(),
        cwd=REPO,
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_default_device_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from slam_toolbox_tpu_torch.api import SlamSession
    from slam_toolbox_tpu_torch.core.params import MapperConfig
    from slam_toolbox_tpu_torch.core.scan import LaserConfig
    from slam_toolbox_tpu_torch.device import resolve_device
    from slam_toolbox_tpu_torch.kernels.match import Matcher
    from slam_toolbox_tpu_torch.mapper import Mapper
    from slam_toolbox_tpu_torch.solver import PoseGraphSolver

    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        SlamSession(MapperConfig(), LaserConfig())
    with pytest.raises(RuntimeError):
        Mapper(MapperConfig())
    with pytest.raises(RuntimeError):
        PoseGraphSolver()
    with pytest.raises(RuntimeError):
        Matcher(0.5, 0.05, 0.1, 10.0, 0.3, 0.03, 0.003, 0.5, 1.0, 0.5, 0.9)
    assert SlamSession(MapperConfig(), LaserConfig(),
                       device="cpu").device.type == "cpu"
    import configs_torch

    for command in (["config2"], ["config3"], ["config4"], ["config5"],
                    ["config5", "--variant", "sessions"]):
        with pytest.raises(RuntimeError):
            configs_torch.main(command)


def test_unported_modes_raise():
    """Localization, with or without the streaming pipeline, is ported: a
    localization session builds on the CPU and starts in
    PROCESS_LOCALIZATION, a mapping one in PROCESS; an unknown mode is
    refused where the JAX package refuses it (toggle_mode), and without a
    card the default device still raises."""
    from slam_toolbox_tpu_torch.api import ProcessType, SlamSession

    for streaming in (True, False):
        sess = SlamSession(streaming=streaming, mode="localization",
                           device="cpu")
        assert sess.mode == "localization" and sess.streaming == streaming
        assert sess.processor_type == ProcessType.PROCESS_LOCALIZATION
        assert sess.localization_buffer_uids() == set()
        sess.toggle_mode("mapping")
        assert sess.processor_type == ProcessType.PROCESS
        with pytest.raises(ValueError):
            sess.toggle_mode("surveying")
    assert SlamSession(streaming=True, device="cpu").streaming
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            SlamSession(mode="localization")


def test_port_reads_no_slam_environment():
    """Of the JAX package's SLAM_* switches the port reads only the
    streaming pipeline's five A/B switches, in mapper/streaming.py, and
    the multi-process deployment's three (SLAM_COORD, SLAM_NPROCS,
    SLAM_PROC_ID), in dist/multihost.py; the others (SLAM_FUSED_LOOP,
    SLAM_RESYNC_EPS, ...) are constants, and SLAM_SHARDED_RASTER is the
    `sharded=` keyword of dist/submap.py."""
    import re

    root = os.path.join(REPO, "slam_toolbox_tpu_torch")
    found = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith((".py", ".cu", ".cpp")):
                path = os.path.join(dirpath, name)
                with open(path) as f:
                    for var in re.findall(r"SLAM_\w+", f.read()):
                        found.setdefault(var, set()).add(
                            os.path.relpath(path, root))
    want = {
        var: {os.path.join("mapper", "streaming.py")}
        for var in ("SLAM_STREAM_PIPELINE", "SLAM_SPEC", "SLAM_SPEC_LOOP",
                    "SLAM_ADAPTIVE", "SLAM_EARLY_VERIFY")
    }
    want.update({var: {os.path.join("dist", "multihost.py")}
                 for var in ("SLAM_COORD", "SLAM_NPROCS", "SLAM_PROC_ID")})
    assert found == want


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, timeout=300, env=_clean_env(),
        cwd=REPO,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
