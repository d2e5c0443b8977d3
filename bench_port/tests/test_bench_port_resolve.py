"""BENCHMARK.json's names resolve to the benchmark's files; a
configuration, a mix and a metric are added as files alone; nothing the
benchmark loads is JAX or the JAX package."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from bench_port import harness
from bench_port.tests.more_cells import bench

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


BENCHES = {"benchmark": harness.benchmark, "more_cells": bench}


@pytest.mark.parametrize("which", sorted(BENCHES))
def test_every_name_resolves_to_its_file(which):
    b = BENCHES[which]()
    paths = b["paths"]
    for c in b["configs"]:
        assert any(c["file"].startswith(p + "/") for p in paths)
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["name"] == c["name"]
        assert harness.runner_class(cfg) is not None
        ref = os.path.join(ROOT, cfg["reference"])
        assert os.path.exists(ref), ref
    for w in b["workloads"]:
        for trace in (False, True):
            cell = harness.resolve(w["name"], trace, b)
            assert cell.metrics, (w["name"], trace)
        assert os.path.exists(os.path.join(
            harness.HERE, "traffic", w["traffic"] + ".json"))
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


@pytest.mark.parametrize("which", sorted(BENCHES))
def test_benchmark_json_keeps_the_contracts_shape(which):
    """BENCHMARK.json, and BENCHMARK.json with the cells not in it yet
    added as a later change would add them."""
    b = BENCHES[which]()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
    cells = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["name"] not in cells
        assert w["config"] in names and len(w["why"]) <= 200
        assert w["chips"] == 1
        cells.add(w["name"])
    seen = set()
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                         "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        seen.add(m["name"])
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                         "layer", "moves"}
        assert m["moves"] in seen
        assert set(m["workloads"]) <= cells
    assert "setup_s" in seen
    for w in cells:
        e2e = [m["name"] for m in b["end_to_end"]
               if w in m.get("workloads", [w])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.resolve(w, True, b).metrics
    assert len(json.dumps(b)) < 64 * 1024


def test_a_config_a_mix_and_a_metric_are_files_alone(tmp_path, monkeypatch):
    """A copy of the benchmark to which a configuration, a mix with a new
    world kind and a new route kind, a cell and a per-layer metric are
    added as new files and entries only: the harness finds each by its
    name, and the mix's bags are made from the new kinds' files."""
    import numpy as np

    from bench_port.gen import sim, worlds
    from bench_port.runners import mapping

    tree = tmp_path / "tree"
    shutil.copytree(harness.HERE, tree / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    b = _bench()
    cfg = json.load(open(os.path.join(ROOT, "bench_port/configs/"
                                      "apartment.json")))
    cfg["name"] = "office"
    (tree / "bench_port/configs/office.json").write_text(json.dumps(cfg))
    (tree / "bench_port/worlds/corridor.py").write_text(
        "from bench_port.gen.sim import SegmentWorld\n\n\n"
        "def world(spec):\n"
        "    n, w = spec['length'], spec['width'] / 2\n"
        "    return SegmentWorld([(-1, -w, n, -w), (n, -w, n, w),\n"
        "                         (n, w, -1, w), (-1, w, -1, -w),\n"
        "                         (n / 2, -w, n / 2, -w / 2)])\n")
    (tree / "bench_port/routes/there_and_back.py").write_text(
        "import numpy as np\n\n\n"
        "def waypoints(spec, world_spec):\n"
        "    n = world_spec['length'] - 1.0\n"
        "    return np.array([(0.0, 0.0), (n, 0.0), (0.0, 0.0)] * "
        "spec['times'])\n")
    (tree / "bench_port/traffic/corridor.json").write_text(json.dumps({
        "world": {"kind": "corridor", "length": 12.0, "width": 3.0},
        "route": {"kind": "there_and_back", "times": 1}, "step": 0.3,
        "range_noise": 0.01, "odom_noise": [0.015, 0.006], "bags": 2}))
    (tree / "bench_port/metrics/flush_ms.py").write_text(
        "def read(rec):\n    return 1.5\n")
    b["configs"].append({"name": "office", "source": "a source",
                         "file": "bench_port/configs/office.json",
                         "reduced": [], "why": "a why"})
    b["workloads"].append({"name": "office.corridor", "config": "office",
                           "traffic": "corridor", "chips": 1, "why": "w"})
    for m in b["end_to_end"]:
        if m["name"] in ("scans_per_s", "drain_p95_ms"):
            m["workloads"].append("office.corridor")
    for name in ("flush_ms", "device_idle_share.corridor"):
        b["per_layer"].append({"name": name, "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "streaming pipeline", "moves":
                               "scans_per_s", "workloads":
                               ["office.corridor"]})
    (tree / "BENCHMARK.json").write_text(json.dumps(b))
    monkeypatch.setattr(harness, "ROOT", str(tree))
    monkeypatch.setattr(harness, "HERE", str(tree / "bench_port"))
    cell = harness.resolve("office.corridor", True)
    assert cell.config["name"] == "office"
    assert cell.mix["world"]["kind"] == "corridor"
    assert [m["name"] for m in cell.metrics] == [
        "flush_ms", "device_idle_share.corridor"]
    assert harness.metric_reader("flush_ms")({}) == 1.5
    assert harness.metric_reader("device_idle_share.corridor")({}) is None
    assert [m["name"] for m in harness.resolve("office.corridor",
                                               False).metrics] == [
        "scans_per_s", "drain_p95_ms", "setup_s"]
    assert len(worlds.world(cell.mix["world"]).segments) == 5
    assert len(worlds.route(cell.mix["route"], cell.mix["world"])) == 3
    laser = sim.Laser(min_range=0.05, max_range=12.0, range_threshold=10.0,
                      angular_resolution=float(np.deg2rad(2.0)))
    bags = mapping._bags(cell.mix, laser, 2 ** 32 + 3, range(2), None)
    assert len(bags) == 2 and len(bags[0]) > 60
    assert np.isfinite(bags[0].ranges).any()


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    fake = {"jax": 1, "jax.numpy": 1, "jaxlib.xla": 1, "flax": 1,
            "slam_toolbox_tpu": 1, "slam_toolbox_tpu.core.scan": 1,
            "slam_toolbox_tpu_torch": 1, "slam_toolbox_tpu_torch.api": 1,
            "jaxtyping": 1, "flaxen": 1}
    monkeypatch.setattr(sys, "modules", fake)
    assert harness.forbidden_modules() == [
        "flax", "jax", "jax.numpy", "jaxlib.xla", "slam_toolbox_tpu",
        "slam_toolbox_tpu.core.scan"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A process that imports the harness, every runner, reference and
    metric, and runs the solve cell at a cut on the CPU, has loaded no
    module of JAX or of the JAX package."""
    code = (
        "import sys, io, json; sys.path.insert(0, %r)\n"
        "import torch; torch.set_num_threads(2)\n"
        "from bench_port import harness, control\n"
        "from bench_port.tests import more_cells\n"
        "import bench_port.runners.mapping, bench_port.runners.joint_solve\n"
        "import bench_port.ref.fit, bench_port.ref.lm\n"
        "b = harness.benchmark()\n"
        "[harness.metric_reader(m['name']) for m in b['end_to_end'] + "
        "b['per_layer']]\n"
        "ov = {'config': {'graph': {'sessions': 2, 'nodes_per': 300}, "
        "'solve': {'lm_steps': 2, 'cg_iters': 20, 'block': 64, "
        "'dtype': 'float32'}}}\n"
        "harness.run_cell('merge500k.solve', 5, 0.5, False, device='cpu', "
        "overrides=ov, out=io.StringIO(), err=io.StringIO(), "
        "bench=more_cells.bench())\n"
        "print(json.dumps(sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', "
        "'slam_toolbox_tpu'))))\n") % ROOT
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=str(ROOT), timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []


def test_run_without_a_card_prints_no_result(tmp_path):
    """Where the machine has no CUDA device (here), run.py exits with a
    code other than 0 and prints no result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload",
         "apartment.laps", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=300)
    assert p.returncode != 0
    assert "correct" not in p.stdout
