"""The benchmark's harness: finds a cell's files by the names in
BENCHMARK.json, runs its runner, reads its metrics and prints the result.

A cell (an entry of `workloads`) names a configuration and a traffic mix.
The configuration's file (its `file` in `configs`) names the runner that
runs it (bench_port/runners/<runner>.py) and holds the sizes, the
program's settings and the limits of the check; the mix is
bench_port/traffic/<traffic>.json, the parameters the runner's general
generator reads (a mapping mix names its world and its route by kind,
bench_port/worlds/<kind>.py and bench_port/routes/<kind>.py). Each metric
is read by bench_port/metrics/<name>.py, or by the reader of the part of
its name before the first dot, whose read(record) returns the number or
None where the run gives it nothing to read. Nothing here names a cell, a
configuration, a mix or a metric: a later change adds those as files.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "slam_toolbox_tpu")
_IMPORTED = time.perf_counter()


def process_start() -> float:
    """This process's start on the perf_counter clock (from /proc, so the
    interpreter's own start-up counts); the module's import time where
    /proc does not say."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return _IMPORTED


def cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    base = os.path.join(HERE, ".cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(base, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(base, "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_TF", "0")


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(path: str) -> dict:
    with open(os.path.join(ROOT, path)) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    metrics: list     # the BENCHMARK.json entries this run reports


def resolve(name: str, trace: bool, bench: dict = None) -> Cell:
    """The cell `name`: its configuration, its mix and the metrics a run
    with (or without) `trace` reports for it."""
    bench = bench or benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(configs[w["config"]]["file"])
    mix = load_json(os.path.join("bench_port", "traffic",
                                  w["traffic"] + ".json"))
    kind = bench["per_layer"] if trace else bench["end_to_end"]
    metrics = [m for m in kind if name in m.get("workloads", [name])]
    return Cell(name, int(w["chips"]), config, mix, metrics)


def plugin(folder: str, name: str):
    """The module bench_port/<folder>/<name>.py, loaded by its path."""
    path = os.path.join(HERE, folder, name + ".py")
    if not os.path.exists(path):
        raise KeyError(f"no {folder} file {name}.py in {HERE}")
    spec = importlib.util.spec_from_file_location(
        f"bench_port_{folder}_{name}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The read() of bench_port/metrics/<name>.py, or where there is no
    such file, of the reader named by the part of `name` before its first
    dot (device_idle_share.map and device_idle_share.solve share one)."""
    base = name.split(".")[0]
    if not os.path.exists(os.path.join(HERE, "metrics", name + ".py")):
        name = base
    return plugin("metrics", name).read


def runner_class(config: dict):
    mod = importlib.import_module("bench_port.runners." + config["runner"])
    return mod.RUNNER


@dataclasses.dataclass
class Context:
    """What a runner is given."""

    config: dict
    mix: dict
    seed: int
    device: str
    spans: object
    trace: bool
    err: object = sys.stderr

    def log(self, text: str) -> None:
        print(f"# {text}", file=self.err, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's, compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def device_info(device: str, chips: int) -> dict:
    import torch

    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips}
    return {"platform": "cpu", "kind": "cpu", "count": 1}


def correct(checks: dict) -> bool:
    """The comparison that decides `correct`: every number a check
    compares ({name: (value, limit)}) is finite and within its limit."""
    return all(isinstance(v, (int, float)) and math.isfinite(v) and v <= lim
               for v, lim in checks.values())


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: dict = None,
             t_start: float = None, out=sys.stdout, err=sys.stderr,
             bench: dict = None) -> dict:
    """Run one cell and print its result line last on `out` and its
    checks last on `err`. Returns the result; raises SystemExit with a
    code other than 0, printing no result, where the run has not the
    cards it asks for or has loaded JAX or the JAX package."""
    t_start = process_start() if t_start is None else t_start
    cell = resolve(name, trace, bench)
    for key, val in (overrides or {}).items():
        getattr(cell, key).update(val)
    import torch

    from bench_port.gen import trace as tr

    if torch.device(device).type == "cuda":
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell.chips):
            have = (torch.cuda.device_count()
                    if torch.cuda.is_available() else 0)
            print(f"{name} needs {cell.chips} CUDA device(s); {have} "
                  "available", file=err)
            raise SystemExit(3)
    spans = tr.Spans()
    ctx = Context(cell.config, cell.mix, seed, device, spans, trace, err)
    drv = runner_class(cell.config)(ctx)
    drv.setup(seconds)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    print(f"# {name} seed {seed}: set-up {setup_s:.3f} s", file=err,
          flush=True)
    trace_ctx = tr.DeviceTrace(err) if (trace and on_card) else None
    if trace_ctx is not None:
        with trace_ctx:
            drv.window(seconds)
    else:
        drv.window(seconds)
    if on_card:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    drv.finish()
    rec = drv.record()
    rec["setup_s"] = setup_s
    dev = device_info(device, cell.chips)
    dev["memory_peak_bytes"] = int(peak)
    breakdown = None
    if trace_ctx is not None:
        ivals = tr.clip(trace_ctx.intervals, rec["t0"], rec["t1"])
        rec["trace"] = ivals
        dev["busy_s"] = tr.union_s(ivals)
        dev["window_s"] = rec["t1"] - rec["t0"]
        breakdown = tr.breakdown(ivals, spans.items, rec["t0"], rec["t1"])
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    print(f"# {name}: window {rec['t1'] - rec['t0']:.3f} s, peak "
          f"{peak} B", file=err, flush=True)
    checks = drv.check(device)
    print(f"# {name}: check {time.perf_counter() - t_check:.3f} s",
          file=err, flush=True)
    attempted, failed = drv.attempted()
    metrics = {}
    for m in cell.metrics:
        v = metric_reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    found = forbidden_modules()
    if found:
        print(f"loaded modules of JAX or the JAX package: {found}", file=err)
        raise SystemExit(4)
    result = {"correct": correct(checks), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v} (limit {lim})", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return result
