"""The lifelong cell (warehouse_lifelong.revisits) through the harness on
the CPU at a cut: 2 aisles 20 m long, 12 laps of which 5 are mapped in
set-up, 271 beams, a 0.05 m correlation grid, the top-up at 12
candidates (the small world's setting of tests/test_torch_lifelong.py),
16 decay snapshots. The run reads `correct` true; the bfloat16 control,
and decisions or scores of the program changed after the run, read it
false; a program whose SlamSession takes no `lifelong` fails in set-up
before simulating; the new metrics resolve; the reference and the
runner load no JAX."""
import io
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from bench_port import harness
from bench_port.gen import sim, worlds

CELL = "warehouse_lifelong.revisits"
DECAY = ("decay_ms", "decay_filter_ms", "decay_score_ms", "decay_topup_ms",
         "decay_remove_ms")
SEED = 2 ** 31 + 17


def cut() -> dict:
    cfg = harness.resolve(CELL, False).config
    return {"config": {
        "laser": dict(cfg["laser"], angular_resolution=2 * math.pi / 270),
        "mapper": dict(cfg["mapper"],
                       correlation_search_space_resolution=0.05),
        "lifelong": dict(cfg["lifelong"], steady_state_min_candidates=12),
        "decay_snapshots": {"count": 16, "among": 64}},
        "mix": {"world": {"kind": "warehouse", "aisles": 2, "length": 20.0,
                          "pitch": 4.0},
                "route": {"kind": "serpentine_laps", "laps": 12}}}


@pytest.fixture(scope="module")
def traced():
    """One traced run of the cut to the bag's end: its result line, its
    standard error and the finished runner."""
    box = {}
    plain = harness.runner_class

    def keep(config):
        cls = plain(config)
        return lambda ctx: box.setdefault("drv", cls(ctx))

    out, err = io.StringIO(), io.StringIO()
    mp = pytest.MonkeyPatch()
    mp.setattr(harness, "runner_class", keep)
    try:
        harness.run_cell(CELL, SEED, 120.0, True, device="cpu",
                         overrides=cut(), out=out, err=err)
    finally:
        mp.undo()
    return json.loads(out.getvalue().strip().splitlines()[-1]), \
        err.getvalue(), box["drv"]


def test_the_cut_reads_correct_and_reports_the_decay(traced):
    line, err, drv = traced
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["checks"]) == {"unreturned", "ate_ratio", "growth",
                                   "decay_decisions_differ",
                                   "decay_score_gap", "fit_gap"}
    assert drv.raw_end == len(drv.bag)      # the window reached the end
    assert len(drv.snaps) == 16
    m = line["metrics"]
    assert set(DECAY) <= set(m)
    parts = sum(m[k]["value"] for k in DECAY[1:])
    assert 0 < parts <= m["decay_ms"]["value"]
    for k in ("host_solve_ms", "graph_edges_ms"):
        assert m[k]["value"] > 0
    want = {x["name"] for x in harness.resolve(CELL, True).metrics}
    assert set(m) <= want
    # the checks' numbers close standard error, each beside its limit
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split(":")[0] for t in tail] == [
        f"check {k}" for k in line["checks"]]


def test_the_bfloat16_control_reads_false(traced):
    _, _, drv = traced
    ctl = drv.check("cpu", control=True)
    assert not harness.correct(ctl)
    gap, lim = ctl["decay_score_gap"]
    assert gap > lim
    # not by every limit: the session's own guarantees still hold
    for k in ("unreturned", "ate_ratio", "growth"):
        assert ctl[k][0] <= ctl[k][1], k


@pytest.mark.parametrize("fault", ["a removal left out", "a score nudged",
                                   "a candidate added"])
def test_a_program_that_decides_otherwise_reads_false(traced, fault):
    _, _, drv = traced
    snaps = drv.snaps
    k = next((i for i, (_, p) in enumerate(snaps) if p["removed"]), 0)
    snap, prog = snaps[k]
    prog = dict(prog, scores=dict(prog["scores"]),
                candidates=set(prog["candidates"]))
    if fault == "a removal left out":
        assert prog["removed"]
        prog["removed"] = prog["removed"][1:]
    elif fault == "a score nudged":
        u = next(iter(prog["scores"]))
        prog["scores"][u] += 1e-6 * max(1.0, abs(prog["scores"][u]))
    else:
        prog["candidates"].add(snap["scan"] - 1000)
    drv.snaps = snaps[:k] + [(snap, prog)] + snaps[k + 1:]
    try:
        checks = drv.check("cpu")
    finally:
        drv.snaps = snaps
    assert not harness.correct(checks)
    assert checks["decay_decisions_differ"][0] >= 1 or \
        checks["decay_score_gap"][0] > checks["decay_score_gap"][1]


def test_a_program_without_the_lifelong_session_fails_at_once(monkeypatch):
    """The parent's program: SlamSession takes no `lifelong`. Set-up
    raises before it simulates anything."""
    from slam_toolbox_tpu_torch import api

    plain = api.SlamSession.__init__

    def old(self, *a, lifelong=None, **kw):
        if lifelong is not None:
            raise TypeError("unexpected keyword argument 'lifelong'")
        plain(self, *a, **kw)

    def never(*a, **kw):
        raise AssertionError("simulated before the session opened")

    monkeypatch.setattr(api.SlamSession, "__init__", old)
    monkeypatch.setattr(sim, "simulate", never)
    cell = harness.resolve(CELL, False)
    for key, val in cut().items():
        getattr(cell, key).update(val)
    ctx = harness.Context(cell.config, cell.mix, SEED, "cpu", None, False)
    drv = harness.runner_class(cell.config)(ctx)
    t = time.perf_counter()
    with pytest.raises(TypeError):
        drv.setup(51.0)
    assert time.perf_counter() - t < 5.0


def test_the_new_metrics_resolve():
    traced_names = [m["name"] for m in harness.resolve(CELL, True).metrics]
    for k in DECAY + ("step_device_ms", "host_solve_ms", "graph_edges_ms",
                      "device_idle_share.map"):
        assert k in traced_names, k
        assert callable(harness.metric_reader(k))
    plain = [m["name"] for m in harness.resolve(CELL, False).metrics]
    assert set(plain) == {"scans_per_s", "drain_p95_ms", "setup_s"}
    # on a record of the parent's program, which has no decay span, the
    # decay's readers give nothing
    rec = {"scans": 10, "stats_s": {"solve": 1.0},
           "stats_self_s": {"solve": 1.0}}
    for k in DECAY:
        assert harness.metric_reader(k)(rec) is None
    # the apartment's cell does not report them
    apt = [m["name"] for m in harness.resolve("apartment.laps", True).metrics]
    assert not set(DECAY) & set(apt)


def test_the_route_is_config_3s():
    import workloads_torch as wl

    spec = harness.resolve(CELL, False).mix
    wps = worlds.route(spec["route"], spec["world"])
    _, aisles, length, pitch = wl.warehouse()
    np.testing.assert_array_equal(
        wps, np.concatenate([wl.serpentine(aisles, length, pitch)]
                            * spec["route"]["laps"]))
    assert spec["route"]["laps"] == 104 and spec["setup_laps"] == 5


def test_the_reference_and_the_runner_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from bench_port import harness\n"
            "import bench_port.ref.decay, bench_port.runners.lifelong\n"
            "import slam_toolbox_tpu_torch.api\n"
            "harness.runner_class(harness.resolve(%r, False).config)\n"
            "print(harness.forbidden_modules())" % (harness.ROOT, CELL))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
