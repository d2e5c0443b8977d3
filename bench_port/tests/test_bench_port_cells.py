"""Each cell's harness path on the CPU at a cut: one well-formed result
line, the checks last on standard error; and the faults a run can have
make `correct` come out false."""
import io
import json
import math

import numpy as np
import pytest

from bench_port import control, harness
from bench_port.tests.more_cells import bench


def mapping_cut(cell: str) -> dict:
    """A cut of a mapping cell the CPU's plain versions run in seconds:
    1-degree beams, a 0.05 m correlation grid, short bags."""
    ov = {"config": {
        "laser": {"min_range": 0.05, "max_range": 12.0,
                  "range_threshold": 10.0,
                  "angular_resolution": float(np.deg2rad(1.0)),
                  "min_angle": -math.pi, "max_angle": math.pi}},
          "mix": {"bags": 2}}
    cfg = dict(harness.resolve(cell, False, bench()).config["mapper"])
    cfg["correlation_search_space_resolution"] = 0.05
    ov["config"]["mapper"] = cfg
    if cell == "apartment.laps":
        ov["mix"]["route"] = {"kind": "apartment_lap", "laps": 1}
    else:
        ov["mix"]["world"] = {"kind": "warehouse", "aisles": 2,
                              "length": 10.0, "pitch": 4.0}
    return ov


SOLVE_CUT = {"config": {"graph": {"sessions": 3, "nodes_per": 300},
                        "solve": {"lm_steps": 3, "cg_iters": 50,
                                  "block": 64, "dtype": "float32"}}}

CUTS = {"apartment.laps": (mapping_cut, 4.0),
        "apartment.explore": (mapping_cut, 4.0),
        "merge500k.solve": (lambda c: SOLVE_CUT, 1.0)}


def run(cell, seed=2 ** 31 + 17, trace=False):
    cut, seconds = CUTS[cell]
    out, err = io.StringIO(), io.StringIO()
    harness.run_cell(cell, seed, seconds, trace, device="cpu",
                     overrides=cut(cell), out=out, err=err, bench=bench())
    return out.getvalue(), err.getvalue()


@pytest.mark.parametrize("cell", sorted(CUTS))
def test_cell_prints_one_well_formed_result_line(cell):
    out, err = run(cell)
    last = json.loads(out.strip().splitlines()[-1])
    assert list(last) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert last["correct"] is True, last["checks"]
    assert last["attempted"] > 0 and last["failed"] == 0
    want = [m["name"] for m in harness.resolve(cell, False, bench()).metrics]
    assert sorted(last["metrics"]) == sorted(want)
    for m in last["metrics"].values():
        assert m["value"] > 0 and isinstance(m["unit"], str)
    assert set(last["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    tail = err.strip().splitlines()[-len(last["checks"]):]
    assert [t.split(":")[0] for t in tail] == [
        f"check {k}" for k in last["checks"]]


def test_the_same_seed_makes_the_same_inputs():
    from bench_port.runners import mapping

    cfg = harness.resolve("apartment.explore", False, bench())
    ov = mapping_cut("apartment.explore")
    mix = {**cfg.mix, **ov["mix"]}
    laser = mapping.sim.Laser(**ov["config"]["laser"])
    a = mapping._bags(mix, laser, 2 ** 33 + 5, [0, 1], None)
    b = mapping._bags(mix, laser, 2 ** 33 + 5, [0, 1], None)
    c = mapping._bags(mix, laser, 2 ** 33 + 6, [0], None)
    for x, y in zip(a, b):
        assert np.array_equal(x.ranges, y.ranges, equal_nan=True)
    assert not np.array_equal(a[0].odom, a[1].odom)
    assert not np.array_equal(a[0].odom, c[0].odom)
    assert len(a[0]) == len(c[0])


# -- the control and the faults: the check must fail --------------------

@pytest.mark.parametrize("cell", ["apartment.laps", "merge500k.solve"])
def test_the_control_in_the_programs_place_is_not_correct(cell):
    """control.py's readings at a cut: the program's check passes the
    harness's comparison and the control's (the reference a precision
    lower in the program's place) does not. (apartment.explore's control
    separates from its limit at the cell's size only: at this cut's
    83-scan bags it reads under it.)"""
    cut, seconds = CUTS[cell]
    r = control.readings(harness.resolve(cell, False, bench()),
                         2 ** 31 + 29, seconds, "cpu", cut(cell))
    assert r["program_correct"] is True, r
    assert r["control_correct"] is False, r
    assert set(r["control"]) == set(r["limits"]) == set(r["program"])


def _solve_fault(monkeypatch, fault):
    from slam_toolbox_tpu_torch.dist import solver_dist

    if fault == "unchanged":
        make = solver_dist.make_distributed_gn_step

        def make_unchanged(*a, **k):
            step = make(*a, **k)

            def same(poses, *args):
                new, chi2, i = step(poses, *args)
                return poses.clone(), chi2, i
            same.cg_loop = None
            return same
        monkeypatch.setattr(solver_dist, "make_distributed_gn_step",
                            make_unchanged)
    elif fault == "half":
        part = solver_dist.partition_edges

        def half(src, dst, rel, si, emask, *a):
            emask = np.asarray(emask, bool).copy()
            emask[len(emask) // 2:] = False
            return part(src, dst, rel, si, emask, *a)
        monkeypatch.setattr(solver_dist, "partition_edges", half)
    elif fault == "altered":
        solve = solver_dist.distributed_lm_solve

        def altered(*a, **k):
            out, chi2 = solve(*a, **k)
            out = out.copy()
            out[len(out) // 3, 0] += 0.05
            return out, chi2
        monkeypatch.setattr(solver_dist, "distributed_lm_solve", altered)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_faulty_solve_is_not_correct(monkeypatch, fault):
    _solve_fault(monkeypatch, fault)
    out, _ = run("merge500k.solve")
    assert json.loads(out.strip().splitlines()[-1])["correct"] is False


def _mapping_fault(monkeypatch, fault):
    from slam_toolbox_tpu_torch.mapper import streaming

    pipe = streaming.StreamingPipeline
    if fault == "unchanged":
        # each drain's steps return the state they were given: the
        # batch's rows are the ones the ring held before
        monkeypatch.setattr(pipe, "_run_eager",
                            lambda self, state, packs, odoms: state)
    elif fault == "half":
        # half of each drain's batch left out: its rows are not computed
        run_eager = pipe._run_eager

        def half(self, state, packs, odoms):
            n = packs.shape[0] // 2
            return run_eager(self, state, packs[:n], odoms[:n])
        monkeypatch.setattr(pipe, "_run_eager", half)
    elif fault == "altered":
        # answers altered where the drain produces them: one matched pose
        # in eight 5 cm off in x (the check judges a sample of the scans)
        fetch = pipe._fetch

        def altered(self, pd):
            res, spec = fetch(self, pd)
            res = res.copy()
            for i in range(0, len(pd.scans), 8):
                res[(pd.start + i) % self.result_cap, 1] += 0.05
            return res, spec
        monkeypatch.setattr(pipe, "_fetch", altered)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_faulty_mapping_run_is_not_correct(monkeypatch, fault):
    _mapping_fault(monkeypatch, fault)
    out, err = run("apartment.laps")
    last = json.loads(out.strip().splitlines()[-1])
    assert last["correct"] is False, err[-2000:]
