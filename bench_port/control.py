"""A cell's check read on the program and on its control.

    python3 bench_port/control.py --workload <cell> --seeds <n> [<n> ...] \
        --seconds <s>
    python3 bench_port/control.py --config <config> --traffic <mix> ...

The cell is one of BENCHMARK.json, or one not in it yet, named by its
configuration (bench_port/configs/<config>.json) and its mix. For each
seed, in one process: a run of the cell as run.py makes it, whose check
reads the program, then the same check with the control in the
program's place: the plain reference computed in the precision below
the one the configuration states (bfloat16 for a mapping cell's float32,
TF32 for the joint solve's float32 with TF32 off). Both are judged by
the harness's own comparison against the configuration's limits; the
control has to come out not correct. Prints one JSON line a seed:
{"seed", "program": {number: value}, "program_correct",
"control": {number: value}, "control_correct", "limits"}. The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bench_port import harness  # noqa: E402
from bench_port.gen import trace  # noqa: E402


def cell_of(workload: str = None, config: str = None,
            traffic: str = None) -> harness.Cell:
    """The cell `workload` of BENCHMARK.json, or the one made of the
    configuration file `config` and the mix `traffic`."""
    if workload:
        return harness.resolve(workload, False)
    cfg = harness.load_json(os.path.join("bench_port", "configs",
                                          config + ".json"))
    mix = harness.load_json(os.path.join("bench_port", "traffic",
                                          traffic + ".json"))
    return harness.Cell(f"{config}.{traffic}", 1, cfg, mix, [])


def readings(cell: harness.Cell, seed: int, seconds: float,
             device: str = "cuda", overrides: dict = None) -> dict:
    """The program's and the control's checks of one seed, each judged."""
    import torch

    for key, val in (overrides or {}).items():
        getattr(cell, key).update(val)
    ctx = harness.Context(cell.config, cell.mix, seed, device,
                          trace.Spans(), False)
    drv = harness.runner_class(cell.config)(ctx)
    drv.setup(seconds)
    drv.window(seconds)
    drv.finish()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    program = drv.check(device)
    ctl = drv.check(device, control=True)
    return {"seed": seed,
            "program": {k: v for k, (v, _) in program.items()},
            "program_correct": harness.correct(program),
            "control": {k: v for k, (v, _) in ctl.items()},
            "control_correct": harness.correct(ctl),
            "limits": {k: lim for k, (_, lim) in ctl.items()}}


def main(argv=None) -> int:
    harness.cache_dirs()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload")
    p.add_argument("--config")
    p.add_argument("--traffic")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    a = p.parse_args(argv)
    if not a.workload and not (a.config and a.traffic):
        p.error("give --workload, or --config and --traffic")
    for seed in a.seeds:
        cell = cell_of(a.workload, a.config, a.traffic)
        print(json.dumps(readings(cell, seed, a.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
