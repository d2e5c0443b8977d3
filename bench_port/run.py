"""Run one cell of the benchmark of slam_toolbox_tpu_torch.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints the result as the last line of standard output (one JSON object:
correct, attempted, failed, metrics, device, with --trace 1 a breakdown,
and the checks last) and each number the check compares beside its
limit as the last lines of standard error. --trace 0 reports the cell's
end-to-end metrics, --trace 1 its per-layer metrics from a trace of the
window. Exits with a code other than 0, printing no result, where the
machine has fewer CUDA devices than the cell asks for.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bench_port import harness  # noqa: E402


def main(argv=None) -> int:
    t_start = harness.process_start()
    harness.cache_dirs()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    if a.seed < 0:
        p.error("--seed must be a whole number of 0 or more")
    harness.run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                     t_start=t_start)
    return 0


if __name__ == "__main__":
    sys.exit(main())
