#!/usr/bin/env python3
"""The main path three times in one process, for an A/B of two trees on
one card: bench.py's full workload (16 laps, seed 42) through
SlamSession(streaming=True, drain_every=256), each run's rate, ATE,
closures and the pipeline's host stages as one `AB {...}` JSON line.

    python3 ab_main_path.py TAG

Run it from the root of each tree in one chip call, in turns (parent,
change, change, parent), with the parent unpacked by `git archive` into
a git-ignored directory and this file copied there; the first run of
each process carries the warm-up. Uses chip_smoke.py's workload and
run_mapping, which both trees have."""
import json
import os
import sys


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from slam_toolbox_tpu_torch.api import SlamSession
    from slam_toolbox_tpu_torch.kernels import match_cuda as mc

    if not torch.cuda.is_available():
        print("ab_main_path: no CUDA device available", file=sys.stderr)
        return 2
    tag = sys.argv[1]
    mc.build_kernels(force=True)
    cfg, laser, data = cs.bench_workload(n_laps=16)
    for rep in range(3):
        sess = SlamSession(cfg, laser, device=torch.device("cuda"),
                           streaming=True, drain_every=256)
        r = cs.run_mapping(sess, data, f"ab {tag} {rep}")
        st = cs.stage_times(sess)
        print("AB " + json.dumps({
            "tree": tag, "rep": rep, "rate": r["rate"], "ate": r["ate"],
            "closures": r["closures"],
            **{k: st.get(k) for k in ("drain_fetch", "commit_bookkeep",
                                      "graph_edges", "batch_dispatch",
                                      "spec_dispatch")}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
