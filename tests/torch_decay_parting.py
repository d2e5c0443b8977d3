"""Where config 3's reference decay parts between two runs at full
geometry (0.01 m grid, 1,081 beams): the JAX package and the port on the
CPU, or the port on a card and on the CPU.

    python3 tests/torch_decay_parting.py trace --pkg torch --scans 1000 \\
        --out port.pkl [--device cuda]
    python3 tests/torch_decay_parting.py trace --pkg jax --scans 1600 \\
        --out jax.pkl
    python3 tests/torch_decay_parting.py compare port.pkl jax.pkl

`trace` runs the warehouse's first N raw scans (workloads_torch's
config 3) through a streaming session (drains of 96; the JAX one with
its fused verify, as the port runs it) whose pipeline calls
LifelongMapper(steady_state_min_candidates=0).stream_hook, the
reference's decay alone, and pickles each scan's match (response, pose)
as the drain fetched it, each decay decision (scan, removed ids, the
candidates' scores) and the node count every 100 raw scans. `compare`
prints where two traces part: the first scan whose match pose differs by
more than 1e-4 m, both responses and poses there, the first decision
that differs with the scores behind it, and the node counts beside
CONFIG3.json's. A trace of the port imports no JAX; the tests import
trace() and parting()."""
from __future__ import annotations

import argparse
import json
import os
import pickle
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def trace(pkg: str, n_scans: int, device: str = "cpu") -> dict:
    """One package's run of the reference decay over the first n_scans
    raw scans: {"rows": [(response, x, y, theta)] a scan, "log": [(scan,
    removed, {candidate: score})], "curve": [(raw scan, nodes)]}."""
    import workloads_torch as wl

    laser, data = wl.warehouse_workload(laps=n_scans // 479 + 1)
    if pkg == "jax":
        os.environ.setdefault("SLAM_FUSED_LOOP", "1")
        from scripts import bench_suite as bs
        from slam_toolbox_tpu import api
        from slam_toolbox_tpu.mapper import lifelong as mod

        cfg = bs._cfg(loop_match_minimum_chain_size=5,
                      marginalize_on_removal=False)
        sess = api.SlamSession(cfg, bs._laser(), streaming=True,
                               drain_every=96)
    else:
        from slam_toolbox_tpu_torch.api import SlamSession
        from slam_toolbox_tpu_torch.mapper import lifelong as mod

        sess = SlamSession(wl.lifelong_cfg(False), laser, streaming=True,
                           drain_every=96, device=device)
    ll = mod.LifelongMapper(
        sess.mapper, mod.LifelongConfig(steady_state_min_candidates=0))
    rows, log, curve, scores = [], [], [], {}
    score, evaluate = ll._score, ll.evaluate_node_depreciation

    def scored(ref, cand, n):
        out = score(ref, cand, n)
        scores[cand.unique_id] = float(out[0])
        return out

    def logged(scan):
        scores.clear()
        removed = evaluate(scan)
        log.append((scan.unique_id, list(removed), dict(scores)))
        return removed

    ll._score, ll.evaluate_node_depreciation = scored, logged
    pipe = sess._ensure_pipe()
    pipe.post_finish = ll.stream_hook
    bookkeep = pipe._bookkeep

    def fetched(res_np, start, n):
        cap = pipe.result_cap
        rows.extend(tuple(float(v) for v in res_np[(start + i) % cap][:4])
                    for i in range(n))

    if pkg == "jax":        # _bookkeep(scans, start, res_np, ...)
        def watched(scans, start, res_np, *a, **kw):
            fetched(res_np, start, len(scans))
            return bookkeep(scans, start, res_np, *a, **kw)
    else:                   # _bookkeep(pending drain, res_np, ...)
        def watched(pd, res_np, *a, **kw):
            fetched(res_np, pd.start, len(pd.scans))
            return bookkeep(pd, res_np, *a, **kw)
    pipe._bookkeep = watched
    for i, (scan, _) in enumerate(data[:n_scans]):
        sess.process_scan(scan.ranges, scan.odom_pose, time=i * 0.1)
        if i % 100 == 0:
            curve.append((i, sess.mapper.solver.n_nodes))
    sess.flush()
    return dict(pkg=pkg, device=str(device), rows=rows, log=log,
                curve=curve)


def parting(a: dict, b: dict) -> dict:
    """Where traces a and b part: `scan` the first whose match pose
    differs by more than 1e-4 m (or rad), with both rows there, the
    largest pose and response differences before it, and `decision` the
    first decay decision that differs (its scan, both removals, and the
    scores of the candidates whose fate differs)."""
    ra, rb = np.asarray(a["rows"]), np.asarray(b["rows"])
    n = min(len(ra), len(rb))
    dpose = np.abs(ra[:n, 1:4] - rb[:n, 1:4]).max(axis=1)
    apart = np.flatnonzero(dpose > 1e-4)
    k = int(apart[0]) if len(apart) else n
    out = dict(scan=k if k < n else None,
               pose_before=float(dpose[:k].max()) if k else 0.0,
               response_before=float(np.abs(ra[:k, 0] - rb[:k, 0]).max())
               if k else 0.0)
    if k < n:
        out.update(rows=(ra[k].tolist(), rb[k].tolist()))
    for (sa, rem_a, sc_a), (sb, rem_b, sc_b) in zip(a["log"], b["log"]):
        if (sa, rem_a) != (sb, rem_b):
            odd = sorted(set(rem_a) ^ set(rem_b))
            out["decision"] = dict(
                scan=(sa, sb), removed=(rem_a, rem_b),
                scores={c: (sc_a.get(c), sc_b.get(c)) for c in odd})
            break
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("trace")
    t.add_argument("--pkg", choices=("torch", "jax"), required=True)
    t.add_argument("--scans", type=int, required=True)
    t.add_argument("--device", default="cpu")
    t.add_argument("--out", required=True)
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = ap.parse_args(argv)
    if args.cmd == "trace":
        if args.device == "cpu":
            import torch

            torch.set_num_threads(2)
        rec = trace(args.pkg, args.scans, args.device)
        with open(args.out, "wb") as f:
            pickle.dump(rec, f)
        print(f"{args.pkg} on {args.device}: {args.scans} raw scans, "
              f"nodes {json.dumps(rec['curve'][-1])}")
        return 0
    with open(args.a, "rb") as f:
        a = pickle.load(f)
    with open(args.b, "rb") as f:
        b = pickle.load(f)
    with open(os.path.join(REPO, "CONFIG3.json")) as f:
        record = json.load(f)["variants"]["reference_decay"]
    print(f"{a['pkg']} on {a['device']} against {b['pkg']} on "
          f"{b['device']}: {json.dumps(parting(a, b), default=str)}")
    ca, cb = dict(a["curve"]), dict(b["curve"])
    rec = dict(record["nodes_vs_scans"])
    print("nodes (raw scan: a, b, CONFIG3.json): " + ", ".join(
        f"{i}: {ca[i]}, {cb[i]}, {rec.get(i)}" for i in sorted(ca)
        if i in cb and i % 800 == 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
