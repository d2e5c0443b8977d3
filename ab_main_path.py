#!/usr/bin/env python3
"""The port's paths in one process, for an A/B of two trees on one card.

    python3 ab_main_path.py TAG [REPS]

Each of REPS rounds (default 3) runs, in this order:
  - the main path: bench.py's full workload (16 laps, seed 42) through
    SlamSession(streaming=True, drain_every=256), with the step graph
    ("streaming") and with the Python loop in its place ("streaming
    eager");
  - the classic session on 2 laps, with its matches as program replays
    ("classic") and with the matchers' eager route ("classic eager").
Then REPS times the step kernels' wrappers on chip_smoke's step inputs
at the sequential matcher's geometry: K5 (ring_points_step), K7
(score_tail), K8 (stream_update) and a match's coarse pass (K1's head
form, score_windows_head, where the tree has it, else the separate head
kernel and K1 it replaces, "score_head+score_windows"), with K2
(scatter_occupancy) as the control, each the mean of 200 calls timed
with CUDA events (the host's launch path, since each kernel takes a few
microseconds on the card); and the device ms of the coarse pass and of
K1's table form on the plain head's tables (`device_ms`: CUDA graph
replays of 50 calls, chip_smoke.graph_ms). Each run prints one `AB
{...}` JSON line: the rate, ATE, closures and the host stages of the
pipeline, or the wrappers' ms.

Run it from the root of each tree in one chip call, in turns (parent,
change, change, parent), with the parent unpacked by `git archive` into
a git-ignored directory and this file copied there; the first round of
each process carries the warm-up. Uses chip_smoke.py's workloads and
helpers, which both trees have."""
import json
import os
import sys
import time


def wrapper_ms(cs, dev, n: int = 200) -> dict:
    """K2's, K5's, K7's and K8's wrappers and a match's coarse pass on the
    sequential matcher's step inputs (chip_smoke.step_inputs): ms a call,
    CUDA events over n; and the coarse pass's and K1 table form's device
    ms (graph replays)."""
    import torch

    from slam_toolbox_tpu_torch.core.scan import LocalizedScan
    from slam_toolbox_tpu_torch.kernels import match_cuda as mc
    from slam_toolbox_tpu_torch.kernels import step_cuda as sc
    from slam_toolbox_tpu_torch.mapper import Mapper

    cfg, laser, data = cs.bench_workload(n_laps=2)
    mapper = Mapper(cfg, device=dev)
    mapper.initialize(laser.range_threshold)
    m = mapper.sequential_matcher

    def scan_at(i):
        s = LocalizedScan(laser, data[i][0].ranges, data[i][0].odom_pose)
        s.set_corrected_pose(data[i][1])
        return s

    ring = cfg.scan_buffer_size + 2
    base, query = [scan_at(i) for i in range(ring)], scan_at(ring + 1)
    inp = cs.kernel_inputs(m, base, query, dev)
    scale = float(torch.tensor(m.scale, dtype=torch.float32))
    words = mc.scatter_occupancy(inp["pts"], inp["valid"], inp["off"],
                                 scale, m.G)
    grid = mc.smear_quantize(words, m._w, m.G, m.half_kernel)
    si = cs.step_inputs(m, base, query, dev)
    st = si["state"]
    K = st["ring_pack"].shape[0]
    args = cs.score_tail_args(m, grid, si["center_off"], si["local"],
                              si["finite"], True, True)
    packed = sc.score_tail(*args)
    eye9 = torch.eye(3, device=dev).reshape(-1)
    upd = (packed, si["center_off"], si["scan_pack"], si["odom"],
           si["offset_pose"], eye9)
    s5, s8 = cs.clone_state(st), cs.clone_state(st)
    kw = m._score_args
    head = (si["center_off"], si["local"], kw["x_off_c"], kw["y_off_c"],
            kw["scale"], kw["coarse_angle_offset"], kw["coarse_angle_res"],
            kw["na_coarse"])
    n_c = len(m._xy_coarse)

    def coarse_pass():
        if hasattr(sc, "score_windows_head"):
            return sc.score_windows_head(grid, m.G, head[0], head[1],
                                         si["finite"], *head[2:])
        ang, d, cand0 = sc.score_head(*head, m.G)
        return mc.score_windows(grid, m.G, d, cand0[0:1], cand0[1:2], n_c,
                                n_c, si["finite"])

    calls = {
        # K2, whose host code neither tree changes: the control
        "scatter_occupancy": lambda: mc.scatter_occupancy(
            inp["pts"], inp["valid"], inp["off"], scale, m.G),
        ("score_windows_head" if hasattr(sc, "score_windows_head")
         else "score_head+score_windows"): coarse_pass,
        "ring_points_step": lambda: sc.ring_points_step(
            s5, si["offset_pose"], si["half"], m.G),
        "score_tail": lambda: sc.score_tail(*args),
        "stream_update": lambda: sc.stream_update(*upd, s8, K - 3, 9.0,
                                                  m.G),
    }
    out = {name: cs.event_ms(fn, n) for name, fn in calls.items()}
    _, d, cand0 = sc.score_head_plain(*head)
    out["device_ms"] = {
        "coarse_pass": cs.graph_ms(coarse_pass, 50)[0],
        "score_windows_table": cs.graph_ms(lambda: mc.score_windows(
            grid, m.G, d.contiguous(), cand0[0:1], cand0[1:2], n_c, n_c,
            si["finite"]), 50)[0]}
    if hasattr(sc, "tail_clusters"):
        # the host checks the change adds before K7's and K8's launches:
        # us a call of tail_clusters (cached) and of one alignment test
        geometry = sc.score_tail_launch(
            *args[0].shape, si["local"].shape[0], args[-2])
        for name, fn in (
                ("tail_clusters_us",
                 lambda: sc.tail_clusters(geometry, dev)),
                ("aligned16_us",
                 lambda: sc._aligned16(st["ring_pack"], "ring_pack"))):
            t0 = time.perf_counter()
            for _ in range(100000):
                fn()
            out[name] = 10 * (time.perf_counter() - t0)
    return out


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
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    dev = torch.device("cuda")
    mc.build_kernels(force=True)
    cfg16, laser16, data16 = cs.bench_workload(n_laps=16)
    cfg2, laser2, data2 = cs.bench_workload(n_laps=2)

    def streaming(eager):
        sess = SlamSession(cfg16, laser16, device=dev, streaming=True,
                           drain_every=256)
        if eager:   # the Python loop in place of the step graph
            pipe = sess._ensure_pipe()
            pipe._run_batch = pipe._run_eager
        return cs.run_mapping(sess, data16, f"ab {tag}")

    def classic(eager):
        return cs.classic_run(cfg2, laser2, data2, dev, f"ab {tag}",
                              eager=eager)

    for rep in range(reps):
        for route, run, eager in (("streaming", streaming, False),
                                  ("streaming eager", streaming, True),
                                  ("classic", classic, False),
                                  ("classic eager", classic, True)):
            r = run(eager)
            st = cs.stage_times(r["sess"])
            print("AB " + json.dumps({
                "tree": tag, "rep": rep, "route": route, "rate": r["rate"],
                "ate": r["ate"], "closures": r["closures"],
                **{k: st.get(k) for k in (
                    "drain_fetch", "commit_bookkeep", "graph_edges",
                    "batch_dispatch", "spec_dispatch",
                    "sequential_match")}}), flush=True)
    for rep in range(reps):
        print("AB " + json.dumps({"tree": tag, "rep": rep,
                                  "route": "wrappers",
                                  "ms": wrapper_ms(cs, dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
