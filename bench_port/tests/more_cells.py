"""BENCHMARK.json with the two cells that were measured on the card and
are not in it yet (merge500k.solve, apartment.explore; PERF.md, Open
questions), as a later change would add them: their files are in
bench_port/ already, so the tests run them through the harness."""
import copy

from bench_port import harness

SOLVE_METRICS = {
    "end_to_end": [
        {"name": "solve_ms", "unit": "ms", "better": "lower", "bound": 0.25,
         "source": "host_clock"}],
    "per_layer": [
        {"name": "cg_iters", "unit": "iters", "better": "lower",
         "source": "program_counter",
         "layer": "distributed solver (dist/solver_dist.py)",
         "moves": "solve_ms"},
        {"name": "joint_solve_roofline", "unit": "%", "better": "higher",
         "source": "device_trace",
         "layer": "solver kernels (Schwarz blocks, CG loop)",
         "moves": "solve_ms"},
        {"name": "device_idle_share.solve", "unit": "%", "better": "lower",
         "source": "device_trace", "layer": "device (H100)",
         "moves": "solve_ms"}],
}


def bench() -> dict:
    b = copy.deepcopy(harness.benchmark())
    b["configs"].append({
        "name": "merge500k",
        "source": "BASELINE.json configs[4]; scripts/bench_merge500k.py",
        "file": "bench_port/configs/merge500k.json", "reduced": ["hosts"],
        "why": "the 524,288-node joint pose-graph solve"})
    b["workloads"] += [
        {"name": "merge500k.solve", "config": "merge500k",
         "traffic": "solve", "chips": 1,
         "why": "the joint solve from the same poses back to back"},
        {"name": "apartment.explore", "config": "apartment",
         "traffic": "explore", "chips": 1,
         "why": "one pass through 16 warehouse aisles, never returning"}]
    for kind in ("end_to_end", "per_layer"):
        for m in b[kind]:
            if "apartment.laps" in m.get("workloads", []):
                m["workloads"].append("apartment.explore")
        for m in SOLVE_METRICS[kind]:
            b[kind].append({**m, "workloads": ["merge500k.solve"]})
    return b
