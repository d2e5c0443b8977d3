"""capture_ms: the host ms of the program's 'capture' span
(kernels/match_cuda.py capture_graph, which every CUDA-graph capture goes
through: the drain's step graph, each matcher Program and WhileProgram,
their eager warm-up included; a child of whatever span triggered it),
summed over the window's sessions, per accepted scan. Each bag is a new
session, so each captures its programs again."""


def read(rec):
    s = rec.get("stats_s")
    if s is None or not rec.get("scans") or "capture" not in s:
        return None
    return s["capture"] * 1e3 / rec["scans"]
