"""solve_cholesky_ms: the host ms of the program's 'solve_analyze' and
'solve_factor' spans together (solver/se2_solver.py host_sparse_lm: the
native sparse Cholesky's symbolic analysis, once a solve, and its
factor-solve, once an LM step; children of 'solve_lm'), summed over the
window's sessions, per accepted scan. Nothing where the program has
neither span."""

STAGES = ("solve_analyze", "solve_factor")


def read(rec):
    s = rec.get("stats_s")
    if s is None or not rec.get("scans") or not any(k in s for k in STAGES):
        return None
    return sum(s.get(k, 0.0) for k in STAGES) * 1e3 / rec["scans"]
