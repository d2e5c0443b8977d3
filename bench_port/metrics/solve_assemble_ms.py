"""solve_assemble_ms: the host ms of the program's 'solve_assemble' spans
(solver/se2_solver.py host_sparse_lm: each native pass that assembles the
normal equations or a chi2, with the NumPy trig it reads; children of
'solve_lm'), summed over the window's sessions, per accepted scan.
Nothing where the program has no such span."""


def read(rec):
    s = rec.get("stats_s")
    if s is None or not rec.get("scans") or "solve_assemble" not in s:
        return None
    return s["solve_assemble"] * 1e3 / rec["scans"]
