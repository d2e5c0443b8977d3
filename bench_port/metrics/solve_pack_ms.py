"""solve_pack_ms: the host ms of the program's 'solve_pack' span
(solver/se2_solver.py _compute_host_sparse: the loop that packs every
edge into arrays before host_sparse_lm; a child of 'solve', beside
'solve_lm'), summed over the window's sessions, per accepted scan."""


def read(rec):
    s = rec.get("stats_s")
    if s is None or not rec.get("scans") or "solve_pack" not in s:
        return None
    return s["solve_pack"] * 1e3 / rec["scans"]
