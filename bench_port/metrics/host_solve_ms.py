"""host_solve_ms: the host ms of the program's 'solve' stage (the pose
graph's solve on closures; utils.metrics Stats, summed over the window's
sessions) per accepted scan."""


def read(rec):
    s = rec.get("stats_s")
    if s is None or not rec.get("scans") or "solve" not in s:
        return None
    return s["solve"] * 1e3 / rec["scans"]
