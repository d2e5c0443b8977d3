"""commit_bookkeep_ms: the host ms of the program's 'commit_bookkeep'
stage (its utils.metrics Stats, summed over the window's sessions) per accepted
scan."""


def read(rec):
    s = rec.get("stats_s")
    if s is None or not rec.get("scans") or "commit_bookkeep" not in s:
        return None
    return s["commit_bookkeep"] * 1e3 / rec["scans"]
