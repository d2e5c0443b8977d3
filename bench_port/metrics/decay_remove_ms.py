"""decay_remove_ms: the host ms of the decay's node removals, marginalized
or plain, with the graph's and solver's (span decay_remove), per
accepted scan of the window (the inclusive seconds of the program's
utils.metrics Stats). Nothing where the program has no such span."""


def read(rec):
    s = rec.get("stats_s")
    if s is None or not rec.get("scans") or "decay_remove" not in s:
        return None
    return s["decay_remove"] * 1e3 / rec["scans"]
