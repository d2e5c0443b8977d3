"""decay_ms: the host ms of the decay's evaluations (span decay, inclusive:
its query, filter, scores, top-up and removals), per accepted scan of
the window (the inclusive seconds of the program's utils.metrics Stats).
Nothing where the program has no such span."""


def read(rec):
    s = rec.get("stats_s")
    if s is None or not rec.get("scans") or "decay" not in s:
        return None
    return s["decay"] * 1e3 / rec["scans"]
