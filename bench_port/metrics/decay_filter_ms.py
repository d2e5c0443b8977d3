"""decay_filter_ms: the host ms of the decay's IOU and constraint filter
(span decay_filter), per accepted scan of the window (the inclusive
seconds of the program's utils.metrics Stats). Nothing where the program
has no such span."""


def read(rec):
    s = rec.get("stats_s")
    if s is None or not rec.get("scans") or "decay_filter" not in s:
        return None
    return s["decay_filter"] * 1e3 / rec["scans"]
