"""decay_topup_ms: the host ms of the decay's steady-state top-up (span
decay_topup's self time: the removals it makes are decay_remove_ms), per
accepted scan of the window (the self seconds of the program's
utils.metrics Stats). Nothing where the program has no such span."""


def read(rec):
    s = rec.get("stats_self_s")
    if s is None or not rec.get("scans") or "decay_topup" not in s:
        return None
    return s["decay_topup"] * 1e3 / rec["scans"]
