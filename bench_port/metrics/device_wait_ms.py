"""device_wait_ms: the host ms the program blocks on the device, per
accepted scan: its spans around the calls that wait, summed over the
window's sessions. 'drain_fetch' (the drain's result copy, its event's
synchronize), 'near_chain_wait' (the near-chain rows' blocking copy to
the host) and 'loop_verify_wait' (the verify rows' event synchronize). A
program that records no 'process_scan' root span (no span log) gives
nothing."""

STAGES = ("drain_fetch", "near_chain_wait", "loop_verify_wait")


def read(rec):
    s = rec.get("stats_s")
    if s is None or not rec.get("scans") or "process_scan" not in s:
        return None
    return sum(s.get(k, 0.0) for k in STAGES) * 1e3 / rec["scans"]
