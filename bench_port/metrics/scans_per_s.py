"""scans_per_s: accepted scans whose poses the window's calls returned,
over the window's seconds (host clock)."""


def read(rec):
    if "scans" not in rec or rec["window_s"] <= 0:
        return None
    return rec["scans"] / rec["window_s"]
