"""device_idle_share (.map, .solve, ...: one reader for each cell's
name of it): the share of the traced window in which no
operation ran on the device, in % (1 - the union of the device's
operation intervals over the window's seconds)."""
from bench_port.gen import trace


def read(rec):
    ivals = rec.get("trace")
    if ivals is None:
        return None
    window = rec["t1"] - rec["t0"]
    return 100.0 * (1.0 - trace.union_s(ivals) / window)
