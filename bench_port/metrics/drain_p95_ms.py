"""drain_p95_ms: the 95th percentile, in ms, of every call in the window
that ran a drain (process_scan calls and each finished bag's flush())."""
import numpy as np


def read(rec):
    d = rec.get("drain_s")
    if not d:
        return None
    return float(np.percentile(np.asarray(d) * 1e3, 95))
