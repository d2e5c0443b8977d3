"""step_device_ms: device ms per accepted scan of the port's hand-written
mapping kernels (K5 ring_points, K2 scatter_occupancy, K3
smear_quantize, K1 score_windows, K7 score_tail, K8 stream_update), by
kernel name in the window's trace: the drain step's six and the verify
and near-chain programs' launches of the same kernels."""
from bench_port.gen import trace

KERNELS = ("ring_points", "scatter_occupancy", "smear_quantize",
           "score_windows", "score_tail", "stream_update")


def read(rec):
    ivals = rec.get("trace")
    if ivals is None or not rec.get("scans"):
        return None
    s = trace.named_seconds(ivals, KERNELS)
    return s * 1e3 / rec["scans"] if s > 0 else None
