"""score_tail_roofline: the least time of the window's score_tail launches
(gen/roofline.py's counts at each launch's geometry, by the launch
counters' raster side G) over their device time in the trace, in %."""
from bench_port.gen import roofline, trace


def read(rec):
    ivals = rec.get("trace")
    launches = (rec.get("launches") or {}).get("score_tail")
    if ivals is None or not launches:
        return None
    dev_s = trace.named_seconds(ivals, ("score_tail",))
    if dev_s <= 0:
        return None
    least = roofline.kernel_least_s("score_tail", launches, rec["geometries"],
                                    rec["beams"])
    return 100.0 * least / dev_s
