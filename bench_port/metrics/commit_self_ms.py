"""commit_self_ms: the self time of the program's 'commit_bookkeep' spans
(mapper/streaming.py _bookkeep: each span's duration less the part its
child spans, graph_edges, near_chain_match and loop_closure, cover), in
host ms per accepted scan, from the program's span log over the window
(utils.metrics.SPANS, on the perf_counter clock of rec's t0 and t1).
Nothing where the program keeps no span log or the log lost the window's
start."""
from bench_port.metrics.unspanned_idle_share import spans


def read(rec):
    w = spans(rec)
    if w is None or not rec.get("scans") or "commit_bookkeep" not in w[
            "names"]:
        return None
    nid = w["names"].index("commit_bookkeep")
    return float(w["self"][w["name"] == nid].sum()) * 1e3 / rec["scans"]
