"""graph_edges_ms: the host ms of the program's 'graph_edges' stage (its
utils.metrics Stats, summed over the window's sessions) per accepted
scan."""


def read(rec):
    s = rec.get("stats_s")
    if s is None or not rec.get("scans") or "graph_edges" not in s:
        return None
    return s["graph_edges"] * 1e3 / rec["scans"]
