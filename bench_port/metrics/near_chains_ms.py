"""near_chains_ms: the host ms of the program's 'find_near_chains' span
(graph/pose_graph.py find_near_chains, both routes and any rebuild of the
query structure it triggers; a child of 'graph_edges'), summed over the
window's sessions, per accepted scan."""


def read(rec):
    s = rec.get("stats_s")
    if s is None or not rec.get("scans") or "find_near_chains" not in s:
        return None
    return s["find_near_chains"] * 1e3 / rec["scans"]
