"""link_chain_ms: the host ms of the program's 'link_chain_to_scan' span
(graph/pose_graph.py link_chain_to_scan: the running chain's and each
accepted near chain's link, get_closest_scan_to_pose included; a child of
'graph_edges', or of a loop closure's span for a closure's link), summed
over the window's sessions, per accepted scan."""


def read(rec):
    s = rec.get("stats_s")
    if s is None or not rec.get("scans") or "link_chain_to_scan" not in s:
        return None
    return s["link_chain_to_scan"] * 1e3 / rec["scans"]
