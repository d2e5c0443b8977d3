"""joint_solve_roofline: the least time of the window's solves
(gen/roofline.py: per LM step the Schwarz blocks' Cholesky at the f32
rate and one read of the graph, per CG iteration run one read of the
blocks' factors) over the device's busy seconds in the trace, in %."""
from bench_port.gen import roofline, trace


def read(rec):
    ivals = rec.get("trace")
    if ivals is None or not rec.get("cg_iters"):
        return None
    busy = trace.union_s(ivals)
    if busy <= 0:
        return None
    solves = rec["solves"]
    n = len(rec["cg_iters"])
    # the window's share of each solve's work: whole solves, and the
    # fraction of the one its end cut
    least = sum(roofline.joint_solve_least_s(
        rec["n_pad"], rec["n_edges"], rec["block"], steps, it)
        for steps, it in zip(rec["lm_steps"], rec["cg_iters"])) * solves / n
    return 100.0 * least / busy
