"""cg_iters: CG iterations a solve runs, summed over its LM steps
(distributed_lm_solve.last_cg_iters), averaged over the window's solves."""


def read(rec):
    c = rec.get("cg_iters")
    if not c:
        return None
    return sum(c) / len(c)
