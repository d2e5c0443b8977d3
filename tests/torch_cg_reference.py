"""The port's CG loops as they ran before the chunked CGLoop: one host
read per iteration. solve_pcg (no restart), pcg_step (a true-residual
restart every 64 iterations) and the distributed solve's step (every 32,
with the stagnation probe and the rz > 0 stop) in one function; the
tests hold solver.se2_solver.CGLoop to it bit for bit. No JAX here: the
distributed tests' rank processes import it."""
import torch


def reference_cg(mv, prec, b, stop, cg_iters, period=None, stall=False):
    """(x, iterations, r·r before each iteration, stalled)."""
    x = torch.zeros_like(b)
    r = b - mv(x)
    p = prec(r)
    rz = torch.sum(r * p)
    rr_ckpt = torch.sum(r * r)
    hist = []
    stalled = False
    i = 0

    def go():
        rr = torch.sum(r * r)
        hist.append(float(rr))
        ok = rr > stop
        return bool(ok & (rz > 0) if stall else ok)

    while i < cg_iters and go():
        hp = mv(p)
        alpha = rz / torch.clamp_min(torch.sum(p * hp), 1e-30)
        x = x + alpha * p
        restart = period is not None and i % period == period - 1
        r = b - mv(x) if restart else r - alpha * hp
        if restart and stall:
            rr = torch.sum(r * r)
            stalled = bool(rr > 0.25 * rr_ckpt)
            rr_ckpt = rr
        z = prec(r)
        rz_new = torch.sum(r * z)
        p = z if restart else z + rz_new / torch.clamp_min(rz, 1e-30) * p
        rz = rz_new
        i = cg_iters if stalled else i + 1
    return x, i, hist, stalled
