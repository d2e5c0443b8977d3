"""The port's CG loops as they ran before the chunked CGLoop: one host
read per iteration. solve_pcg (no restart), lm_solve's PCG step (a
true-residual restart every 64 iterations) and the distributed solve's
step (every 32, with the stagnation probe and the rz > 0 stop) in one
function; the tests hold solver.se2_solver.CGLoop to it bit for bit.
No JAX here: the distributed tests' rank processes and the card tests
import it."""
import torch


def lm_pcg_step(diag, hab, grad, src, dst, free, lam, cg_iters, cg_tol):
    """lm_solve's PCG step on these normal blocks: the CGLoop that the
    LMLoop of the Thomas tier (of the PCR tier from 4,096 nodes) builds,
    run on the inputs its head gives it. (x, CG iterations, the
    CGLoop)."""
    from slam_toolbox_tpu_torch.solver import se2_solver as ts

    n, e = diag.shape[0], src.shape[0]
    loop = ts.lm_loop("pcr" if n >= 4096 else "thomas", n, e, diag.dtype,
                      diag.device, 1, cg_iters)
    x, i = loop.cg.run(ts._pcg_inputs(diag, hab, grad, src, dst, free, lam,
                                      cg_tol))
    return x, i, loop.cg


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
