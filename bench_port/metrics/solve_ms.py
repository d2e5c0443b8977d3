"""solve_ms: the window's seconds over the solves completed in it (a
solve the window's end cuts counts as the fraction inside it), in ms."""


def read(rec):
    if not rec.get("solves"):
        return None
    return rec["window_s"] * 1e3 / rec["solves"]
