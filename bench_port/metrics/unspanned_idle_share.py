"""unspanned_idle_share: the share of the window's device-idle seconds
during which no span of the program was open (no call into the session:
the harness, its bag indexing, Python between calls), in %. Read from the
traced window's device intervals and the program's span log
(utils.metrics.SPANS), which share the perf_counter clock. Nothing where
the run has no trace, the program keeps no span log or the log lost the
window's start.

idle_by_program_span() attributes each idle stretch to the innermost
program span open over it; run this file to print that table for a
traced run of a cell:

    python3 bench_port/metrics/unspanned_idle_share.py --workload \\
        apartment.laps --seed <n> --seconds 51
"""
import collections
import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from bench_port.gen import trace  # noqa: E402


def spans(rec):
    """The program's spans that overlap the window (SpanLog.window), or
    None where the program keeps no log or it no longer holds the
    window's start."""
    from slam_toolbox_tpu_torch.utils import metrics

    log = getattr(metrics, "SPANS", None)
    if log is None or "t0" not in rec:
        return None
    return log.window(rec["t0"], rec["t1"])


def innermost(w):
    """(start, end, name id) stretches covering the union of the spans of
    `w` (in the order they opened, nested as one thread's are), each
    named by the innermost span open over it. A span that outlasts the
    one it opened in is cut at that one's end."""
    out, stack, cur = [], [], None
    for s, e, n in zip(w["t0"].tolist(), w["t1"].tolist(),
                       w["name"].tolist()):
        while stack and stack[-1][0] <= s:
            end, name = stack.pop()
            if end > cur:
                out.append((cur, end, name))
                cur = end
        if stack:
            if s > cur:
                out.append((cur, s, stack[-1][1]))
            e = min(e, stack[-1][0])
        cur = s
        stack.append((e, n))
    while stack:
        end, name = stack.pop()
        if end > cur:
            out.append((cur, end, name))
            cur = end
    return out


def idle_by_program_span(gaps, w):
    """{span name, or None where no span was open: idle seconds} of the
    idle stretches `gaps` ((start, end), in order, not overlapping), each
    part charged to the innermost program span open over it."""
    out = collections.Counter()
    segs = innermost(w)
    names = w["names"]
    j = 0
    for g0, g1 in gaps:
        while j < len(segs) and segs[j][1] <= g0:
            j += 1
        covered, k = 0.0, j
        while k < len(segs) and segs[k][0] < g1:
            s, e, n = segs[k]
            part = min(e, g1) - max(s, g0)
            if part > 0:
                out[names[n]] += part
                covered += part
            k += 1
        out[None] += (g1 - g0) - covered
    return out


def read(rec):
    ivals = rec.get("trace")
    if ivals is None:
        return None
    w = spans(rec)
    if w is None:
        return None
    gaps = trace.gaps(ivals, rec["t0"], rec["t1"])
    idle = sum(g1 - g0 for g0, g1 in gaps)
    if idle <= 0:
        return None
    return 100.0 * idle_by_program_span(gaps, w)[None] / idle


def main(argv=None) -> int:
    """Run a cell traced, as run.py does (its result line on standard
    output), and print to standard error the window's device-idle seconds
    by innermost program span beside each span name's count and self
    seconds."""
    import argparse

    from bench_port import harness

    p = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    a = p.parse_args(argv)
    t_start = harness.process_start()
    harness.cache_dirs()
    kept = {}
    plain = harness.metric_reader

    def reader(name):
        fn = plain(name)
        if name != "unspanned_idle_share":
            return fn

        def keep(rec):
            kept["rec"] = rec
            return fn(rec)
        return keep

    harness.metric_reader = reader
    harness.run_cell(a.workload, a.seed, a.seconds, True, t_start=t_start)
    rec = kept.get("rec")
    w = spans(rec) if rec is not None else None
    if w is None or rec.get("trace") is None:
        print("no trace or no span log to attribute", file=sys.stderr)
        return 1
    gaps = trace.gaps(rec["trace"], rec["t0"], rec["t1"])
    by = idle_by_program_span(gaps, w)
    own, count = collections.Counter(), collections.Counter()
    for n, s in zip(w["name"].tolist(), w["self"].tolist()):
        own[w["names"][n]] += s
        count[w["names"][n]] += 1
    window = rec["t1"] - rec["t0"]
    roots = w["parent"] == -1
    print(f"# window {window:.3f} s, idle {sum(by.values()):.3f} s, "
          f"{len(w['index'])} spans ({len(w['index']) / rec['scans']:.2f} "
          f"a scan), self sum {w['self'].sum():.6f} s, roots "
          f"{(w['t1'] - w['t0'])[roots].sum():.6f} s", file=sys.stderr)
    print("# span | spans | idle s | self s", file=sys.stderr)
    for name, s in by.most_common():
        print(f"# {name or '(no span)'} | {count.get(name, 0)} | {s:.4f} | "
              f"{own.get(name, 0.0):.4f}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
