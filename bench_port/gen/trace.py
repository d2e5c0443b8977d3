"""The benchmark's reading of a device trace.

A torch.profiler trace of the card's activity over the measured window:
the device's busy seconds as the union of its operations' intervals
(copied from profile_torch.py's _device_intervals and _union_us), the
operations that took most time, the device time of named kernels, and
the idle gaps attributed to what the harness's host spans say the host
was doing. The host's spans and the trace are put on one clock by
marker kernels launched at the trace's start and end.
"""
from __future__ import annotations

import collections
import time

MARKER = "spin_kernel"     # torch.cuda._sleep's kernel


class Spans:
    """The harness's host spans, (name, start, end) on perf_counter."""

    def __init__(self):
        self.items = []

    def add(self, name: str, t0: float, t1: float) -> None:
        self.items.append((name, t0, t1))


class DeviceTrace:
    """Context manager: traces the card over its block (CUDA activity
    only; the host's side comes from Spans)."""

    def __init__(self, err=None):
        self.prof = None
        self.marks = []         # host perf_counter at each marker launch
        self.intervals = []     # (name, start_s, end_s) on perf_counter
        self.err = err

    def _mark(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.marks.append(time.perf_counter())
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._mark()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self._mark()
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.intervals = self._read()
        return False

    def _events(self):
        """(name, start_us, end_us) of every device event: from the
        profiler's Kineto results, else from its event list."""
        from torch.autograd import DeviceType

        out = []
        results = getattr(self.prof.profiler, "kineto_results", None)
        if results is not None:
            for e in results.events():
                if e.device_type() == DeviceType.CUDA:
                    s = e.start_ns() / 1e3
                    out.append((e.name(), s, s + e.duration_ns() / 1e3))
        if not out:
            for e in self.prof.events():
                if e.device_type == DeviceType.CUDA:
                    out.append((e.name, e.time_range.start,
                                e.time_range.end))
        return out

    def _read(self):
        ev = self._events()
        marks = sorted(s for name, s, _ in ev if MARKER in name)
        if self.err is not None:
            print(f"# trace: {len(ev)} device events, {len(marks)} "
                  "markers", file=self.err, flush=True)
        if not marks:
            raise RuntimeError(
                f"the trace holds no marker kernel among its {len(ev)} "
                "device events")
        # the first marker on the host's clock; where both show, the
        # trace's clock is scaled to the host's between them
        base, host0 = marks[0], self.marks[0]
        scale = 1e-6
        if len(marks) == len(self.marks) == 2 and marks[1] > marks[0]:
            scale = (self.marks[1] - host0) / (marks[1] - marks[0])
        return [(name, host0 + (s - base) * scale, host0 + (e - base) * scale)
                for name, s, e in ev if MARKER not in name]


def clip(intervals, t0: float, t1: float):
    """The intervals' parts inside [t0, t1]."""
    return [(n, max(s, t0), min(e, t1)) for n, s, e in intervals
            if e > t0 and s < t1]


def union_s(intervals) -> float:
    """Seconds covered by the union of the intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for _, s, e in sorted(intervals, key=lambda t: t[1]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, t0: float, t1: float):
    """The idle stretches of [t0, t1]: (start, end)."""
    out, cur = [], t0
    for _, s, e in sorted(intervals, key=lambda t: t[1]):
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if t1 > cur:
        out.append((cur, t1))
    return out


def device_time_by_name(intervals):
    """{name: seconds}, each operation's own duration."""
    out = collections.Counter()
    for name, s, e in intervals:
        out[name] += e - s
    return out


def named_seconds(intervals, fragments) -> float:
    """Device seconds of the operations whose names hold any fragment."""
    return sum(e - s for name, s, e in intervals
               if any(f in name for f in fragments))


def idle_by_span(intervals, spans, t0: float, t1: float):
    """Idle seconds of [t0, t1] by the name of the host span that holds
    them ("between spans" where none does), largest first."""
    import bisect

    out = collections.Counter()
    items = sorted(spans, key=lambda t: t[1])   # spans do not overlap
    starts = [s for _, s, _ in items]
    for g0, g1 in gaps(intervals, t0, t1):
        cur = g0
        while cur < g1:
            j = bisect.bisect_right(starts, cur)   # first span after cur
            if j > 0 and items[j - 1][2] > cur:    # span j - 1 holds cur
                end = min(items[j - 1][2], g1)
                out[items[j - 1][0]] += end - cur
            else:
                end = min(starts[j] if j < len(items) else g1, g1)
                out["between spans"] += end - cur
            cur = end
    return out.most_common()


def breakdown(intervals, spans, t0: float, t1: float, top: int = 10):
    """The result line's breakdown: the device operations that took most
    time and the idle seconds by what the host was doing."""
    ops = device_time_by_name(intervals).most_common(top)
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in
                          idle_by_span(intervals, spans, t0, t1)[:top]]}
