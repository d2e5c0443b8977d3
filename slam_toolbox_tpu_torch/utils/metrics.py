"""Per-stage timing and counters, and the log of the spans they time.

The reference's only observability is MapperListener event strings
(Mapper.h:48-105) and RCLCPP logs (SURVEY.md §5); this provides the
per-stage timing the build plan calls for.

Every stage timed with stage_timer is a span. Its parent is the innermost
span still open on the same thread (a per-thread stack shared by every
Stats), and a span with none is a root: one call into the session. When a
span closes it adds its duration to its Stats' `seconds` (inclusive, as
every stage name has always meant), its self time (the duration less the
part its children cover) to `self_seconds`, one to `counts`, and itself
to SPANS, the process's ring of recent spans. Times are
time.perf_counter() seconds, the clock the benchmark maps the device's
trace onto. A disabled Stats costs one check: no clock read, no stack, no
log.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict
from typing import Dict

import numpy as np


class Stats:
    """Call counts, inclusive and self seconds per named stage."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.counts: Dict[str, int] = defaultdict(int)
        self.seconds: Dict[str, float] = defaultdict(float)
        self.self_seconds: Dict[str, float] = defaultdict(float)

    def count(self, stage: str, n: int = 1) -> None:
        if self.enabled:
            self.counts[stage] += n

    def reset(self) -> None:
        self.counts.clear()
        self.seconds.clear()
        self.self_seconds.clear()


class SpanLog:
    """The last `capacity` spans of the process. Span i (numbered from 0
    over the process, in the order the spans opened) sits at slot
    i % capacity once it has closed; `parent` and `root` are such numbers
    (-1: none), `name` an index into `names`. The columns are numpy arrays
    that stay untouched (unmapped) until written, written through
    memoryviews."""

    COLUMNS = (("index", np.int64), ("name", np.int32), ("parent", np.int64),
               ("root", np.int64), ("t0", np.float64), ("t1", np.float64),
               ("own", np.float64))

    def __init__(self, capacity: int = 1 << 20):
        if capacity <= 0 or capacity & (capacity - 1):
            raise ValueError("the capacity must be a power of two")
        self.capacity = capacity
        self._mask = capacity - 1
        self.names = [None]     # id 0 is no name, so `ids.get(n) or ...`
        self._ids = {}
        self._lock = threading.Lock()
        self._cols = {k: np.zeros(capacity, dt) for k, dt in self.COLUMNS}
        # the index column holds i + 1, so that 0 marks an empty slot
        self._views = tuple(memoryview(self._cols[k])
                            for k, _ in self.COLUMNS)
        self._written = 0                   # closed spans written

    def name_id(self, name: str) -> int:
        with self._lock:
            i = self._ids.get(name)
            if i is None:
                i = self._ids[name] = len(self.names)
                self.names.append(name)
        return i

    def _held(self) -> np.ndarray:
        """The slots that hold a closed span."""
        return np.flatnonzero(self._cols["index"])

    def lost(self) -> int:
        """Closed spans overwritten by later ones."""
        return self._written - len(self._held())

    def window(self, t0: float, t1: float):
        """The closed spans that overlap [t0, t1], in the order they
        opened: a dict of numpy arrays (index, name, parent, root, t0, t1,
        self) and `names`, the names' strings by id. None where the ring
        no longer holds the window's start: spans were overwritten and
        the oldest it holds opened after t0."""
        held = self._held()
        col = {k: v[held] for k, v in self._cols.items()}
        col["index"] -= 1
        if self._written > len(held) and (
                col["t0"][np.argmin(col["index"])] > t0):
            return None
        keep = np.flatnonzero((col["t1"] > t0) & (col["t0"] < t1))
        keep = keep[np.argsort(col["index"][keep], kind="stable")]
        out = {k: v[keep] for k, v in col.items()}
        out["self"] = out.pop("own")
        out["names"] = list(self.names)
        return out


SPANS = SpanLog()


class _Stack(threading.local):
    def __init__(self):
        self.open = []


_STACK = _Stack()
_clock = time.perf_counter
_new = object.__new__
_NEXT = itertools.count()  # spans' numbers; next() is atomic under the GIL


class _Span:
    """One timed stage; see the module's docstring."""

    __slots__ = ("stats", "stage", "index", "parent", "root", "inner",
                 "t0", "stack")

    def __enter__(self):
        stack = self.stack = _STACK.open
        i = self.index = next(_NEXT)
        if stack:
            p = self.parent = stack[-1]
            self.root = p.root
        else:
            self.parent = None
            self.root = i
        self.inner = 0.0
        stack.append(self)
        self.t0 = _clock()
        return self

    def __exit__(self, et, ev, tb):
        t1 = _clock()
        stack = self.stack
        top = stack.pop()
        if top is not self:     # an inner span left open: unwind past it
            stack.append(top)
            del stack[stack.index(self):]
        t0 = self.t0
        dur = t1 - t0
        own = dur - self.inner
        p = self.parent
        if p is None:
            pi = -1
        else:
            p.inner += dur
            pi = p.index
        st, stage = self.stats, self.stage
        st.seconds[stage] += dur
        st.self_seconds[stage] += own
        st.counts[stage] += 1
        log = SPANS
        i = self.index
        j = i & log._mask
        ix, nm, pa, ro, a, b, ow = log._views
        ix[j] = i + 1
        nm[j] = log._ids.get(stage) or log.name_id(stage)
        pa[j] = pi
        ro[j] = self.root
        a[j] = t0
        b[j] = t1
        ow[j] = own
        log._written += 1


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()

# the host's kernel launch calls and graph launch calls, as the CUDA APIs
# (cuda* and cu*) name them in a torch.profiler trace
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")
GRAPH_CALLS = ("cudaGraphLaunch", "cuGraphLaunch")


def count(stats, name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` of `stats`; with `stats` None, of the
    Stats of this thread's innermost open span (nothing where none is
    open), as stage_timer charges a span."""
    if stats is None:
        stack = _STACK.open
        if not stack:
            return
        stats = stack[-1].stats
    if stats.enabled:
        stats.counts[name] += n


def stage_timer(stats, stage: str):
    """A span named `stage` charged to `stats`; with `stats` None, to the
    Stats of this thread's innermost open span (nothing where none is
    open), for code that holds no Stats."""
    if stats is None:
        stack = _STACK.open
        if not stack:
            return _NO_SPAN
        stats = stack[-1].stats
    elif not stats.enabled:
        return _NO_SPAN
    span = _new(_Span)
    span.stats = stats
    span.stage = stage
    return span
