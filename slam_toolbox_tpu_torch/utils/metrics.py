"""Per-stage timing / counters.

The reference's only observability is MapperListener event strings
(Mapper.h:48-105) and RCLCPP logs (SURVEY.md §5); this provides the
per-stage timing the build plan calls for. Zero-cost when disabled.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict


class Stats:
    """Accumulates call counts and wall time per named stage."""

    MAX_SAMPLES = 64

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.counts: Dict[str, int] = defaultdict(int)
        self.seconds: Dict[str, float] = defaultdict(float)
        self.samples: Dict[str, list] = defaultdict(list)

    def add(self, stage: str, seconds: float, n: int = 1) -> None:
        if self.enabled:
            self.counts[stage] += n
            self.seconds[stage] += seconds
            s = self.samples[stage]
            if len(s) < self.MAX_SAMPLES:
                s.append(round(seconds, 4))

    def count(self, stage: str, n: int = 1) -> None:
        if self.enabled:
            self.counts[stage] += n

    def note(self, stage: str, *values) -> None:
        """Record a sample tuple (e.g. batch sizes) without timing."""
        if self.enabled:
            self.counts[stage] += 1
            s = self.samples[stage]
            if len(s) < self.MAX_SAMPLES:
                s.append(values)

    def summary(self) -> Dict[str, dict]:
        return {
            k: {
                "count": self.counts[k],
                "total_s": round(self.seconds[k], 4),
                "mean_ms": round(
                    1e3 * self.seconds[k] / max(self.counts[k], 1), 3
                ),
            }
            for k in sorted(set(self.counts) | set(self.seconds))
        }

    def reset(self) -> None:
        self.counts.clear()
        self.seconds.clear()
        self.samples.clear()


GLOBAL_STATS = Stats(enabled=False)

# the host's kernel launch calls and graph launch calls, as the CUDA APIs
# (cuda* and cu*) name them in a torch.profiler trace
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")
GRAPH_CALLS = ("cudaGraphLaunch", "cuGraphLaunch")


@contextlib.contextmanager
def stage_timer(stats: Stats, stage: str):
    if not stats.enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        stats.add(stage, time.perf_counter() - t0)
