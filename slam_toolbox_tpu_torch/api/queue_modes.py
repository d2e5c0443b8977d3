"""Synchronous / asynchronous scan-queue policies.

Re-expression of the reference's mode split:
  - sync (slam_toolbox_sync.cpp:34-65): every accepted scan is queued and
    processed in order by a consumer (100 Hz thread there; pump() here),
    warning when the backlog exceeds 10;
  - async (slam_toolbox_async.cpp:34-57): process in the callback, drop
    everything that arrives while busy.

The port's copy of slam_toolbox_tpu/api/queue_modes.py, on the port's
SlamSession.
"""
from __future__ import annotations

import threading
import time
import warnings
from collections import deque
from typing import Optional


class PosedScan:
    """toolbox_types.hpp:41-49."""

    __slots__ = ("ranges", "odom_pose", "time")

    def __init__(self, ranges, odom_pose, t):
        self.ranges = ranges
        self.odom_pose = odom_pose
        self.time = t


class SyncQueue:
    """Deterministic processing of every accepted scan."""

    def __init__(self, session, backlog_warn: int = 10):
        self.session = session
        self.queue = deque()
        self.backlog_warn = backlog_warn
        self._lock = threading.Lock()

    def add_scan(self, ranges, odom_pose, t: float = 0.0) -> None:
        with self._lock:
            self.queue.append(PosedScan(ranges, odom_pose, t))
            if len(self.queue) > self.backlog_warn:
                warnings.warn(
                    f"queue backlog {len(self.queue)} > "
                    f"{self.backlog_warn}: processing lags input",
                    stacklevel=2,
                )

    def pump(self, max_items: Optional[int] = None) -> int:
        """Process queued scans in order; returns number processed. While
        the session's PROCESSING domain is paused the consumer idles but
        scans keep queueing (slam_toolbox_sync.cpp:40)."""
        from slam_toolbox_tpu_torch.api.slam import PausedApplication

        is_paused = getattr(self.session, "is_paused", None)
        n = 0
        while True:
            if is_paused is not None and is_paused(
                PausedApplication.PROCESSING
            ):
                break
            with self._lock:
                if not self.queue or (max_items and n >= max_items):
                    break
                item = self.queue.popleft()
            self.session.process_scan(item.ranges, item.odom_pose, item.time)
            n += 1
        return n

    def clear(self) -> int:
        """clear_queue service (slam_toolbox_sync.cpp:125-138)."""
        with self._lock:
            n = len(self.queue)
            self.queue.clear()
        return n


class AsyncPolicy:
    """Best-effort: drop scans that arrive while a scan is in flight."""

    def __init__(self, session):
        self.session = session
        self._busy = threading.Lock()
        self.dropped = 0

    def add_scan(self, ranges, odom_pose, t: float = 0.0):
        if not self._busy.acquire(blocking=False):
            self.dropped += 1
            return None
        try:
            return self.session.process_scan(ranges, odom_pose, t)
        finally:
            self._busy.release()
