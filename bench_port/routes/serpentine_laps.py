"""{"kind": "serpentine_laps", "laps"}: the serpentine of
routes/serpentine.py driven `laps` times, each lap closed by the drive
from its last aisle's end back to the first aisle's start (a copy of
workloads_torch.warehouse_workload's route, bench_suite cmd_config3's)."""
import numpy as np

from bench_port import harness


def waypoints(spec: dict, world_spec: dict) -> np.ndarray:
    lap = harness.plugin("routes", "serpentine").waypoints({}, world_spec)
    return np.concatenate([lap] * int(spec["laps"]))
