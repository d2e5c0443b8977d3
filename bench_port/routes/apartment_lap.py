"""{"kind": "apartment_lap", "laps"}: the apartment's closed lap driven
`laps` times (workloads_torch.LAP, bench.py's lap of the rooms world,
closed as scripts/bench_suite.py:206-209 closes it)."""
import numpy as np

LAP = [
    (-6.0, -3.5), (1.5, -3.5), (5.5, -3.5), (5.5, 0.5), (5.5, 3.5),
    (1.0, 3.5), (-3.0, 3.5), (-6.0, 3.0), (-6.5, -1.0),
]
APARTMENT_LAP = LAP + [LAP[0]]


def waypoints(spec: dict, world_spec: dict) -> np.ndarray:
    return np.array(APARTMENT_LAP * int(spec["laps"]))
