"""{"kind": "serpentine"}: once through a warehouse world's aisles, up
one and down the next (a copy of bench_suite._serpentine)."""
import numpy as np


def waypoints(spec: dict, world_spec: dict) -> np.ndarray:
    aisles, length = world_spec["aisles"], world_spec["length"]
    pitch = world_spec["pitch"]
    wps = []
    for a in range(aisles):
        x = a * pitch
        wps += ([(x, 0.0), (x, length)] if a % 2 == 0
                else [(x, length), (x, 0.0)])
    return np.array(wps)
