"""{"kind": "waypoints", "points": [[x, y], ...], "repeat"}: a route
given whole as data in the mix, driven `repeat` times (default once)."""
import numpy as np


def waypoints(spec: dict, world_spec: dict) -> np.ndarray:
    return np.array([tuple(map(float, p)) for p in spec["points"]]
                    * int(spec.get("repeat", 1)))
