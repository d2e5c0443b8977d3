"""The world and the route a mapping mix names, each by its kind.

A mix's {"world": {"kind": K, ...}} is built by
bench_port/worlds/<K>.py's world(spec), and its {"route": {"kind": R,
...}} by bench_port/routes/<R>.py's waypoints(spec, world_spec); a later
mix adds a kind as a file. The kinds `segments` and `waypoints` take the
geometry whole from the mix's data, so that a new site or route can also
come as a data file alone, with no new code.
"""
from __future__ import annotations

import numpy as np

from bench_port import harness
from bench_port.gen.sim import SegmentWorld


def world(spec: dict) -> SegmentWorld:
    return harness.plugin("worlds", spec["kind"]).world(spec)


def route(spec: dict, world_spec: dict) -> np.ndarray:
    return harness.plugin("routes", spec["kind"]).waypoints(spec,
                                                            world_spec)
