"""{"kind": "segments", "segments": [[x0, y0, x1, y1], ...]}: a world
given whole as data in the mix."""
from bench_port.gen.sim import SegmentWorld


def world(spec: dict) -> SegmentWorld:
    return SegmentWorld([tuple(map(float, s)) for s in spec["segments"]])
