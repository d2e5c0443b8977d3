"""{"kind": "rooms", "width", "height"}: the apartment, a copy of
io/dataset.py SegmentWorld.rooms (two rooms with a corridor and
furniture)."""
from bench_port.gen.sim import SegmentWorld


def world(spec: dict) -> SegmentWorld:
    w, h = spec["width"] / 2, spec["height"] / 2
    segs = [
        (-w, -h, w, -h), (w, -h, w, h), (w, h, -w, h), (-w, h, -w, -h),
        (-1.0, -h, -1.0, -4.5), (-1.0, -2.5, -1.0, 2.5),
        (-1.0, 4.5, -1.0, h),
        (2.5, -3.0, 4.5, -3.0),
        (-5.0, 0.5, -4.0, 0.5), (-4.0, 0.5, -4.0, 1.5),
        (-5.0, 1.5, -5.0, 0.5),
        (3.0, 1.5, 4.5, 1.5), (4.5, 1.5, 4.5, 2.6), (3.0, 2.6, 4.5, 2.6),
        (-4.0, -2.0, -3.0, -3.0),
    ]
    return SegmentWorld(segs)
