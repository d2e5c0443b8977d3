"""{"kind": "warehouse", "aisles", "length", "pitch"}: a copy of
bench_suite._warehouse (workloads_torch.warehouse): aisles of racks with
a mid-aisle gap and rack clutter every ~7 m, outer walls."""
from bench_port.gen.sim import SegmentWorld


def world(spec: dict) -> SegmentWorld:
    aisles, length, pitch = spec["aisles"], spec["length"], spec["pitch"]
    w = aisles * pitch + 4.0
    h = length + 4.0
    segs = [(-2, -2, w - 2, -2), (w - 2, -2, w - 2, h - 2),
            (w - 2, h - 2, -2, h - 2), (-2, h - 2, -2, -2)]
    for a in range(aisles):
        x = a * pitch + pitch / 2
        segs.append((x, 0.5, x, length / 2 - 1.5))
        segs.append((x, length / 2 + 1.5, x, length - 0.5))
        y0 = 2.0 + 1.3 * a
        while y0 < length - 2.0:
            d = 0.25 + 0.15 * ((a + int(y0)) % 3)
            segs.append((x - d, y0, x, y0))
            segs.append((x - d, y0, x - d, y0 + 0.6))
            segs.append((x - d, y0 + 0.6, x, y0 + 0.6))
            y0 += 6.5 + 0.9 * ((a * 7 + int(y0)) % 3)
    return SegmentWorld(segs)
