"""The benchmark's frozen lidar simulator.

A copy of slam_toolbox_tpu_torch/io/dataset.py (SegmentWorld, its cast,
LidarSimulator.simulate, trajectory_from_waypoints) and of the
geometry.sensor_at it calls, kept here so that a change to the program
cannot move the yardstick. Two departures, neither of which changes a
value: the laser is a plain Laser record of this module, and simulate()
casts its rays in blocks of scans instead of one scan at a time (the
generator's draws stay in the original order, one scan after another, and
the cast is elementwise, so each range equals the original's bit for
bit; bench_port/tests/test_bench_port_gen.py holds the two to it). On a
card simulate() casts the rays with torch in float64 instead (cast_torch),
within 1e-9 m of NumPy's ranges.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

CAST_BLOCK = 16


@dataclass(frozen=True)
class Laser:
    """The laser's geometry as the program's LaserConfig defines it."""

    min_range: float
    max_range: float
    range_threshold: float
    angular_resolution: float
    min_angle: float = -math.pi
    max_angle: float = math.pi
    offset_pose: tuple = (0.0, 0.0, 0.0)
    is_360: bool = True
    beam_count: int | None = None

    @property
    def n_beams(self) -> int:
        if self.beam_count is not None:
            return int(self.beam_count)
        return int(round((self.max_angle - self.min_angle)
                         / self.angular_resolution)) + 1

    @property
    def beam_angles(self) -> np.ndarray:
        return self.min_angle + self.angular_resolution * np.arange(
            self.n_beams, dtype=np.float64)


class SegmentWorld:
    """A 2-D world of wall segments (x0, y0, x1, y1)."""

    def __init__(self, segments):
        self.segments = np.asarray(segments, dtype=np.float64)

    def path_crosses_wall(self, waypoints) -> bool:
        wps = np.asarray(waypoints, dtype=np.float64)
        for i in range(len(wps) - 1):
            a, b = wps[i], wps[i + 1]
            d = b - a
            length = np.hypot(*d)
            if length < 1e-12:
                continue
            ang = np.array([np.arctan2(d[1], d[0])])
            r = self.cast(a[None], ang[None], max_range=np.inf)[0]
            if np.isfinite(r[0]) and r[0] < length - 1e-9:
                return True
        return False

    def cast(self, origins, angles, max_range: float) -> np.ndarray:
        """Nearest positive hit per ray, (P, A), for rays from P origins
        (P, 2) at their angles (P, A); no hit or beyond max_range: NaN."""
        ox, oy = origins[:, 0, None, None], origins[:, 1, None, None]
        x0, y0 = self.segments[:, 0], self.segments[:, 1]
        x1, y1 = self.segments[:, 2], self.segments[:, 3]
        ex, ey = x1 - x0, y1 - y0
        dx, dy = np.cos(angles)[..., None], np.sin(angles)[..., None]
        denom = dx * (-ey) + dy * ex
        with np.errstate(divide="ignore", invalid="ignore"):
            t = ((x0 - ox) * (-ey) + (y0 - oy) * ex) / denom
            u = (dx * (y0 - oy) - dy * (x0 - ox)) / denom
        good = (t > 1e-9) & (u >= 0.0) & (u <= 1.0) & np.isfinite(t)
        t = np.where(good, t, np.inf)
        r = t.min(axis=2)
        r[r > max_range] = np.nan
        return r


TORCH_BLOCK = 1 << 27      # ray-segment pairs a block of cast_torch


def cast_torch(world: SegmentWorld, sensors, angles, max_range: float,
               device) -> np.ndarray:
    """SegmentWorld.cast of every sensor pose's beams, in float64 on a
    torch device, blocks of scans at a time: (n, beams)."""
    import torch

    seg = torch.as_tensor(world.segments, dtype=torch.float64, device=device)
    x0, y0, x1, y1 = seg.unbind(1)
    ex, ey = x1 - x0, y1 - y0
    a = torch.as_tensor(angles, dtype=torch.float64, device=device)
    sen = torch.as_tensor(np.asarray(sensors), dtype=torch.float64,
                          device=device)
    n, nb = len(sen), len(a)
    block = max(1, TORCH_BLOCK // (nb * len(seg)))
    out = []
    for b0 in range(0, n, block):
        s = sen[b0:b0 + block]
        ang = a[None, :] + s[:, 2:3]
        ox, oy = s[:, 0, None, None], s[:, 1, None, None]
        dx, dy = torch.cos(ang)[..., None], torch.sin(ang)[..., None]
        denom = dx * (-ey) + dy * ex
        t = ((x0 - ox) * (-ey) + (y0 - oy) * ex) / denom
        u = (dx * (y0 - oy) - dy * (x0 - ox)) / denom
        good = (t > 1e-9) & (u >= 0.0) & (u <= 1.0) & torch.isfinite(t)
        r = torch.where(good, t, torch.inf).amin(dim=2)
        r = torch.where(r > max_range, torch.nan, r)
        out.append(r.cpu())
    return torch.cat(out).numpy()


def _sensor_at(pose, offset):
    """geometry.compose(pose, offset) on scalars, as the original's
    scan_at computes it."""
    ax, ay, ah = (float(v) for v in pose)
    bx, by, bh = (float(v) for v in offset)
    ca, sa = math.cos(ah), math.sin(ah)
    h = ah + bh
    return (ax + ca * bx - sa * by, ay + sa * bx + ca * by,
            math.atan2(math.sin(h), math.cos(h)))


def _relative_np(a, b):
    c, s = np.cos(a[2]), np.sin(a[2])
    dx, dy = b[0] - a[0], b[1] - a[1]
    h = np.arctan2(np.sin(b[2] - a[2]), np.cos(b[2] - a[2]))
    return np.array([c * dx + s * dy, -s * dx + c * dy, h])


def _compose_np(a, d):
    c, s = np.cos(a[2]), np.sin(a[2])
    h = np.arctan2(np.sin(a[2] + d[2]), np.cos(a[2] + d[2]))
    return np.array(
        [a[0] + c * d[0] - s * d[1], a[1] + s * d[0] + c * d[1], h])


def trajectory_from_waypoints(waypoints, step: float):
    """Piecewise-linear trajectory, heading along the motion."""
    wps = np.asarray(waypoints, dtype=np.float64)
    poses = []
    for i in range(len(wps) - 1):
        a, b = wps[i], wps[i + 1]
        seg = b - a
        dist = np.hypot(*seg)
        heading = np.arctan2(seg[1], seg[0])
        n = max(int(np.ceil(dist / step)), 1)
        for k in range(n):
            p = a + seg * (k / n)
            poses.append(np.array([p[0], p[1], heading]))
    poses.append(
        np.array([wps[-1][0], wps[-1][1], poses[-1][2] if poses else 0.0]))
    return poses


@dataclass
class Bag:
    """One simulated bag: ranges (n, beams), noisy odometry (n, 3), true
    poses (n, 3), stamps (n,)."""

    ranges: np.ndarray
    odom: np.ndarray
    truth: np.ndarray
    stamps: np.ndarray

    def __len__(self) -> int:
        return len(self.ranges)


def simulate(world: SegmentWorld, laser: Laser, waypoints, step: float,
             range_noise: float, odom_noise, seed: int, dt: float = 0.1,
             device=None) -> Bag:
    """LidarSimulator(world, laser, range_noise, odom_noise,
    seed).simulate(waypoints, step, dt), as arrays. With a torch `device`
    the rays are cast there in float64 (cast_torch), in a few large
    calls; the ranges then equal NumPy's within rounding."""
    if world.path_crosses_wall(waypoints):
        raise ValueError("trajectory crosses a wall segment")
    rng = np.random.default_rng(seed)
    true_poses = trajectory_from_waypoints(waypoints, step)
    n, nb = len(true_poses), laser.n_beams
    odoms = np.empty((n, 3))
    noise = np.empty((n, nb))
    odom = np.array(true_poses[0])
    prev_true = true_poses[0]
    for i, tp in enumerate(true_poses):
        if i > 0:
            rel = _relative_np(prev_true, tp)
            rel[0] += rng.normal(0, odom_noise[0])
            rel[1] += rng.normal(0, odom_noise[0] * 0.3)
            rel[2] += rng.normal(0, odom_noise[1])
            odom = _compose_np(odom, rel)
            prev_true = tp
        odoms[i] = odom
        if range_noise:
            noise[i] = rng.normal(0, range_noise, nb)
    sensors = np.array([_sensor_at(tp, laser.offset_pose)
                        for tp in true_poses])
    angles = laser.beam_angles
    if device is not None:
        ranges = cast_torch(world, sensors, angles, laser.max_range, device)
    else:
        ranges = np.empty((n, nb))
        for b0 in range(0, n, CAST_BLOCK):
            s = sensors[b0:b0 + CAST_BLOCK]
            ranges[b0:b0 + CAST_BLOCK] = world.cast(
                s[:, :2], angles[None, :] + s[:, 2:3], laser.max_range)
    if range_noise:
        ranges = ranges + noise
    return Bag(ranges, odoms, np.array(true_poses),
               dt * np.arange(n, dtype=np.float64))
