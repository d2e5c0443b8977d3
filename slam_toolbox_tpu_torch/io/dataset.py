"""Synthetic lidar worlds with ground-truth trajectories.

Replaces the reference's de-facto validation-by-rosbag (SURVEY.md §4): the
reference ships no fixtures, so the test pyramid here is built on simulated
worlds with known trajectories, enabling ATE assertions.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from slam_toolbox_tpu_torch.core.scan import LaserConfig, LocalizedScan


class SegmentWorld:
    """A 2-D world of wall segments; vectorized ray casting."""

    def __init__(self, segments: np.ndarray):
        # (S, 4): x0, y0, x1, y1
        self.segments = np.asarray(segments, dtype=np.float64)

    @staticmethod
    def box(half: float = 5.0) -> "SegmentWorld":
        h = half
        return SegmentWorld(
            [(-h, -h, h, -h), (h, -h, h, h), (h, h, -h, h), (-h, h, -h, -h)]
        )

    @staticmethod
    def rooms(width: float = 16.0, height: float = 10.0) -> "SegmentWorld":
        """A two-room apartment with a corridor and some furniture —
        enough structure for unambiguous matching and a loop. Doorways are
        placed so the canonical loop trajectory (see scripts/smoke_e2e.py)
        never crosses a wall."""
        w, h = width / 2, height / 2
        segs = [
            (-w, -h, w, -h), (w, -h, w, h), (w, h, -w, h), (-w, h, -w, -h),
            # inner wall with doorways at y in [-4.5,-2.5] and [2.5,4.5]
            (-1.0, -h, -1.0, -4.5), (-1.0, -2.5, -1.0, 2.5),
            (-1.0, 4.5, -1.0, h),
            # corridor wall
            (2.5, -3.0, 4.5, -3.0),
            # furniture blocks
            (-5.0, 0.5, -4.0, 0.5), (-4.0, 0.5, -4.0, 1.5),
            (-5.0, 1.5, -5.0, 0.5),
            (3.0, 1.5, 4.5, 1.5), (4.5, 1.5, 4.5, 2.6), (3.0, 2.6, 4.5, 2.6),
            (-4.0, -2.0, -3.0, -3.0),
        ]
        return SegmentWorld(segs)

    def path_crosses_wall(self, waypoints: np.ndarray) -> bool:
        """True if any straight leg between waypoints intersects a wall —
        driving through a zero-thickness wall flips scan visibility and
        makes matching ill-posed, so simulations should validate this."""
        wps = np.asarray(waypoints, dtype=np.float64)
        for i in range(len(wps) - 1):
            a, b = wps[i], wps[i + 1]
            d = b - a
            L = np.hypot(*d)
            if L < 1e-12:
                continue
            ang = np.array([np.arctan2(d[1], d[0])])
            r = self.cast(a[None], ang[None], max_range=np.inf)[0]
            if np.isfinite(r[0]) and r[0] < L - 1e-9:
                return True
        return False

    def cast(self, origins: np.ndarray, angles: np.ndarray,
             max_range: float) -> np.ndarray:
        """Min positive intersection distance per ray, (P, A) for rays
        from P origins (P, 2) at their angles (P, A); inf -> NaN."""
        ox, oy = origins[:, 0, None, None], origins[:, 1, None, None]
        x0, y0 = self.segments[:, 0], self.segments[:, 1]
        x1, y1 = self.segments[:, 2], self.segments[:, 3]
        ex, ey = x1 - x0, y1 - y0  # (S,)
        dx, dy = np.cos(angles)[..., None], np.sin(angles)[..., None]
        # solve origin + t*d = seg0 + u*e, (P, A, S)
        denom = dx * (-ey) + dy * ex
        with np.errstate(divide="ignore", invalid="ignore"):
            t = ((x0 - ox) * (-ey) + (y0 - oy) * ex) / denom
            u = (dx * (y0 - oy) - dy * (x0 - ox)) / denom
        good = (t > 1e-9) & (u >= 0.0) & (u <= 1.0) & np.isfinite(t)
        t = np.where(good, t, np.inf)
        r = t.min(axis=2)
        r[r > max_range] = np.nan
        return r


class LidarSimulator:
    """Simulate a scan sequence along a trajectory with odometry drift."""

    def __init__(
        self,
        world: SegmentWorld,
        laser: Optional[LaserConfig] = None,
        range_noise: float = 0.01,
        odom_noise: Tuple[float, float] = (0.01, 0.004),  # m/step, rad/step
        seed: int = 0,
    ):
        self.world = world
        self.laser = laser or LaserConfig()
        self.range_noise = range_noise
        self.odom_noise = odom_noise
        self.rng = np.random.default_rng(seed)

    def scan_at(self, true_pose: np.ndarray) -> np.ndarray:
        from slam_toolbox_tpu_torch.core import geometry

        sensor = np.asarray(
            geometry.sensor_at(true_pose, np.array(self.laser.offset_pose))
        )
        angles = self.laser.beam_angles + sensor[2]
        r = self.world.cast(sensor[None, :2], angles[None],
                            self.laser.max_range)[0]
        if self.range_noise:
            r = r + self.rng.normal(0, self.range_noise, len(r))
        return r

    def simulate(
        self, waypoints: np.ndarray, step: float = 0.25, dt: float = 0.1
    ):
        """Walk waypoints at `step` spacing; returns list of
        (scan: LocalizedScan with noisy odometry, true_pose)."""
        if self.world.path_crosses_wall(waypoints):
            raise ValueError(
                "trajectory crosses a wall segment; fix the waypoints or "
                "the world (scan visibility flips make matching ill-posed)"
            )
        true_poses = trajectory_from_waypoints(waypoints, step)
        out = []
        odom = np.array(true_poses[0])
        t = 0.0
        prev_true = true_poses[0]
        for i, tp in enumerate(true_poses):
            if i > 0:
                rel = _relative_np(prev_true, tp)
                rel[0] += self.rng.normal(0, self.odom_noise[0])
                rel[1] += self.rng.normal(0, self.odom_noise[0] * 0.3)
                rel[2] += self.rng.normal(0, self.odom_noise[1])
                odom = _compose_np(odom, rel)
                prev_true = tp
            r = self.scan_at(tp)
            scan = LocalizedScan(self.laser, r, odom.copy(), time=t)
            out.append((scan, np.array(tp)))
            t += dt
        return out


def _relative_np(a, b):
    c, s = np.cos(a[2]), np.sin(a[2])
    dx, dy = b[0] - a[0], b[1] - a[1]
    h = np.arctan2(np.sin(b[2] - a[2]), np.cos(b[2] - a[2]))
    return np.array([c * dx + s * dy, -s * dx + c * dy, h])


def _compose_np(a, d):
    c, s = np.cos(a[2]), np.sin(a[2])
    h = np.arctan2(np.sin(a[2] + d[2]), np.cos(a[2] + d[2]))
    return np.array(
        [a[0] + c * d[0] - s * d[1], a[1] + s * d[0] + c * d[1], h]
    )


def trajectory_from_waypoints(waypoints: np.ndarray, step: float):
    """Piecewise-linear trajectory with heading along motion."""
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
        np.array([wps[-1][0], wps[-1][1], poses[-1][2] if poses else 0.0])
    )
    return poses


def ate_rmse(
    estimated: np.ndarray, ground_truth: np.ndarray, align: bool = False
) -> float:
    """Absolute trajectory error: RMSE of xy distance per pose.

    By default the trajectories are compared in the frame they come in
    (adequate for this package's same-frame synthetic benches, where both
    start at the identical pose). With align=True the estimate is first
    rigidly moved so its initial SE(2) pose coincides with the ground
    truth's — use that when comparing trajectories expressed in different
    frames."""
    est = np.asarray(estimated, dtype=np.float64)
    gt = np.asarray(ground_truth, dtype=np.float64)
    if align:
        # T = gt0 ∘ est0⁻¹ applied to every estimated position
        dh = gt[0, 2] - est[0, 2]
        c, s = np.cos(dh), np.sin(dh)
        xy = est[:, :2] - est[0, :2]
        est = np.stack(
            [
                gt[0, 0] + c * xy[:, 0] - s * xy[:, 1],
                gt[0, 1] + s * xy[:, 0] + c * xy[:, 1],
            ],
            axis=1,
        )
    d = est[:, :2] - gt[:, :2]
    return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))
