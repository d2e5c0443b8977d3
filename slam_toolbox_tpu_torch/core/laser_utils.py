"""Laser auto-configuration from a live scan + mounting extrinsics.

Reference parity: LaserAssistant::makeLaser / isInverted and ScanHolder
(slam_toolbox laser_utils.cpp:96-206). The reference derives the
sensor model from the first LaserScan message plus the TF base->laser
transform; here the caller passes the same data explicitly (a RawScan and
a 3D mounting transform) — no TF stack in scope.

The port's copy of slam_toolbox_tpu/core/laser_utils.py (NumPy only).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from slam_toolbox_tpu_torch.core.scan import LaserConfig


@dataclass
class RawScan:
    """The fields of sensor_msgs/LaserScan the sensor model needs."""

    angle_min: float
    angle_max: float
    angle_increment: float
    range_min: float
    range_max: float
    ranges: np.ndarray
    frame_id: str = "laser"
    time: float = 0.0

    def __post_init__(self):
        self.ranges = np.asarray(self.ranges, dtype=np.float64)


def mounting_from_transform(base_T_laser: np.ndarray):
    """Split a 4x4 (or 3x4) base->laser homogeneous transform into the
    pieces the assistant needs: planar offset (x, y, yaw) and the bits of
    3D attitude used by the inverted check."""
    T = np.asarray(base_T_laser, dtype=np.float64)
    R = T[:3, :3]
    t = T[:3, 3]
    yaw = float(np.arctan2(R[1, 0], R[0, 0]))
    return R, t, yaw


def is_inverted(base_T_laser: np.ndarray) -> bool:
    """Upside-down mounting detection (laser_utils.cpp:152-180): build
    the vector (0, 0, 1 + z_laser) in the base frame, rotate it into the
    laser frame (vectors transform rotation-only), and call the mount
    inverted when its z component is <= 0."""
    R, t, _ = mounting_from_transform(base_T_laser)
    v_base = np.array([0.0, 0.0, 1.0 + t[2]])
    v_laser = R.T @ v_base
    return bool(v_laser[2] <= 0.0)


def invert_scan(ranges: np.ndarray) -> np.ndarray:
    """Reverse the beam order of an upside-down laser's ranges
    (LaserMetadata::invertScan, laser_utils.cpp:55-70; the reference's
    loop is off by one — skips ranges[0], reads ranges[size] — this is
    the intended plain reversal)."""
    return np.asarray(ranges, dtype=np.float64)[::-1].copy()


def make_laser(
    scan: RawScan,
    base_T_laser: Optional[np.ndarray] = None,
    max_laser_range: float = 25.0,
    name: str = "Custom Described Lidar",
    warn=None,
) -> LaserConfig:
    """LaserAssistant::makeLaser (laser_utils.cpp:96-150): build the
    sensor model from a live scan + extrinsics.

    - offset pose = planar (x, y, mounting yaw) of base->laser
    - 360 detection: |angular range - 2pi| < (increment - eps*2pi),
      EXCEPT the mis-setup where a "360" laser reports [0, 360] (closed
      interval: angular range > 350 deg and round(range/increment)+1
      beams) which is treated as non-360
    - range threshold = max_laser_range clamped into (0, scan.range_max]
    """
    if base_T_laser is None:
        base_T_laser = np.eye(4)
    _, t, yaw = mounting_from_transform(base_T_laser)

    angular_range = abs(scan.angle_max - scan.angle_min)
    eps = np.finfo(np.float32).eps
    is_360 = abs(angular_range - 2.0 * np.pi) < (
        scan.angle_increment - eps * 2.0 * np.pi
    )
    if (
        angular_range > 6.10865  # 350 deg
        and round(angular_range / scan.angle_increment) + 1
        == len(scan.ranges)
    ):
        is_360 = False

    rng_threshold = float(max_laser_range)
    if rng_threshold <= 0:
        if warn is not None:
            warn(
                "maximum_laser_range must be positive; falling back to "
                f"the sensor's reported maximum ({scan.range_max:.1f} m)"
            )
        rng_threshold = float(scan.range_max)
    if rng_threshold > scan.range_max:
        if warn is not None:
            warn(
                f"maximum_laser_range ({rng_threshold:.1f} m) is beyond "
                f"what this lidar can measure ({scan.range_max:.1f} m); "
                "clamping to the sensor maximum"
            )
        rng_threshold = float(scan.range_max)

    return LaserConfig(
        name=name,
        min_range=float(scan.range_min),
        max_range=float(scan.range_max),
        range_threshold=rng_threshold,
        min_angle=float(scan.angle_min),
        max_angle=float(scan.angle_max),
        angular_resolution=float(scan.angle_increment),
        offset_pose=(float(t[0]), float(t[1]), yaw),
        is_360=bool(is_360),
        beam_count=len(scan.ranges),
    )


@dataclass
class LaserMetadata:
    """Sensor model + the inverted flag (laser_utils.hpp LaserMetadata)."""

    laser: LaserConfig
    inverted: bool = False

    def correct(self, ranges: np.ndarray) -> np.ndarray:
        return invert_scan(ranges) if self.inverted else np.asarray(
            ranges, dtype=np.float64
        )


def to_laser_metadata(
    scan: RawScan,
    base_T_laser: Optional[np.ndarray] = None,
    max_laser_range: float = 25.0,
    warn=None,
) -> LaserMetadata:
    """LaserAssistant::toLaserMetadata (laser_utils.cpp:84-94)."""
    if base_T_laser is None:
        base_T_laser = np.eye(4)
    inverted = is_inverted(base_T_laser)
    laser = make_laser(scan, base_T_laser, max_laser_range, warn=warn)
    return LaserMetadata(laser, inverted)


@dataclass
class ScanHolder:
    """Cache of raw scans for the interactive (pause-and-edit) workflow
    (ScanHolder, laser_utils.cpp:182-206): scans are stored as received
    and handed back beam-corrected for inverted mounts."""

    lasers: dict  # frame_id -> LaserMetadata
    _scans: list = field(default_factory=list)

    def add_scan(self, scan: RawScan) -> None:
        self._scans.append(scan)

    def get_corrected_scan(self, idx: int) -> RawScan:
        scan = self._scans[idx]
        meta = self.lasers[scan.frame_id]
        if meta.inverted:
            return RawScan(
                scan.angle_min, scan.angle_max, scan.angle_increment,
                scan.range_min, scan.range_max, invert_scan(scan.ranges),
                scan.frame_id, scan.time,
            )
        return scan

    def __len__(self) -> int:
        return len(self._scans)
