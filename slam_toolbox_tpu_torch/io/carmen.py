"""CARMEN log-file ingestion (the 2D-SLAM community's recorded-data
interchange format: Intel Lab, ACES, MIT Killian Court, Freiburg ...).

The PyTorch port's copy of slam_toolbox_tpu/io/carmen.py (numpy only).

The reference validated against recorded ROS bags
(the reference's README.md:42-44) whose scan ingestion path is
slam_toolbox_common.cpp:715-737 (sensor_msgs/LaserScan ->
LocalizedRangeScan). Outside ROS the de-facto equivalent is the CARMEN
text log: one whitespace-separated record per line. This module reads
(and writes) the laser-relevant record types:

  PARAM <name> <value>
  ODOM x y theta tv rv accel ts host log_ts
  TRUEPOS true_x true_y true_th odom_x odom_y odom_th ts host log_ts
  FLASER n r1..rn laser_x laser_y laser_th odom_x odom_y odom_th
         ts host log_ts
  ROBOTLASER1 type start_angle fov angular_res max_range accuracy
         remission_mode n r1..rn n_rem rem1..remk
         laser_x laser_y laser_th robot_x robot_y robot_th
         tv rv fwd_safety side_safety turn_axis ts host log_ts

FLASER (old format) carries no intrinsics: following the common
converter convention (gmapping's carmenwrapper) the field of view is
taken as pi with min_angle = -pi/2 and increment = pi/num_readings.
ROBOTLASER1 (new format) carries full intrinsics per record.

Readings at/after the maximum range are no-returns: stored as +inf,
matching the engine's simulator convention (io/dataset.py).

Transparent gzip: paths ending in .gz are decompressed on the fly.
"""
from __future__ import annotations

import gzip
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from slam_toolbox_tpu_torch.core.scan import LaserConfig

# a CARMEN max-range no-return is logged as a reading at (or just below)
# the sensor ceiling; the classic SICK logs use 81.9+ for maxrange
_NO_RETURN_FRACTION = 0.995


@dataclass
class CarmenRecord:
    """One laser record: ranges + the robot odometry pose at scan time."""

    ranges: np.ndarray              # (B,) float64, no-returns = +inf
    odom_pose: np.ndarray           # (3,) robot odometry pose
    timestamp: float
    laser_pose: Optional[np.ndarray] = None   # (3,) laser pose, if logged
    true_pose: Optional[np.ndarray] = None    # (3,) TRUEPOS ground truth


@dataclass
class CarmenLog:
    laser: LaserConfig
    records: List[CarmenRecord] = field(default_factory=list)
    params: Dict[str, str] = field(default_factory=dict)

    @property
    def has_ground_truth(self) -> bool:
        return any(r.true_pose is not None for r in self.records)

    def ground_truth(self) -> Optional[np.ndarray]:
        """(N, 3) TRUEPOS poses aligned to records, or None. Records
        without a preceding TRUEPOS inherit the nearest one."""
        if not self.has_ground_truth:
            return None
        out = np.zeros((len(self.records), 3))
        last = None
        for i, r in enumerate(self.records):
            if r.true_pose is not None:
                last = r.true_pose
            out[i] = last if last is not None else np.nan
        # leading records before the first TRUEPOS: backfill
        first = next(r.true_pose for r in self.records
                     if r.true_pose is not None)
        bad = np.isnan(out[:, 0])
        out[bad] = first
        return out


def _open(path: str, mode: str = "rt"):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def is_carmen_log(path: str) -> bool:
    """Sniff: first non-comment token is a known CARMEN record type."""
    try:
        with _open(path) as f:
            for line in f:
                t = line.split(None, 1)
                if not t or t[0].startswith("#"):
                    continue
                return t[0] in {
                    "PARAM", "ODOM", "FLASER", "RLASER", "ROBOTLASER1",
                    "ROBOTLASER2", "RAWLASER1", "RAWLASER2", "TRUEPOS",
                }
    except (OSError, UnicodeDecodeError):
        return False
    return False


def _flaser_config(n: int, max_range: float) -> LaserConfig:
    """Old-format intrinsics by convention: fov pi, start -pi/2,
    increment pi/n (gmapping carmenwrapper)."""
    inc = math.pi / n
    return LaserConfig(
        name="carmen_front_laser", min_range=0.0,
        max_range=max_range,
        range_threshold=max_range * 0.98,
        min_angle=-math.pi / 2.0,
        max_angle=-math.pi / 2.0 + inc * (n - 1),
        angular_resolution=inc, is_360=False, beam_count=n,
    )


def _robotlaser_config(start: float, fov: float, inc: float,
                       max_range: float, n: int) -> LaserConfig:
    return LaserConfig(
        name="carmen_robotlaser1", min_range=0.0,
        max_range=max_range,
        range_threshold=max_range * 0.98,
        min_angle=start, max_angle=start + inc * (n - 1),
        angular_resolution=inc, is_360=bool(fov >= 2 * math.pi - 1e-6),
        beam_count=n,
    )


def _mark_no_returns(r: np.ndarray, max_range: float) -> np.ndarray:
    r = r.astype(np.float64)
    r[r >= max_range * _NO_RETURN_FRACTION] = np.inf
    return r


def read_carmen(path: str, max_range_hint: Optional[float] = None,
                laser_name: Optional[str] = None) -> CarmenLog:
    """Parse a CARMEN log into (LaserConfig, records, params).

    `max_range_hint` overrides the sensor ceiling for old-format FLASER
    logs whose PARAM block doesn't carry it (default: the classic SICK
    81.92 m unless `robot_front_laser_max` is present). Records whose
    beam count differs from the first laser record are skipped (mixed
    front/rear logs: pass `laser_name` = "FLASER"/"RLASER"/"ROBOTLASER1"
    to select a stream explicitly)."""
    params: Dict[str, str] = {}
    records: List[CarmenRecord] = []
    laser: Optional[LaserConfig] = None
    pending_true: Optional[tuple] = None   # (pose, ts)
    want = laser_name

    with _open(path) as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            kind = tok[0]
            if kind == "PARAM" and len(tok) >= 3:
                params[tok[1]] = tok[2]
            elif kind == "TRUEPOS" and len(tok) >= 7:
                pose = np.array([float(tok[1]), float(tok[2]),
                                 float(tok[3])])
                ts = float(tok[7]) if len(tok) > 7 else 0.0
                pending_true = (pose, ts)
            elif kind in ("FLASER", "RLASER") and (want in (None, kind)):
                n = int(tok[1])
                if len(tok) < 2 + n + 6:
                    continue  # truncated line
                vals = np.array([float(v) for v in tok[2:2 + n]])
                rest = tok[2 + n:]
                laser_pose = np.array([float(rest[0]), float(rest[1]),
                                       float(rest[2])])
                odom = np.array([float(rest[3]), float(rest[4]),
                                 float(rest[5])])
                ts = float(rest[6]) if len(rest) > 6 else len(records) * 0.1
                if laser is None:
                    mr = max_range_hint or float(
                        params.get("robot_front_laser_max", 81.92)
                    )
                    laser = _flaser_config(n, mr)
                    want = want or kind
                if n != laser.n_beams:
                    continue
                records.append(CarmenRecord(
                    ranges=_mark_no_returns(vals, laser.max_range),
                    odom_pose=odom, timestamp=ts, laser_pose=laser_pose,
                    true_pose=(pending_true[0]
                               if pending_true is not None else None),
                ))
                pending_true = None
            elif kind in ("ROBOTLASER1", "ROBOTLASER2") and (
                want in (None, kind)
            ):
                # type start fov res maxrange accuracy remission n ...
                start, fov_, inc = (float(tok[2]), float(tok[3]),
                                    float(tok[4]))
                mr = float(tok[5])
                n = int(tok[8])
                base = 9
                if len(tok) < base + n + 1:
                    continue
                vals = np.array([float(v) for v in tok[base:base + n]])
                i = base + n
                n_rem = int(tok[i])
                i += 1 + n_rem
                if len(tok) < i + 6:
                    continue
                laser_pose = np.array([float(tok[i]), float(tok[i + 1]),
                                       float(tok[i + 2])])
                odom = np.array([float(tok[i + 3]), float(tok[i + 4]),
                                 float(tok[i + 5])])
                ts_i = i + 11
                ts = (float(tok[ts_i]) if len(tok) > ts_i
                      else len(records) * 0.1)
                if laser is None:
                    laser = _robotlaser_config(
                        start, fov_, inc, max_range_hint or mr, n
                    )
                    want = want or kind
                if n != laser.n_beams:
                    continue
                records.append(CarmenRecord(
                    ranges=_mark_no_returns(vals, laser.max_range),
                    odom_pose=odom, timestamp=ts, laser_pose=laser_pose,
                    true_pose=(pending_true[0]
                               if pending_true is not None else None),
                ))
                pending_true = None
            # ODOM records carry no scan; FLASER/ROBOTLASER1 already embed
            # the synchronized odometry, so they are skipped.

    if laser is None:
        raise ValueError(f"no laser records found in {path}")
    # sensor extrinsics: laser pose relative to the robot odometry frame
    # at the first record (constant offset assumption — matches the
    # reference's single static TF lookup, slam_toolbox_common.cpp:280)
    r0 = records[0]
    if r0.laser_pose is not None:
        dx = r0.laser_pose[:2] - r0.odom_pose[:2]
        c, s = math.cos(-r0.odom_pose[2]), math.sin(-r0.odom_pose[2])
        off = (c * dx[0] - s * dx[1], s * dx[0] + c * dx[1],
               float(np.arctan2(np.sin(r0.laser_pose[2] - r0.odom_pose[2]),
                                np.cos(r0.laser_pose[2] - r0.odom_pose[2]))))
        if max(abs(off[0]), abs(off[1]), abs(off[2])) > 1e-9:
            laser = LaserConfig(**{
                **laser.__dict__, "offset_pose": off,
            })
    return CarmenLog(laser=laser, records=records, params=params)


def write_carmen(path: str, laser: LaserConfig, ranges: np.ndarray,
                 odom: np.ndarray, times: Optional[np.ndarray] = None,
                 true_poses: Optional[np.ndarray] = None,
                 host: str = "slam-tpu") -> None:
    """Write scans as a ROBOTLASER1 log (new format: full intrinsics per
    record, so arbitrary sensors round-trip; TRUEPOS records interleave
    ground truth when given). No-return (+inf/nan) readings are logged at
    the sensor ceiling, the CARMEN convention."""
    ranges = np.asarray(ranges, np.float64)
    odom = np.asarray(odom, np.float64)
    N, B = ranges.shape
    assert B == laser.n_beams, (B, laser.n_beams)
    if times is None:
        times = np.arange(N) * 0.1
    ox, oy, oh = laser.offset_pose
    with _open(path, "wt") as f:
        f.write("# CARMEN log written by slam_toolbox_tpu_torch.io.carmen\n")
        f.write(f"PARAM robot_front_laser_max {laser.max_range:.6f}\n")
        for i in range(N):
            ts = float(times[i])
            x, y, h = odom[i]
            if true_poses is not None:
                tx, ty, th = true_poses[i]
                f.write(
                    f"TRUEPOS {tx:.6f} {ty:.6f} {th:.6f} "
                    f"{x:.6f} {y:.6f} {h:.6f} {ts:.6f} {host} {ts:.6f}\n"
                )
            r = ranges[i].copy()
            r[~np.isfinite(r)] = laser.max_range
            r = np.minimum(r, laser.max_range)
            # laser pose = odom pose composed with the extrinsic offset
            c, s = math.cos(h), math.sin(h)
            lx, ly = x + c * ox - s * oy, y + s * ox + c * oy
            lh = h + oh
            fov = laser.angular_resolution * B
            vals = " ".join(f"{v:.3f}" for v in r)
            f.write(
                f"ROBOTLASER1 0 {laser.min_angle:.6f} {fov:.6f} "
                f"{laser.angular_resolution:.6f} {laser.max_range:.6f} "
                f"0.01 0 {B} {vals} 0 "
                f"{lx:.6f} {ly:.6f} {lh:.6f} {x:.6f} {y:.6f} {h:.6f} "
                f"0.0 0.0 0.0 0.0 0.0 {ts:.6f} {host} {ts:.6f}\n"
            )
