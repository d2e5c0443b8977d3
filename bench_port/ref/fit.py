"""The plain reference of a mapped trajectory: how well each scan fits its
predecessors where the program put them.

For a scan k of a bag, the reference places the points of the scans
before it in the bag's running buffer (the `buffer` accepted scans
before k) at the poses the program returned for them, and scores a pose
T of scan k by the correlation response a correlative matcher maximizes:
the mean over the scan's points p of exp(-d(T p)^2 / (2 sigma^2)), where
d is the distance to the nearest buffer point and sigma the smear
deviation the configuration states. From a start pose it climbs that
response by a pattern search (the 27 poses of a lattice around the
current one, each step kept while it gains, the lattice halved when none
does). The gap of a pose is the response the search reaches from it less
the response at it: a pose where the scan fits its buffer best has a gap
of 0, and one that is a centimetre off has a gap that grows with the
square of the offset.

This runs in plain PyTorch on whatever device it is given, with no
kernel and nothing of the program: the points are made from the bag's
ranges and the laser's geometry here, and the program's poses are only
judged. `dtype` runs the whole reference in another precision (the
control puts a bfloat16 reference in the program's place).
"""
from __future__ import annotations

import math

import numpy as np
import torch

NEIGHBOURS = 32          # nearest buffer points kept per scan point
START_STEP = (0.02, 0.004)     # pattern search: metres, radians
END_STEP = (0.0005, 0.0001)
MAX_MOVES = 64           # pattern-search moves at most


def scan_points(ranges: np.ndarray, laser) -> list:
    """Each scan's points in its sensor frame, (m, 2) float64, from the
    beams whose range lies in [min_range, range_threshold]."""
    angles = laser.beam_angles
    c, s = np.cos(angles), np.sin(angles)
    out = []
    for r in ranges:
        ok = np.isfinite(r) & (r >= laser.min_range) & (
            r <= laser.range_threshold)
        out.append(np.stack([r[ok] * c[ok], r[ok] * s[ok]], axis=1))
    return out


def _sensor(poses: np.ndarray, offset) -> np.ndarray:
    """Sensor poses of robot poses (n, 3)."""
    c, s = np.cos(poses[:, 2]), np.sin(poses[:, 2])
    ox, oy, oh = offset
    return np.stack([poses[:, 0] + c * ox - s * oy,
                     poses[:, 1] + s * ox + c * oy, poses[:, 2] + oh], 1)


def _world(points: np.ndarray, pose) -> np.ndarray:
    c, s = math.cos(pose[2]), math.sin(pose[2])
    return np.stack([pose[0] + c * points[:, 0] - s * points[:, 1],
                     pose[1] + s * points[:, 0] + c * points[:, 1]], 1)


class Fit:
    """The response of one scan against its buffer."""

    def __init__(self, query: np.ndarray, buffer_world: np.ndarray,
                 sigma: float, device, dtype=torch.float32):
        self.dtype = dtype
        self.q = torch.as_tensor(query, dtype=dtype, device=device)
        self.b = torch.as_tensor(buffer_world, dtype=dtype, device=device)
        self.inv2s2 = 1.0 / (2.0 * sigma * sigma)
        self.near = None

    def _place(self, poses: torch.Tensor) -> torch.Tensor:
        """The query's points at each of poses (c, 3): (c, m, 2)."""
        c, s = torch.cos(poses[:, 2]), torch.sin(poses[:, 2])
        x = (poses[:, 0, None] + c[:, None] * self.q[None, :, 0]
             - s[:, None] * self.q[None, :, 1])
        y = (poses[:, 1, None] + s[:, None] * self.q[None, :, 0]
             + c[:, None] * self.q[None, :, 1])
        return torch.stack([x, y], dim=-1)

    def _neighbours(self, pose: torch.Tensor) -> None:
        """The NEIGHBOURS nearest buffer points of each query point at
        `pose`, the candidates for its nearest point near that pose."""
        p = self._place(pose[None])[0]
        d = ((p[:, None, :] - self.b[None, :, :]) ** 2).sum(-1)
        k = min(NEIGHBOURS, self.b.shape[0])
        idx = torch.topk(d, k, dim=1, largest=False).indices
        self.near = self.b[idx]                       # (m, k, 2)

    def response(self, poses: torch.Tensor) -> torch.Tensor:
        """Response at each of poses (c, 3), about the last neighbour
        search's pose."""
        p = self._place(poses)                         # (c, m, 2)
        d2 = ((p[:, :, None, :] - self.near[None]) ** 2).sum(-1).amin(-1)
        return torch.exp(-d2 * self.inv2s2).mean(-1)

    def climb(self, start) -> tuple:
        """(pose, response) that the pattern search reaches from `start`,
        and the response at `start`, in this fit's precision."""
        dev = self.q.device
        cur = torch.as_tensor(np.asarray(start, np.float64),
                              dtype=self.dtype, device=dev)
        self._neighbours(cur)
        r0 = self.response(cur[None])[0]
        step_xy, step_th = START_STEP
        grid = torch.tensor([(i, j, k) for i in (-1, 0, 1)
                             for j in (-1, 0, 1) for k in (-1, 0, 1)],
                            dtype=self.dtype, device=dev)
        moves = 0
        while step_xy >= END_STEP[0] or step_th >= END_STEP[1]:
            scale = torch.tensor([step_xy, step_xy, step_th],
                                 dtype=self.dtype, device=dev)
            cand = cur[None] + grid * scale
            r = self.response(cand)
            i = int(torch.argmax(r))
            # a move must gain against the current pose's own neighbour
            # set (r[13] is the lattice's centre), and the moves are
            # bounded, so the search ends
            if i != 13 and r[i] > r[13] and moves < MAX_MOVES:
                cur = cand[i]
                moves += 1
                self._neighbours(cur)
            else:
                step_xy *= 0.5
                step_th *= 0.5
        best = self.response(cur[None])[0]
        return cur.double().cpu().numpy(), max(float(best), float(r0)), \
            float(r0)


def buffer_world(points: list, poses: np.ndarray, k: int, buffer: int,
                 offset) -> np.ndarray:
    """The world points of the `buffer` scans before k at `poses`."""
    sensors = _sensor(poses[max(0, k - buffer):k], offset)
    return np.concatenate([_world(points[j], s) for j, s in zip(
        range(max(0, k - buffer), k), sensors)])


def gap(points: list, poses: np.ndarray, k: int, buffer: int, laser,
        sigma: float, device, dtype=torch.float32) -> float:
    """The gap of scan k's pose in `poses` against its buffer at theirs."""
    fit = Fit(points[k], buffer_world(points, poses, k, buffer,
                                      laser.offset_pose), sigma, device,
              dtype)
    start = _sensor(poses[k:k + 1], laser.offset_pose)[0]
    _, best, r0 = fit.climb(start)
    return best - r0


def control_pose(points: list, poses: np.ndarray, odom: np.ndarray, k: int,
                 buffer: int, laser, sigma: float, device,
                 dtype=torch.bfloat16) -> np.ndarray:
    """The pose the reference in `dtype` gives scan k in the program's
    place: from the odometry prior on the program's pose of scan k - 1,
    the pattern search against the buffer at the program's poses."""
    prev, o0, o1 = poses[k - 1], odom[k - 1], odom[k]
    dh = prev[2] - o0[2]
    c, s = math.cos(dh), math.sin(dh)
    prior = np.array([
        prev[0] - (c * o0[0] - s * o0[1]) + c * o1[0] - s * o1[1],
        prev[1] - (s * o0[0] + c * o0[1]) + s * o1[0] + c * o1[1],
        o1[2] + dh])
    fit = Fit(points[k], buffer_world(points, poses, k, buffer,
                                      laser.offset_pose), sigma, device,
              dtype)
    sensor, _, _ = fit.climb(_sensor(prior[None], laser.offset_pose)[0])
    ox, oy, oh = laser.offset_pose
    h = sensor[2] - oh
    c, s = math.cos(h), math.sin(h)
    return np.array([sensor[0] - (c * ox - s * oy),
                     sensor[1] - (s * ox + c * oy), h])


def ate_rmse(est: np.ndarray, truth: np.ndarray) -> float:
    """RMSE of the xy distance between estimated and true poses, in the
    frame both start in."""
    d = np.asarray(est)[:, :2] - np.asarray(truth)[:, :2]
    return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))
