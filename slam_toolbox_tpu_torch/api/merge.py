"""Multi-session map merge.

PyTorch counterpart of slam_toolbox_tpu/api/merge.py, a re-expression of
merge_maps_kinematic.cpp: load N serialized sessions as submaps, apply a
rigid correction transform per submap (interactive in the reference,
programmatic here), rewrite every scan's poses/readings into the global
frame (transformScan, merge_maps_kinematic.cpp:195-248), and re-rasterize
one global occupancy map (:294-310). The merger's device (default
"cuda") carries auto_align's matcher and the render.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from slam_toolbox_tpu_torch.core import geometry
from slam_toolbox_tpu_torch.core.scan import LocalizedScan
from slam_toolbox_tpu_torch.device import resolve_device
from slam_toolbox_tpu_torch.dist.submap import maybe_sharded_create_from_scans


class MapMerger:
    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.submaps: List[list] = []   # list of scan lists
        self.corrections: List[np.ndarray] = []

    def add_submap(self, snapshot_path: str) -> int:
        """addSubmapCallback (:66-160): deserialize a session; returns the
        submap index."""
        from slam_toolbox_tpu_torch.io.serialization import load_snapshot

        mapper = load_snapshot(snapshot_path, device=self.device)
        scans = mapper.all_processed_scans()
        self.submaps.append(scans)
        self.corrections.append(np.zeros(3))
        return len(self.submaps) - 1

    def add_scans(self, scans: list) -> int:
        self.submaps.append(list(scans))
        self.corrections.append(np.zeros(3))
        return len(self.submaps) - 1

    def set_correction(self, submap_idx: int, transform) -> None:
        """The reference accumulates interactive-marker deltas
        (processInteractiveFeedback :313-374); here the rigid SE(2)
        correction is set directly."""
        self.corrections[submap_idx] = np.asarray(transform, np.float64)

    def merged_scans(self) -> list:
        """Apply each submap's correction to its scans (transformScan)."""
        out = []
        for scans, corr in zip(self.submaps, self.corrections):
            for s in scans:
                t = LocalizedScan(s.laser, s.ranges, s.odom_pose, s.time)
                t.state_id, t.unique_id = s.state_id, s.unique_id
                t.set_corrected_pose(
                    np.asarray(geometry.compose(corr, s.corrected_pose))
                )
                out.append(t)
        return out

    def auto_align(
        self, ref_idx: int, target_idx: int,
        initial_guess: Optional[Sequence[float]] = None,
        search_size: float = 8.0, resolution: float = 0.05,
        smear_deviation: float = 0.03,
        min_response: float = 0.4,
    ) -> Optional[float]:
        """Automatically refine target's correction by correlative matching
        its anchor scan against the reference submap (the reference's
        elastic merge is explicitly future work, README:31; this provides
        the rigid-refinement step with the wide-window matcher).

        initial_guess: world pose where the target submap's first scan is
        believed to sit in the reference frame (defaults to its own pose
        composed with the current correction). Returns the match response
        on success (correction updated), None if below min_response."""
        matcher, probe, near = self.align_problem(
            ref_idx, target_idx, initial_guess, search_size, resolution,
            smear_deviation)
        if not near:
            return None
        res = matcher.match_scan(probe, near, penalize=False)
        if res.response < min_response:
            return None
        probe.set_sensor_pose(res.sensor_pose)
        # correction maps the submap's own frame onto the aligned frame:
        # compose(correction, original_pose) == matched_pose
        self.corrections[target_idx] = np.asarray(geometry.compose(
            probe.corrected_pose,
            geometry.inverse(self.submaps[target_idx][0].corrected_pose),
        ))
        return float(res.response)

    def align_problem(
        self, ref_idx: int, target_idx: int,
        initial_guess: Optional[Sequence[float]] = None,
        search_size: float = 8.0, resolution: float = 0.05,
        smear_deviation: float = 0.03,
    ):
        """What auto_align matches: (the wide-window matcher on the
        merger's device, the target's first scan placed at the guess, the
        reference submap's scans near it)."""
        from slam_toolbox_tpu_torch.kernels.match import Matcher

        ref_scans = self.submaps[ref_idx]
        tgt = self.submaps[target_idx][0]
        rt = tgt.laser.range_threshold
        matcher = Matcher(
            search_size=search_size, resolution=resolution,
            smear_deviation=smear_deviation, range_threshold=rt,
            coarse_angle_offset=np.deg2rad(20.0),
            coarse_angle_resolution=np.deg2rad(2.0),
            fine_angle_offset=np.deg2rad(0.2),
            dist_var_penalty=0.09, ang_var_penalty=0.1218,
            min_dist_penalty=0.5, min_ang_penalty=0.9,
            device=self.device,
        )
        corr = self.corrections[target_idx]
        if initial_guess is None:
            guess = np.asarray(
                geometry.compose(corr, tgt.corrected_pose)
            )
        else:
            guess = np.asarray(initial_guess, np.float64)

        probe = LocalizedScan(tgt.laser, tgt.ranges, tgt.odom_pose)
        probe.set_corrected_pose(guess)
        center = probe.sensor_pose[:2]
        # reference scans near the guess (within window + range margin)
        near = [
            s for s in ref_scans
            if np.hypot(*(s.sensor_pose[:2] - center))
            < 0.5 * search_size + rt
        ]
        return matcher, probe, near

    def merge(
        self, resolution: float = 0.05,
        min_pass_through: int = 2, occupancy_threshold: float = 0.1,
        sharded: str = "auto",
    ):
        """mergeMapCallback (:251-291): one global occupancy raster on
        the merger's device, or under a process group of several ranks
        the row-band sharded raster (`sharded`, see dist/submap.py
        maybe_sharded_create_from_scans; bit-equal)."""
        scans = self.merged_scans()
        return maybe_sharded_create_from_scans(
            scans, resolution, min_pass_through, occupancy_threshold,
            device=self.device, sharded=sharded,
        )
