"""User-facing driver mirroring the reference's ROS node + service surface.

PyTorch counterpart of slam_toolbox_tpu/api/slam.py: scan ingestion
gates (shouldProcessScan, slam_toolbox_common.cpp:740-786), mode dispatch
(addScan, :798-859) for mapping and elastic localization, map->odom
maintenance (setTransformFromPoses, :657-712), pose reporting with
covariance scaling (publishPose, :862-884), the pause domains and the
interactive mode, the managed-node lifecycle with its bond heartbeat, a
watchdog over the device fetches, and warming. With streaming=False
process_scan is synchronous: every scan is matched, linked and
loop-closed before it returns. With streaming=True scans go through the
device-resident pipeline (mapper/streaming.py): process_scan returns the
propagated prior at once and corrected poses land at drains (every
`drain_every` scans, or on flush() and the accessors). Localization
keeps a rolling buffer of its newest scans in the graph (the oldest is
removed as each new one lands), through the pipeline's post_finish hook
when streaming.

The services: get_occupancy_grid (cached, folding new scans
incrementally), serialize, deserialize with every match type
(LOCALIZE_AT_POSE switches the session to localization), toggle_mode,
set_initial_pose, clear_localization_buffer, modify_node and
manual_loop_closure (the loop-closure assistant's edits).
"""
from __future__ import annotations

import contextlib
import enum
import gc
import logging
import threading
from typing import Optional, Tuple

import numpy as np

from slam_toolbox_tpu_torch.core import geometry
from slam_toolbox_tpu_torch.core.params import MapperConfig
from slam_toolbox_tpu_torch.core.scan import LaserConfig, LocalizedScan
from slam_toolbox_tpu_torch.dist.submap import maybe_sharded_create_from_scans
from slam_toolbox_tpu_torch.kernels import occupancy
from slam_toolbox_tpu_torch.mapper import Mapper


class ProcessType(enum.Enum):
    """toolbox_types.hpp:85-91."""

    PROCESS = 0
    PROCESS_FIRST_NODE = 1
    PROCESS_NEAR_REGION = 2
    PROCESS_LOCALIZATION = 3


class MatchType(enum.Enum):
    """DeserializePoseGraph.srv match types."""

    UNSET = 0
    START_AT_FIRST_NODE = 1
    START_AT_GIVEN_POSE = 2
    LOCALIZE_AT_POSE = 3


class PausedApplication(enum.Enum):
    """The three independent pause domains (toolbox_types.hpp:77-83):
    PROCESSING stops the sync queue's consumer (scans keep queueing,
    slam_toolbox_sync.cpp:40); VISUALIZING_GRAPH suppresses graph
    publishes (slam_toolbox_common.cpp:524); NEW_MEASUREMENTS drops
    incoming scans at the gate (slam_toolbox_common.cpp:762)."""

    PROCESSING = 0
    VISUALIZING_GRAPH = 1
    NEW_MEASUREMENTS = 2


class PausedState:
    """Thread-safe pause map (PausedState, toolbox_types.hpp:92-117)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._state = {app: False for app in PausedApplication}

    def set(self, app: PausedApplication, state: bool) -> None:
        with self._lock:
            self._state[app] = bool(state)

    def get(self, app: PausedApplication) -> bool:
        with self._lock:
            return self._state[app]


class SlamSession:
    def __init__(
        self,
        config: Optional[MapperConfig] = None,
        laser: Optional[LaserConfig] = None,
        mode: str = "mapping",
        throttle_scans: int = 1,
        minimum_time_interval: float = 0.0,
        position_covariance_scale: float = 1.0,
        yaw_covariance_scale: float = 1.0,
        streaming: bool = False,
        drain_every: int = 8,
        device=None,
    ):
        """`device` defaults to "cuda" and raises RuntimeError when no GPU
        is present; pass device="cpu" to run the plain versions on the
        CPU. streaming=True routes scans through the device-resident
        pipeline, drained every `drain_every` scans."""
        self.config = config or MapperConfig()
        self.laser = laser
        self.mapper = Mapper(self.config, device=device)
        self.device = self.mapper.device
        self.streaming = bool(streaming)
        self.drain_every = drain_every
        self._pipe = None
        self._grid_cache = None  # incremental occupancy (get_occupancy_grid)
        self._pipe_lock = threading.Lock()
        self._warm_thread = None
        self.mode = mode
        self.throttle_scans = max(int(throttle_scans), 1)
        self.minimum_time_interval = float(minimum_time_interval)
        self.position_covariance_scale = position_covariance_scale
        self.yaw_covariance_scale = yaw_covariance_scale

        self.processor_type = self._steady_processor()
        self.process_near_pose: Optional[np.ndarray] = None
        self.first_measurement = True
        self.paused_state = PausedState()
        self.interactive_mode = False
        self.scan_count = 0
        self.last_scan_time = -np.inf
        self.last_scan_odom: Optional[np.ndarray] = None
        self.map_to_odom = np.zeros(3)
        self.last_pose = np.zeros(3)
        self.last_covariance = np.eye(3)

        # managed-node lifecycle + bond heartbeat (utils/lifecycle.py;
        # slam_toolbox_common.cpp:72-96, :99-237). process_scan does not
        # consult them; they exist for callers that want the managed and
        # monitored deployment model.
        from slam_toolbox_tpu_torch.utils.lifecycle import Lifecycle

        self._bond = None
        self._watchdog = None
        self.lifecycle = Lifecycle(hooks={
            "activate": self._on_activate,
            "deactivate": self._on_deactivate,
            "cleanup": self.reset,
            "shutdown": self._on_shutdown,
        })

    # -- gates (shouldProcessScan, slam_toolbox_common.cpp:740-786) ---------
    def _should_process(self, scan: LocalizedScan) -> bool:
        self.scan_count += 1
        if self.paused:
            return False
        if self.scan_count <= 5:  # always process the first 5 scans
            return True
        if self.scan_count % self.throttle_scans != 0:
            return False
        if scan.time - self.last_scan_time < self.minimum_time_interval:
            return False
        if self.last_scan_odom is not None:
            d = scan.odom_pose[:2] - self.last_scan_odom[:2]
            min_d2 = (0.8 * self.config.minimum_travel_distance) ** 2
            if d @ d < min_d2:
                return False
        return True

    # -- main entry (laserCallback + addScan, :798-859) ---------------------
    def process_scan(
        self, ranges, odom_pose, time: float = 0.0
    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Feed one scan. Returns (corrected_robot_pose, covariance) if the
        scan was processed, else None."""
        if self.laser is None:
            raise ValueError("SlamSession requires a LaserConfig")
        scan = LocalizedScan(self.laser, ranges, odom_pose, time=time)
        if not self._should_process(scan):
            return None

        cov = np.eye(3)
        pt = self.processor_type
        streaming_path = self.streaming and (
            pt == ProcessType.PROCESS
            or (pt == ProcessType.PROCESS_LOCALIZATION
                and not self.first_measurement)
        )
        if not streaming_path and self._pipe is not None:
            # mode switch (relocalize, dock, initial pose): the classic
            # path must see fully drained and settled bookkeeping
            self._pipe.drain()
            self._pipe.settle()
        if streaming_path:
            # mapping, or steady-state elastic localization: the buffer's
            # append and evict ride the drain (post_finish)
            ok = self._ensure_pipe().process_scan(scan)
            if not ok:
                return None
            self.last_scan_time = scan.time
            self.last_scan_odom = np.array(scan.odom_pose)
            return self._streaming_online_pose(scan), cov
        elif pt == ProcessType.PROCESS:
            ok = self.mapper.process(scan, covariance_out=cov)
        elif pt == ProcessType.PROCESS_FIRST_NODE:
            ok = self.mapper.process_at_dock(scan, covariance_out=cov)
            self.processor_type = ProcessType.PROCESS
        elif pt == ProcessType.PROCESS_NEAR_REGION:
            # relocalize near a given pose (START_AT_GIVEN_POSE,
            # LOCALIZE_AT_POSE, set_initial_pose)
            if self.process_near_pose is not None:
                scan.set_corrected_pose(self.process_near_pose)
                self.process_near_pose = None
            ok = self.mapper.process_against_nodes_near_by(
                scan,
                add_to_buffer=self.mode == "localization",
                covariance_out=cov,
            )
            self.processor_type = self._steady_processor()
        elif pt == ProcessType.PROCESS_LOCALIZATION:
            # the first measurement of a localization session: classic
            ok = self.mapper.process_localization(scan, covariance_out=cov)
        else:
            return None

        if not ok:
            return None
        self.first_measurement = False
        self.last_scan_time = scan.time
        self.last_scan_odom = np.array(scan.odom_pose)
        self._set_transform_from_poses(scan)
        self.last_pose = np.array(scan.corrected_pose)
        self.last_covariance = np.array(cov)
        self.last_covariance[:2, :2] *= self.position_covariance_scale
        self.last_covariance[2, 2] *= self.yaw_covariance_scale
        return scan.corrected_pose, self.last_covariance

    def _set_transform_from_poses(self, scan: LocalizedScan) -> None:
        """map->odom = corrected ⊕ odom^-1 (setTransformFromPoses,
        slam_toolbox_common.cpp:657-712)."""
        self.map_to_odom = np.asarray(
            geometry.compose(
                scan.corrected_pose, geometry.inverse(scan.odom_pose)
            )
        )

    def _steady_processor(self) -> ProcessType:
        """The processor a session of this mode returns to."""
        return (ProcessType.PROCESS_LOCALIZATION
                if self.mode == "localization" else ProcessType.PROCESS)

    def _ensure_pipe(self):
        """The streaming pipeline, built once (warm_async's thread may ask
        for it at the same time as process_scan); in localization its
        post_finish hook keeps the rolling buffer."""
        with self._pipe_lock:
            if self._pipe is None:
                from slam_toolbox_tpu_torch.mapper.streaming import (
                    StreamingPipeline,
                )

                self._pipe = StreamingPipeline(
                    self.mapper, self.laser, drain_every=self.drain_every
                )
                if self.mode == "localization":
                    self._pipe.post_finish = self._loc_post_finish
                self._pipe.watchdog = self._watchdog
            return self._pipe

    def _streaming_online_pose(self, scan) -> np.ndarray:
        """Online pose between drains: the last drained correction
        propagated through the odometry delta (the same prior the device
        uses; exact once the scan itself has drained). Also maintains
        map->odom like the classic path."""
        last = self.mapper.sensor_manager.get_last_scan(self.laser.name)
        if last is None:
            pose = np.array(scan.corrected_pose)
        else:
            pose = np.asarray(geometry.transform_pose_between(
                last.odom_pose, last.corrected_pose, scan.odom_pose
            ))
        self.map_to_odom = np.asarray(
            geometry.compose(pose, geometry.inverse(scan.odom_pose))
        )
        self.last_pose = np.array(pose)
        return pose

    def _loc_post_finish(self, scan) -> bool:
        """Elastic-buffer bookkeeping per drained scan
        (AddScanToLocalizationBuffer, Mapper.cpp:2911-2962). Returns True
        only when eviction removed a node that was still in the RUNNING
        buffer: the device ring mirrors the running buffer, and evicting
        an old node elsewhere in the map does not touch it (a resync there
        would re-upload the ring every drain for nothing)."""
        m = self.mapper
        was_running = False
        if len(m.localization_buffer) >= m.config.scan_buffer_size:
            old = m.localization_buffer[0]
            was_running = old in m.sensor_manager.get_running_scans(
                old.laser.name
            )
        m.add_scan_to_localization_buffer(scan)
        return was_running

    def flush(self) -> None:
        """Drain the streaming pipeline (no-op on the synchronous path) and
        complete any deferred loop closure, so every accessor behind
        flush() sees fully settled poses."""
        if self._pipe is not None:
            self._pipe.drain()
            self._pipe.settle()

    @property
    def stats(self):
        """Per-stage timing counters (utils/metrics.Stats); enable with
        `sess.stats.enabled = True`."""
        return self.mapper.stats

    # -- map rendering (updateMap, :630-654) --------------------------------
    def get_occupancy_grid(self, resolution: Optional[float] = None,
                           sharded: str = "auto"):
        """Occupancy map of all processed scans, rendered for the
        session's device. Steady-state publishes are O(new scans): the
        session caches the grid and its hit/pass counters and folds only
        newly added scans via add_scans_incremental (equal to the full
        rebuild). A full re-raster happens only when poses were corrected
        or scans removed (graph.pose_revision), the resolution changed, or
        a new scan extends the map extent; under a process group of
        several ranks it may take the row-band sharded raster (`sharded`,
        see dist/submap.py maybe_sharded_create_from_scans; bit-equal)."""
        self.flush()
        scans = self.mapper.all_processed_scans()
        if not scans:
            return None
        res = float(resolution or self.config.map_resolution)
        g = self.mapper.graph
        rev = g.pose_revision if g is not None else 0
        c = self._grid_cache
        if (
            c is not None
            and c["res"] == res
            and c["rev"] == rev
            and len(scans) >= c["n"]
            and scans[c["n"] - 1].unique_id == c["last_uid"]
        ):
            new = scans[c["n"]:]
            if not new:
                return c["grid"]
            # the incremental fold is exact only while the map extent is
            # unchanged (extent = union of scan bounding boxes)
            if all(
                np.all(s.bounding_box[0] >= c["mins"])
                and np.all(s.bounding_box[1] <= c["maxs"])
                for s in new
            ):
                grid = occupancy.add_scans_incremental(
                    c["grid"], new,
                    self.config.min_pass_through,
                    self.config.occupancy_threshold,
                    device=self.device,
                )
                self._grid_cache = dict(
                    c, grid=grid, n=len(scans),
                    last_uid=scans[-1].unique_id,
                )
                return grid
        grid = maybe_sharded_create_from_scans(
            scans, res,
            self.config.min_pass_through,
            self.config.occupancy_threshold,
            device=self.device, sharded=sharded,
        )
        mins = np.full(2, np.inf)
        maxs = np.full(2, -np.inf)
        for s in scans:
            bb = s.bounding_box
            mins = np.minimum(mins, bb[0])
            maxs = np.maximum(maxs, bb[1])
        self._grid_cache = {
            "res": res, "rev": rev, "n": len(scans),
            "last_uid": scans[-1].unique_id,
            "mins": mins, "maxs": maxs, "grid": grid,
        }
        return grid

    # -- services -----------------------------------------------------------
    def serialize(self, path: str) -> None:
        from slam_toolbox_tpu_torch.io.serialization import save_snapshot

        self.flush()
        save_snapshot(self.mapper, path)

    def deserialize(
        self,
        path: str,
        match_type: MatchType = MatchType.UNSET,
        initial_pose: Optional[np.ndarray] = None,
    ) -> None:
        """deserializePoseGraphCallback (slam_toolbox_common.cpp:1020-1079):
        load the snapshot into this session's mapper and continue from its
        last scan (UNSET), at node 0 (START_AT_FIRST_NODE), mapping near
        `initial_pose` (START_AT_GIVEN_POSE), or localizing in it from
        `initial_pose` (LOCALIZE_AT_POSE: the session turns to
        localization mode)."""
        from slam_toolbox_tpu_torch.io.serialization import load_snapshot

        self.flush()
        # the pipeline's device ring, pack pool and slots refer to the
        # pre-load session; a new one seeds from the loaded running scans
        self._pipe = None
        self._grid_cache = None  # new graph object: pose_revision resets
        load_snapshot(path, self.mapper)
        scans = self.mapper.all_processed_scans()
        if scans:
            self.laser = scans[0].laser
        self.mapper.solver.compute()
        # prebuild the incremental query structure here (one-time load
        # cost) rather than on the first relocalization query: at a large
        # prior its rebuild dominates the "where am I" latency
        if self.mapper.graph is not None:
            self.mapper.graph._query_structure()
        if match_type == MatchType.START_AT_FIRST_NODE:
            self.processor_type = ProcessType.PROCESS_FIRST_NODE
        elif match_type == MatchType.START_AT_GIVEN_POSE:
            self.processor_type = ProcessType.PROCESS_NEAR_REGION
            self.process_near_pose = np.asarray(initial_pose, np.float64)
        elif match_type == MatchType.LOCALIZE_AT_POSE:
            self.mode = "localization"
            self.processor_type = ProcessType.PROCESS_NEAR_REGION
            self.process_near_pose = np.asarray(initial_pose, np.float64)

    def toggle_mode(self, mode: str) -> None:
        """Runtime mapping<->localization switch (the map-and-localization
        node's toggle service, slam_toolbox_map_and_localization.cpp:82-115).
        Entering localization starts the elastic buffer from the next
        scan; returning to mapping folds the buffered scans into the
        permanent graph (they simply stop being evicted)."""
        if mode not in ("mapping", "localization"):
            raise ValueError(mode)
        if mode == self.mode:
            return
        self.flush()
        if mode == "mapping":
            # buffered scans become permanent graph nodes
            self.mapper.localization_buffer.clear()
        self.mode = mode
        self.processor_type = self._steady_processor()
        if self._pipe is not None:
            self._pipe.post_finish = (
                self._loc_post_finish if mode == "localization" else None
            )

    def set_initial_pose(self, pose) -> None:
        """/initialpose (localizePoseCallback,
        slam_toolbox_localization.cpp:240-270): the next scan is matched
        against the graph's nodes near `pose`."""
        self.process_near_pose = np.asarray(pose, np.float64)
        self.processor_type = ProcessType.PROCESS_NEAR_REGION
        self.first_measurement = True

    def clear_localization_buffer(self) -> None:
        """Remove every buffered localization scan from the graph and
        forget the running scans (clear_localization_buffer service)."""
        self.mapper.clear_localization_buffer()

    # -- pause domains (toolbox_types.hpp:77-117) ---------------------------
    @property
    def paused(self) -> bool:
        """Legacy single-flag view = the NEW_MEASUREMENTS domain."""
        return self.paused_state.get(PausedApplication.NEW_MEASUREMENTS)

    @paused.setter
    def paused(self, value: bool) -> None:
        self.paused_state.set(PausedApplication.NEW_MEASUREMENTS, value)

    def is_paused(self, app: PausedApplication) -> bool:
        return self.paused_state.get(app)

    def pause(self) -> bool:
        """pause_new_measurements service toggle
        (slam_toolbox_common.cpp:905-919)."""
        cur = self.paused_state.get(PausedApplication.NEW_MEASUREMENTS)
        self.paused_state.set(PausedApplication.NEW_MEASUREMENTS, not cur)
        return not cur

    def pause_processing(self, state: bool) -> None:
        """Stop the sync consumer while letting scans queue
        (slam_toolbox_sync.cpp:40; api/queue_modes.SyncQueue.pump)."""
        self.paused_state.set(PausedApplication.PROCESSING, state)

    def toggle_interactive_mode(self) -> bool:
        """ToggleInteractive: entering interactive mode pauses processing
        and graph visualization so nodes can be inspected and moved
        (modify_node, manual_loop_closure); leaving resumes both."""
        self.interactive_mode = not self.interactive_mode
        self.pause_processing(self.interactive_mode)
        self.paused_state.set(
            PausedApplication.VISUALIZING_GRAPH, self.interactive_mode
        )
        return self.interactive_mode

    # -- lifecycle / failure detection (utils/lifecycle.py) -----------------
    def _on_activate(self) -> None:
        """on_activate (slam_toolbox_common.cpp:143-172): resume
        processing and start the bond heartbeat if one was requested."""
        self.paused_state.set(PausedApplication.NEW_MEASUREMENTS, False)
        self.paused_state.set(PausedApplication.PROCESSING, False)
        if self._bond is not None:
            self._bond.start()

    def _on_deactivate(self) -> None:
        """on_deactivate (:174-197): pause ingestion and stop heartbeating
        (the manager sees the bond break and may restart us)."""
        self.paused_state.set(PausedApplication.NEW_MEASUREMENTS, True)
        self.paused_state.set(PausedApplication.PROCESSING, True)
        if self._bond is not None:
            self._bond.break_bond()

    def _on_shutdown(self) -> None:
        self.destroy_bond()
        # settle BEFORE stopping the watchdog: the terminal fetches are
        # what the watchdog exists to flag
        if self._pipe is not None:
            self._pipe.settle()
        if self._watchdog is not None:
            self._watchdog.stop()

    def configure(self):
        return self.lifecycle.configure()

    def activate(self):
        return self.lifecycle.activate()

    def deactivate(self):
        return self.lifecycle.deactivate()

    def cleanup(self):
        return self.lifecycle.cleanup()

    def shutdown(self):
        return self.lifecycle.shutdown()

    def create_bond(self, path: Optional[str] = None,
                    period: float = 0.10):
        """createBond (slam_toolbox_common.cpp:72-86): start a heartbeat
        an external manager can watch (in-process via the returned Bond,
        across processes via `path`). Idempotent."""
        from slam_toolbox_tpu_torch.utils.lifecycle import Bond

        if self._bond is None:
            self._bond = Bond("slam_session", period=period, path=path)
        elif (path, period) != (self._bond.path, self._bond.period):
            # a supervisor watching the NEW path would see silence forever
            raise ValueError(
                "create_bond called again with different parameters "
                f"(existing path={self._bond.path!r} period="
                f"{self._bond.period}); destroy_bond() first"
            )
        self._bond.start()
        return self._bond

    def destroy_bond(self) -> None:
        """destroyBond (:88-96)."""
        if self._bond is not None:
            self._bond.break_bond()
            self._bond = None

    def enable_watchdog(self, stall_s: float = 30.0, on_stall=None):
        """Flag device sections (the streaming drain's fetch) in flight
        longer than `stall_s`; it reports and never interrupts."""
        from slam_toolbox_tpu_torch.utils.lifecycle import Watchdog

        if self._watchdog is None:
            self._watchdog = Watchdog(stall_s=stall_s, on_stall=on_stall)
            self._watchdog.start()
            if self._pipe is not None:
                self._pipe.watchdog = self._watchdog
        elif stall_s != self._watchdog.stall_s:
            raise ValueError(
                "enable_watchdog called again with a different stall_s "
                f"(existing {self._watchdog.stall_s})"
            )
        return self._watchdog

    def health(self) -> dict:
        """One-call liveness summary for supervisors."""
        h = {
            "lifecycle": self.lifecycle.state.name,
            "bond_alive": bool(self._bond is not None and self._bond.alive),
            "scan_count": self.scan_count,
        }
        if self._watchdog is not None:
            h.update(self._watchdog.health())
        else:
            h["status"] = "ok"
        return h

    def warm_all(self) -> None:
        """Run every device path the session can take once, on dummy
        scans, so the first real scans pay no kernel build, graph capture
        or allocator growth. The matches, the fused verify and the
        near-chain matches run as programs, one per shape bucket
        (kernels/match.py, kernels/loop_verify.py; CUDA graphs on a
        card): this captures the buckets a session meets first, the
        sequential match at the base-point bucket of each running-buffer
        length up to the full buffer's, penalized, and at the full
        buffer's unpenalized, and the loop coarse match at the minimum
        chain length; for a streaming session first the pipeline's step
        graph (warm()), then the fused verify and the near-chain match at
        chain bucket 16 on its pack pool. Then the solver at 3 and 257
        nodes. Launches made here are not counted
        (match_cuda.uncounted)."""
        from slam_toolbox_tpu_torch.kernels import loop_verify as lv
        from slam_toolbox_tpu_torch.kernels import match_cuda as mc
        from slam_toolbox_tpu_torch.solver import PoseGraphSolver

        if self.laser is None:
            return
        if not self.mapper.initialized:
            self.mapper.initialize(self.laser.range_threshold)
        cfg = self.config
        ranges = np.full(self.laser.n_beams, 2.0)
        dummy = LocalizedScan(self.laser, ranges, np.zeros(3))
        n_base = max(int(cfg.scan_buffer_size),
                     int(cfg.loop_match_minimum_chain_size), 1)
        base = [LocalizedScan(self.laser, ranges, np.zeros(3))
                for _ in range(n_base)]
        seq = self.mapper.sequential_matcher
        loop = self.mapper.loop_matcher
        with mc.uncounted():
            # what the live pipeline needs soonest first (warm_async)
            if self.streaming:
                pipe = self._ensure_pipe()
                pipe.warm()
                lv.warm_programs(loop, seq, cfg, pipe.pack_pool)
            buckets = {}
            for n in range(1, int(cfg.scan_buffer_size) + 1):
                P = len(seq._base_points(base[:n], np.zeros(2))[0])
                buckets.setdefault(P, n)
            for n in buckets.values():
                seq.match_scan(dummy, base[:n], penalize=True, refine=True)
            seq.match_scans_batch(dummy, [base[:cfg.scan_buffer_size]],
                                  penalize=False)
            loop.match_scans_batch(
                dummy, [base[:cfg.loop_match_minimum_chain_size]],
                penalize=False, refine=False)
            for n_nodes in (3, 257):
                s = PoseGraphSolver(self.config.solver, device=self.device)
                for i in range(n_nodes):
                    s.add_node(i, [float(i), 0.0, 0.0])
                for i in range(n_nodes - 1):
                    s.add_constraint(i, i + 1, [1, 0, 0], np.eye(3) * 1e-3)
                s.compute()

    def warm_async(self) -> threading.Thread:
        """Run warm_all on a daemon thread, on the session's device, so
        warming overlaps live scan processing; returns the thread (one per
        session). Warming is best-effort: a failure there leaves the
        session to build and allocate at first use. The matchers are made
        here, before the thread starts, so the two threads never both
        initialize the mapper."""
        if self._warm_thread is None:
            if self.laser is not None and not self.mapper.initialized:
                self.mapper.initialize(self.laser.range_threshold)
            def work():
                import torch

                on_card = (torch.cuda.device(self.device)
                           if self.device.type == "cuda"
                           else contextlib.nullcontext())
                try:
                    with on_card:
                        self.warm_all()
                except Exception:
                    logging.getLogger(__name__).exception("warming failed")

            self._warm_thread = threading.Thread(
                target=work, name="slam-warm", daemon=True)
            self._warm_thread.start()
        return self._warm_thread

    def close(self) -> None:
        """Flushes, then returns what the session holds on its device now:
        the streaming pipeline (its pack pool, step graph and batch
        buffers), the matchers with their programs and the programs' graph
        pools, and the graph. The session's objects refer to one another
        (the lifecycle's hooks, the step graph's function, the graph's
        scans and edges), so a session that is only dropped keeps its
        device memory until the garbage collector's next full pass. The
        session is empty afterwards, as after cleanup(). The solver's loop
        programs (se2_solver.lm_loop) belong to the process, which shares
        them among its sessions, and stay."""
        if self._warm_thread is not None:
            self._warm_thread.join()
        self.flush()
        self.reset()
        gc.collect()

    def reset(self) -> None:
        self._pipe = None
        self._grid_cache = None
        self.mapper.reset()
        self.processor_type = self._steady_processor()
        self.scan_count = 0
        self.first_measurement = True
        self.map_to_odom = np.zeros(3)
        self.last_scan_odom = None
        self.last_scan_time = -np.inf

    # -- graph access -------------------------------------------------------
    def get_graph(self):
        """Nodes + edges for visualization; returns None while the
        VISUALIZING_GRAPH domain is paused (publishGraph's
        `!isPaused(VISUALIZING_GRAPH)` gate,
        slam_toolbox_common.cpp:524)."""
        if self.is_paused(PausedApplication.VISUALIZING_GRAPH):
            return None
        if self._pipe is not None:
            self._pipe.settle()
        return self.mapper.solver.get_graph()

    def localization_buffer_uids(self) -> set:
        """Unique ids of the elastic localization-buffer scans, the
        vertices the assistant renders in a distinct color
        (loop_closure_assistant.cpp:157-273); empty while mapping."""
        return {s.unique_id for s in self.mapper.localization_buffer}

    def modify_node(self, unique_id: int, pose) -> None:
        """Move one node in the solver (the assistant's interactive edit);
        the graph's scans keep their poses until the next solve."""
        if self._pipe is not None:
            self._pipe.settle()
        self.mapper.solver.modify_node(unique_id, pose)

    def manual_loop_closure(self, moved_nodes) -> None:
        """loop_closure_assistant.cpp:276-319: apply manual node moves
        [(unique_id, pose)], then re-optimize and write the poses back."""
        if self._pipe is not None:
            self._pipe.settle()
        for uid, pose in moved_nodes:
            self.mapper.solver.modify_node(uid, pose)
        self.mapper.graph.correct_poses()

    @property
    def trajectory(self) -> np.ndarray:
        self.flush()
        scans = self.mapper.all_processed_scans()
        if not scans:
            return np.zeros((0, 3))
        return np.stack([s.corrected_pose for s in scans])
