"""The Mapper orchestrator: the five Process* entry points, movement gating,
localization buffer, and node removal.

Re-expression of karto::Mapper (Mapper.h:1941-2486,
Mapper.cpp:2603-3141): Process / ProcessAtDock / ProcessAgainstNode /
ProcessAgainstNodesNearBy / ProcessLocalization.

Copy of slam_toolbox_tpu/mapper/mapper.py for the PyTorch port: the
matchers and the dense solver run on the mapper's `device` (default
"cuda"); node removal marginalizes onto the neighbors where the config
asks for it (graph/marginal.py).
"""
from __future__ import annotations

from collections import deque
from typing import Callable, List, Optional

import numpy as np

from slam_toolbox_tpu_torch.core import geometry
from slam_toolbox_tpu_torch.core.params import MapperConfig
from slam_toolbox_tpu_torch.device import resolve_device
from slam_toolbox_tpu_torch.graph.pose_graph import PoseGraph
from slam_toolbox_tpu_torch.kernels.match import Matcher
from slam_toolbox_tpu_torch.mapper.scan_manager import MapperSensorManager
from slam_toolbox_tpu_torch.solver import PoseGraphSolver


class MapperListener:
    """Event listener base (MapperListener / MapperDebugListener /
    MapperLoopClosureListener, Mapper.h:48-105). Subclass and override
    any of the five hooks; attach via Mapper.add_listener. Message
    strings follow the reference's wording (Mapper.cpp:1505-1561) so
    drivers watching for "Closing loop..." / "Loop closed!" keep
    working."""

    def info(self, msg: str) -> None:
        pass

    def debug(self, msg: str) -> None:
        pass

    def loop_closure_check(self, msg: str) -> None:
        pass

    def begin_loop_closure(self, msg: str) -> None:
        pass

    def end_loop_closure(self, msg: str) -> None:
        pass


class Mapper:
    def __init__(self, config: Optional[MapperConfig] = None, solver=None,
                 device=None):
        self.config = config or MapperConfig()
        self.device = resolve_device(device)
        self.solver = (
            solver
            if solver is not None
            else PoseGraphSolver(self.config.solver, device=self.device)
        )
        self.sensor_manager: Optional[MapperSensorManager] = None
        self.graph: Optional[PoseGraph] = None
        self.sequential_matcher: Optional[Matcher] = None
        self.loop_matcher: Optional[Matcher] = None
        self.initialized = False
        self.range_threshold: Optional[float] = None
        self.localization_buffer = deque()  # (scan,) LSV queue
        self.listeners: List[Callable[[str], None]] = []
        self.event_listeners: List[MapperListener] = []
        # lifelong vertex scores (Vertex::m_Score, Mapper.h:303-315);
        # persisted with the snapshot so decay state survives sessions
        self.vertex_scores = {}
        # the streaming pipeline's device pack pool (mapper/streaming.py);
        # while one is set, loop closure runs the fused verify
        self._pack_pool = None
        from slam_toolbox_tpu_torch.utils.metrics import Stats

        self.stats = Stats(enabled=False)

    # -- lifecycle (Mapper.cpp:2603-2672) -----------------------------------
    def initialize(self, range_threshold: float) -> None:
        if self.initialized:
            return
        cfg = self.config
        self.range_threshold = float(range_threshold)
        self.sequential_matcher = Matcher(
            cfg.correlation_search_space_dimension,
            cfg.correlation_search_space_resolution,
            cfg.correlation_search_space_smear_deviation,
            range_threshold,
            cfg.coarse_search_angle_offset,
            cfg.coarse_angle_resolution,
            cfg.fine_search_angle_offset,
            cfg.distance_variance_penalty,
            cfg.angle_variance_penalty,
            cfg.minimum_distance_penalty,
            cfg.minimum_angle_penalty,
            cfg.use_response_expansion,
            device=self.device,
        )
        self.loop_matcher = Matcher(
            cfg.loop_search_space_dimension,
            cfg.loop_search_space_resolution,
            cfg.loop_search_space_smear_deviation,
            range_threshold,
            cfg.coarse_search_angle_offset,
            cfg.coarse_angle_resolution,
            cfg.fine_search_angle_offset,
            cfg.distance_variance_penalty,
            cfg.angle_variance_penalty,
            cfg.minimum_distance_penalty,
            cfg.minimum_angle_penalty,
            cfg.use_response_expansion,
            device=self.device,
        )
        if self.sensor_manager is None:
            self.sensor_manager = MapperSensorManager(
                cfg.scan_buffer_size, cfg.scan_buffer_maximum_scan_distance
            )
        if self.graph is None:
            self.graph = PoseGraph(self)
        self.initialized = True

    def reset(self) -> None:
        self.sensor_manager = None
        self.graph = None
        self.sequential_matcher = None
        self.loop_matcher = None
        self.initialized = False
        self._pack_pool = None
        self.localization_buffer.clear()
        if self.solver is not None:
            self.solver.reset()

    # -- events (FireInfo/FireDebug/FireLoopClosureCheck/FireBegin/
    #    FireEndLoopClosure, Mapper.cpp:3180-3234). `listeners` keeps the
    #    original plain-callable surface (called with begin-loop-closure
    #    messages); `event_listeners` get the full typed stream.
    def add_listener(self, listener: MapperListener) -> None:
        self.event_listeners.append(listener)

    def remove_listener(self, listener: MapperListener) -> None:
        try:
            self.event_listeners.remove(listener)
        except ValueError:
            pass

    def fire_info(self, msg: str) -> None:
        for ls in self.event_listeners:
            ls.info(msg)

    def fire_debug(self, msg: str) -> None:
        for ls in self.event_listeners:
            ls.debug(msg)

    def fire_loop_closure_check(self, msg: str) -> None:
        for ls in self.event_listeners:
            ls.loop_closure_check(msg)

    def fire_loop_closure(self, msg: str) -> None:
        """Begin-loop-closure event (legacy name kept for callers)."""
        for cb in self.listeners:
            cb(msg)
        for ls in self.event_listeners:
            ls.begin_loop_closure(msg)

    def fire_end_loop_closure(self, msg: str) -> None:
        for ls in self.event_listeners:
            ls.end_loop_closure(msg)

    # -- gating (HasMovedEnough, Mapper.cpp:3110-3141) ----------------------
    def has_moved_enough(self, scan, last_scan) -> bool:
        if last_scan is None:
            return True
        cfg = self.config
        if scan.time - last_scan.time >= cfg.minimum_time_interval:
            return True
        last_pose = last_scan.sensor_at(last_scan.odom_pose)
        pose = scan.sensor_at(scan.odom_pose)
        dh = np.arctan2(
            np.sin(pose[2] - last_pose[2]), np.cos(pose[2] - last_pose[2])
        )
        if abs(dh) >= cfg.minimum_travel_heading:
            return True
        d = pose[:2] - last_pose[:2]
        if d[0] * d[0] + d[1] * d[1] >= cfg.minimum_travel_distance**2 - 1e-6:
            return True
        return False

    # -- the main pipeline (Process, Mapper.cpp:2679-2749) ------------------
    def process(self, scan, covariance_out=None) -> bool:
        if scan is None:
            return False
        if not scan.laser.validate(scan.ranges):
            return False
        if not self.initialized:
            self.initialize(scan.laser.range_threshold)

        sm = self.sensor_manager
        last = sm.get_last_scan(scan.laser.name)

        # propagate the last correction through the odometry delta
        if last is not None:
            scan.set_corrected_pose(
                np.asarray(
                    geometry.transform_pose_between(
                        last.odom_pose, last.corrected_pose, scan.odom_pose
                    )
                )
            )

        if not self.has_moved_enough(scan, last):
            return False

        from slam_toolbox_tpu_torch.utils.metrics import stage_timer

        cov = np.eye(3)
        if self.config.use_scan_matching and last is not None:
            with stage_timer(self.stats, "sequential_match"):
                res = self.sequential_matcher.match_scan(
                    scan, sm.get_running_scans(scan.laser.name)
                )
            scan.set_sensor_pose(res.sensor_pose)
            cov = res.covariance
        if covariance_out is not None:
            covariance_out[:] = cov

        self.finish_scan(scan, cov)
        return True

    def finish_scan(self, scan, cov, try_loops: bool = True) -> bool:
        """Post-match bookkeeping shared with the streaming pipeline:
        register the scan, grow the graph, update the running buffer, and
        attempt loop closure (the tail of Process, Mapper.cpp:2724-2743).
        Returns True if a loop closure fired (poses moved globally).
        try_loops=False defers loop-closure attempts (the streaming drain
        checks once per batch — candidate chains persist across
        consecutive scans, so closures still fire, a few scans later)."""
        from slam_toolbox_tpu_torch.utils.metrics import stage_timer

        sm = self.sensor_manager
        closed = False
        sm.add_scan(scan)
        if self.config.use_scan_matching:
            with stage_timer(self.stats, "graph_edges"):
                self.graph.add_vertex(scan)
                self.graph.add_edges(scan, cov)
            sm.add_running_scan(scan)
            if self.config.do_loop_closing and try_loops:
                with stage_timer(self.stats, "loop_closure"):
                    for name in sm.sensor_names():
                        if self.graph.try_close_loop(scan, name):
                            closed = True
        sm.set_last_scan(scan)
        return closed

    # -- resume / relocalize entry points -----------------------------------
    def process_against_node(
        self, scan, node_state_id: int, covariance_out=None
    ) -> bool:
        """ProcessAgainstNode (Mapper.cpp:3023-3096): seed last/running
        scans from a chosen node (continue-session / dock)."""
        if scan is None or not scan.laser.validate(scan.ranges):
            return False
        if not self.initialized:
            self.initialize(scan.laser.range_threshold)
        sm = self.sensor_manager
        last = sm.get_scan(scan.laser.name, node_state_id)
        sm.clear_running_scans(scan.laser.name)
        if last is not None:
            sm.add_running_scan(last)
            sm.set_last_scan(last)

        cov = np.eye(3)
        if self.config.use_scan_matching and last is not None:
            res = self.sequential_matcher.match_scan(
                scan, sm.get_running_scans(scan.laser.name)
            )
            scan.set_sensor_pose(res.sensor_pose)
            cov = res.covariance
        scan.odom_pose = np.array(scan.corrected_pose)
        if covariance_out is not None:
            covariance_out[:] = cov

        sm.add_scan(scan)
        if self.config.use_scan_matching:
            self.graph.add_vertex(scan)
            self.graph.add_edges(scan, cov)
            sm.add_running_scan(scan)
            if self.config.do_loop_closing:
                for name in sm.sensor_names():
                    self.graph.try_close_loop(scan, name)
        sm.set_last_scan(scan)
        return True

    def process_at_dock(self, scan, covariance_out=None) -> bool:
        """ProcessAtDock (Mapper.cpp:3098-3102): node 0."""
        return self.process_against_node(scan, 0, covariance_out)

    def process_against_nodes_near_by(
        self, scan, add_to_buffer: bool = False, covariance_out=None
    ) -> bool:
        """ProcessAgainstNodesNearBy (Mapper.cpp:2751-2829): seed from the
        nearest graph vertex (relocalization)."""
        if scan is None or not scan.laser.validate(scan.ranges):
            return False
        if not self.initialized:
            self.initialize(scan.laser.range_threshold)
        sm = self.sensor_manager

        closest = self.graph.find_nearby_scan(
            scan.laser.name, scan.odom_pose
        )
        last = None
        if closest is not None:
            last = sm.get_scan(scan.laser.name, closest.state_id)
            sm.clear_running_scans(scan.laser.name)
            sm.add_running_scan(last)
            sm.set_last_scan(last)

        cov = np.eye(3)
        if self.config.use_scan_matching and last is not None:
            res = self.sequential_matcher.match_scan(
                scan, sm.get_running_scans(scan.laser.name)
            )
            scan.set_sensor_pose(res.sensor_pose)
            cov = res.covariance
        scan.odom_pose = np.array(scan.corrected_pose)
        if covariance_out is not None:
            covariance_out[:] = cov

        sm.add_scan(scan)
        if self.config.use_scan_matching:
            self.graph.add_vertex(scan)
            self.graph.add_edges(scan, cov)
            sm.add_running_scan(scan)
            if self.config.do_loop_closing:
                for name in sm.sensor_names():
                    self.graph.try_close_loop(scan, name)
        sm.set_last_scan(scan)
        if add_to_buffer:
            self.add_scan_to_localization_buffer(scan)
        return True

    def process_localization(self, scan, covariance_out=None) -> bool:
        """ProcessLocalization (Mapper.cpp:2831-2909): normal pipeline plus
        the rolling elastic buffer."""
        ok = self.process(scan, covariance_out)
        if ok:
            self.add_scan_to_localization_buffer(scan)
        return ok

    # -- localization buffer (Mapper.cpp:2911-2962) -------------------------
    def add_scan_to_localization_buffer(self, scan) -> None:
        self.localization_buffer.append(scan)
        if len(self.localization_buffer) > self.config.scan_buffer_size:
            old = self.localization_buffer.popleft()
            self.remove_node_from_graph(old)

    def clear_localization_buffer(self) -> None:
        while self.localization_buffer:
            old = self.localization_buffer.popleft()
            self.remove_node_from_graph(old)
        for name in self.sensor_manager.sensor_names():
            self.sensor_manager.clear_running_scans(name)
            self.sensor_manager.clear_last_scan(name)

    def remove_node_from_graph(self, scan, marginalize=None) -> bool:
        """RemoveNodeFromGraph (Mapper.cpp:2964-3021). The reference
        deletes the node's constraints outright; with
        `marginalize_on_removal` (config, or the explicit argument) the
        constraints are first Schur-composed onto the node's neighbors
        (graph/marginal.py) so bounding the graph keeps the information
        that anchored old geometry."""
        if marginalize is None:
            marginalize = getattr(
                self.config, "marginalize_on_removal", False
            )
        if marginalize:
            from slam_toolbox_tpu_torch.graph.marginal import (
                marginalize_and_remove,
            )

            ok = marginalize_and_remove(self.graph, scan)
        else:
            ok = self.graph.remove_vertex(scan)
        self.sensor_manager.remove_scan(scan)
        if self._pack_pool is not None:
            self._pack_pool.release(scan)
        return ok

    # -- accessors ----------------------------------------------------------
    def all_processed_scans(self):
        if self.sensor_manager is None:
            return []
        return self.sensor_manager.get_all_scans()
