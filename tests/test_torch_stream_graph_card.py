"""The drain's step graph (slam_toolbox_tpu_torch/mapper/streaming.py
_StepGraph) on a card, marked `cuda` and skipped without one: a batch
replayed from the graph equals the eager loop bit for bit and counts the
same launches, a step that cannot be captured raises, and warm_async's
thread captures beside a session's first scans, and a closed session
returns its device memory. The file
imports no JAX, so the card's machine, which has none, runs it with
`python -m pytest --noconftest tests/test_torch_stream_graph_card.py`."""
import numpy as np
import pytest
import torch

from slam_toolbox_tpu_torch.api import SlamSession
from slam_toolbox_tpu_torch.core.params import MapperConfig
from slam_toolbox_tpu_torch.core.scan import LaserConfig, LocalizedScan
from slam_toolbox_tpu_torch.io.dataset import LidarSimulator, SegmentWorld
from slam_toolbox_tpu_torch.kernels import match_cuda as mc
from slam_toolbox_tpu_torch.mapper import Mapper
from slam_toolbox_tpu_torch.mapper import streaming as ts

# bench.py's world and settings at a 0.05 m grid and 361 beams
LAP = [(-6.0, -3.5), (1.5, -3.5), (5.5, -3.5), (5.5, 0.5), (5.5, 3.5)]
RING, BATCH = 10, 16


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _workload():
    laser = LaserConfig(min_range=0.05, max_range=12.0,
                        range_threshold=10.0,
                        angular_resolution=np.deg2rad(1.0))
    sim = LidarSimulator(SegmentWorld.rooms(16.0, 10.0), laser,
                         range_noise=0.01, odom_noise=(0.015, 0.006),
                         seed=42)
    data = sim.simulate(np.array(LAP), step=0.6)
    cfg = MapperConfig(
        minimum_travel_distance=0.2, minimum_time_interval=3600.0,
        scan_buffer_size=10, correlation_search_space_dimension=0.5,
        correlation_search_space_resolution=0.05,
        correlation_search_space_smear_deviation=0.1,
        distance_variance_penalty=0.5, angle_variance_penalty=1.0)
    return cfg, laser, data


@pytest.fixture
def pipeline(cuda_device):
    """A pipeline on the card whose host has committed 10 scans at their
    true poses, its state refreshed from them, and the next 16 scans."""
    cfg, laser, data = _workload()
    mapper = Mapper(cfg, device=cuda_device)
    mapper.initialize(laser.range_threshold)
    pipe = ts.StreamingPipeline(mapper, laser, drain_every=BATCH)
    scans = []
    for scan, tp in data[:RING + BATCH]:
        s = LocalizedScan(laser, scan.ranges, scan.odom_pose)
        s.set_corrected_pose(tp)
        scans.append(s)
    sm = mapper.sensor_manager
    for s in scans[:RING]:
        sm.add_scan(s)
        sm.add_running_scan(s)
        sm.set_last_scan(s)
    pipe.refresh_state()
    batch = scans[RING:]
    packs = torch.from_numpy(np.stack([ts.scan_pack(s) for s in batch]))
    odoms = torch.from_numpy(
        np.stack([s.odom_pose for s in batch]).astype(np.float32))
    return pipe, packs.to(cuda_device), odoms.to(cuda_device)


@pytest.mark.cuda
def test_graphed_batch_is_bit_equal_on_card(pipeline):
    """The batch replayed from the step graph and the eager loop from a
    clone of the same state: every state tensor equal bit for bit, the
    same launches (the graph's by its tally), one of each path kernel per
    scan; the state's tensors keep their storage."""
    pipe, packs, odoms = pipeline
    state = pipe.state
    eager = {k: v.clone() if isinstance(v, torch.Tensor) else v
             for k, v in state.items()}
    ptrs = {k: v.data_ptr() for k, v in state.items()
            if isinstance(v, torch.Tensor)}
    mc.reset_launch_counts()
    pipe._run_batch(state, packs, odoms)
    graphed = dict(mc.LAUNCHES)
    mc.reset_launch_counts()
    pipe._run_eager(eager, packs, odoms)
    assert dict(mc.LAUNCHES) == graphed
    assert graphed["score_windows"] == graphed["smear_quantize"] == BATCH
    for k, v in state.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, eager[k]), k
            assert v.data_ptr() == ptrs[k], k
        else:
            assert v == eager[k], k
    assert state["n_results"] == BATCH and int(state["ridx"]) == BATCH


@pytest.mark.cuda
def test_failed_capture_raises(pipeline, monkeypatch):
    """A step that reads the device from the host cannot be captured:
    the batch raises and nothing runs it eagerly instead."""
    pipe, packs, odoms = pipeline
    step = ts._stream_step

    def syncing_step(state, *args):
        int(state["step"])
        return step(state, *args)

    monkeypatch.setattr(ts, "_stream_step", syncing_step)
    n0 = pipe.state["n_results"]
    with pytest.raises(RuntimeError):
        pipe._run_batch(pipe.state, packs, odoms)
    assert pipe._graph is None and pipe.state["n_results"] == n0


@pytest.mark.cuda
def test_warm_async_captures_beside_the_first_scans(cuda_device, caplog):
    """warm_async's thread captures the step graph while the session's
    thread maps its first scans (drains of 8): the thread ends without a
    fault, one graph serves the drains, and the poses are a cold
    session's bit for bit."""
    cfg, laser, data = _workload()

    def session():
        return SlamSession(cfg, laser, device=cuda_device, streaming=True,
                           drain_every=8)

    warm, cold = session(), session()
    t = warm.warm_async()
    for sess in (warm, cold):
        for i, (scan, _) in enumerate(data):
            sess.process_scan(scan.ranges, scan.odom_pose, time=i * 0.1)
        sess.flush()
    t.join(timeout=120)
    assert not t.is_alive()
    assert not [r for r in caplog.records if "warming failed" in r.message]
    assert warm._pipe._graph is not None
    assert warm._pipe._graph.valid_for(warm._pipe.state)
    np.testing.assert_array_equal(warm.trajectory, cold.trajectory)


def _graph_pool_bytes():
    """Device memory in the segments of CUDA graphs' private pools."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


@pytest.mark.cuda
def test_closed_session_returns_its_device_memory(cuda_device):
    """SlamSession.close() returns what the session held on the card: two
    sessions, each mapped and closed in turn, leave the allocated memory
    and the graphs' pools where the first left them (the solver's loop
    programs, which the process keeps for its sessions), and each held
    more before close()."""
    cfg, laser, data = _workload()
    left = []
    for _ in range(2):
        sess = SlamSession(cfg, laser, device=cuda_device, streaming=True,
                           drain_every=8)
        for i, (scan, _) in enumerate(data):
            sess.process_scan(scan.ranges, scan.odom_pose, time=i * 0.1)
        sess.flush()
        assert sess._pipe._graph is not None
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(cuda_device)
        sess.close()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        left.append((torch.cuda.memory_allocated(cuda_device),
                     _graph_pool_bytes()))
        assert left[-1][0] < held
    assert left[1] == left[0]
