"""The drain as one program: the port's streaming step on static state
(slam_toolbox_tpu_torch/mapper/streaming.py _stream_step, _StepGraph) on
the CPU, against the JAX package's fori_loop program (_stream_batch_jit):

- a 16-scan batch from an empty ring, and a batch re-run after a
  refresh_state() in the middle of its drain, through the pipeline's own
  buffers: every state tensor keeps its storage (what a CUDA graph
  captured on them needs), the rows, head and count equal to JAX's;
- the result ring's rule in a session with refreshes and re-runs: at
  every fetch, a batch's rows are those of its last run;
- the replay tally of kernel launches (match_cuda.tallied, count_replay)
  and the step graph's replays.

test_torch_stream_graph_card.py holds the graphed batch to the eager loop
on a card.

Inputs are simulated scans of test_torch_streaming.py's ring workload
(0.05 m grid, 361 beams) and test_torch_spec_session.py's two laps."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_toolbox_tpu.mapper import Mapper as JaxMapper
from slam_toolbox_tpu.mapper import streaming as js
from slam_toolbox_tpu_torch.core.scan import LocalizedScan as TorchScan
from slam_toolbox_tpu_torch.kernels import match_cuda as mc
from slam_toolbox_tpu_torch.mapper import Mapper as TorchMapper
from slam_toolbox_tpu_torch.mapper import streaming as ts
from test_torch_slam import LAP, _workload
from test_torch_spec_session import (  # noqa: F401 (fixtures)
    _one_thread, loop_data, run_session,
)
from test_torch_streaming import _port

RING = 10     # scans committed before the batch
BATCH = 16


@pytest.fixture(scope="module")
def graph_case():
    """Both packages' sequential matchers, the port's mapper, and the ring
    workload's scans at their true poses in both packages' types."""
    cfg, laser, data = _workload(0.05, 1.0, LAP[:4], 0.6)
    tcfg, tlaser = _port(cfg, laser)
    jm = JaxMapper(cfg)
    jm.initialize(laser.range_threshold)
    jscans, tscans = [], []
    for scan, tp in data:
        scan.set_corrected_pose(tp)
        t = TorchScan(tlaser, scan.ranges, scan.odom_pose)
        t.set_corrected_pose(tp)
        jscans.append(scan)
        tscans.append(t)
    return dict(cfg=cfg, laser=laser, tcfg=tcfg, tlaser=tlaser,
                jm=jm.sequential_matcher, jscans=jscans, tscans=tscans)


def _pipeline(case, device="cpu"):
    mapper = TorchMapper(case["tcfg"], device=device)
    mapper.initialize(case["tlaser"].range_threshold)
    return ts.StreamingPipeline(mapper, case["tlaser"], drain_every=BATCH)


def _commit(pipe, scans):
    """The host's running buffer and last scan as bookkeeping leaves them."""
    sm = pipe.mapper.sensor_manager
    for s in scans:
        sm.add_scan(s)
        sm.add_running_scan(s)
        sm.set_last_scan(s)


def _jax_state(tstate):
    """The port's state (on the host) in the JAX program's layout."""
    pack = tstate["ring_pack"].cpu().numpy()
    flags = pack[:, :, 7].astype(np.int32)
    st = {
        "ring_local": pack[:, :, 0:2], "ring_anchor": pack[:, :, 2:4],
        "ring_current": pack[:, :, 4:6], "ring_dvalid": (flags & 2) > 0,
        "ring_next": pack[:, :, 6].astype(np.int32),
        "ring_finite": (flags & 1) > 0,
        "ring_pose": tstate["ring_pose"].cpu().numpy(),
        "ring_slot_valid": tstate["ring_slot_valid"].cpu().numpy(),
        "head": np.int32(tstate["head"]), "count": np.int32(tstate["count"]),
        "last_odom": tstate["last_odom"].cpu().numpy(),
        "last_corrected": tstate["last_corrected"].cpu().numpy(),
        "results": tstate["results"].cpu().numpy(),
        "n_results": np.int32(tstate["n_results"]),
    }
    return {k: jnp.asarray(v) for k, v in st.items()}


def _jax_batch(case, jstate, packs, odoms):
    jm, cfg = case["jm"], case["cfg"]
    kw = {k: v for k, v in jm._score_args.items()}
    kw["penalize"] = np.bool_(True)
    return js._stream_batch_jit(
        jstate, jnp.asarray(packs), jnp.asarray(odoms),
        jnp.int32(len(packs)),
        offset_pose=jnp.asarray(case["laser"].offset_pose, jnp.float32),
        scale=np.float32(jm.scale), sigma_cells=np.float32(jm.sigma_cells),
        half_span=np.float32(0.5 * (jm.G - 1) * jm.resolution),
        run_buffer_size=np.int32(cfg.scan_buffer_size),
        run_max_distance=np.float32(cfg.scan_buffer_maximum_scan_distance),
        score_args=kw, grid_size=jm.G, half_kernel=jm.half_kernel,
        acc_r=jm._acc_r, parity=False, na_coarse=jm._na_coarse,
        na_fine=jm._na_fine)


def _storage(state):
    return {k: v.data_ptr() for k, v in state.items()
            if isinstance(v, torch.Tensor)}


def _check_rows(tstate, jout, rows):
    np.testing.assert_allclose(tstate["results"][rows].numpy(),
                               np.asarray(jout["results"][rows]), atol=1e-5)
    assert int(tstate["head"]) == int(jout["head"])
    assert int(tstate["count"]) == int(jout["count"])
    assert tstate["n_results"] == int(jout["n_results"])
    assert int(tstate["ridx"]) == tstate["n_results"] % len(
        tstate["results"])


@pytest.mark.parametrize("case_kind", ["empty", "refresh"])
def test_static_state_batch_matches_jax(graph_case, case_kind):
    """A 16-scan batch through the pipeline's own state from an empty
    ring; and a batch after 10 committed scans that a closure-like move
    of the newest one (3 cm, 0.01 rad) forces to re-run from a refreshed
    state. Every state tensor keeps its storage through the refreshes
    and runs; each run's rows, head and count equal the JAX program's
    from the same state; the re-run writes after the first run's rows,
    which stay as they were."""
    case = graph_case
    pipe = _pipeline(case)
    first = 0 if case_kind == "empty" else RING
    if case_kind == "refresh":
        _commit(pipe, case["tscans"][:RING])
    pipe.refresh_state()
    state = pipe.state
    ptrs = _storage(state)
    scans = case["jscans"][first:first + BATCH]
    packs = np.stack([js.scan_pack(s) for s in scans])
    odoms = np.stack([s.odom_pose for s in scans]).astype(np.float32)

    jout = _jax_batch(case, _jax_state(state), packs, odoms)
    pipe._run_batch(state, torch.from_numpy(packs), torch.from_numpy(odoms))
    _check_rows(state, jout, slice(0, BATCH))
    assert _storage(state) == ptrs
    if case_kind == "empty":
        return

    newest = case["tscans"][RING - 1]
    newest.set_corrected_pose(newest.corrected_pose + [0.03, -0.02, 0.01])
    try:
        first_rows = state["results"][:BATCH].clone()
        pipe.refresh_state()
        assert pipe.state is state and _storage(state) == ptrs
        assert state["n_results"] == BATCH
        np.testing.assert_allclose(
            state["ring_pose"][RING - 1].numpy(),
            newest.sensor_pose.astype(np.float32))
        jout = _jax_batch(case, _jax_state(state), packs, odoms)
        pipe._run_batch(state, torch.from_numpy(packs),
                        torch.from_numpy(odoms))
    finally:
        newest.set_corrected_pose(newest.corrected_pose
                                  - [0.03, -0.02, 0.01])
    _check_rows(state, jout, slice(BATCH, 2 * BATCH))
    assert _storage(state) == ptrs
    assert torch.equal(state["results"][:BATCH], first_rows)
    # the closure moved the prior: the re-run's rows are its own
    assert not torch.equal(state["results"][BATCH:2 * BATCH], first_rows)


def test_result_ring_keeps_queued_rows(loop_data):
    """A pipelined session of two laps with refreshes and re-runs (drains
    of 16; with ADAPTIVE off every closure that moves the ring re-runs a
    batch in flight): at each fetch, the batch's rows in the fetched ring
    and in the live ring are exactly those of its last run, and no state
    tensor ever moved."""
    written, fetched, runs = {}, [], []
    ptrs, alive = {}, []   # alive: no batch's id is reused by another
    run_batch = ts.StreamingPipeline._run_batch
    fetch = ts.StreamingPipeline._fetch

    def recording_run(self, state, packs, odoms):
        r0 = int(state["ridx"])   # where the steps write, on the device
        out = run_batch(self, state, packs, odoms)
        ptrs.setdefault("first", _storage(state))
        assert _storage(state) == ptrs["first"]
        cap = state["results"].shape[0]
        assert int(state["ridx"]) == state["n_results"] % cap
        rows = [(r0 + i) % cap for i in range(packs.shape[0])]
        runs.append(id(packs))
        alive.append(packs)
        written[id(packs)] = state["results"][rows].clone()
        return out

    def checking_fetch(self, pd):
        res_np, spec_np = fetch(self, pd)
        if pd.packs is not None:
            cap = self.result_cap
            rows = [(pd.start + i) % cap for i in range(len(pd.scans))]
            ref = written[id(pd.packs)].numpy()
            np.testing.assert_array_equal(res_np[rows], ref)
            np.testing.assert_array_equal(pd.results[rows].numpy(), ref)
            fetched.append(id(pd.packs))
        return res_np, spec_np

    out = run_session(
        "torch", *loop_data, ADAPTIVE=False,
        patches=[(ts.StreamingPipeline, "_run_batch", recording_run),
                 (ts.StreamingPipeline, "_fetch", checking_fetch)])
    reruns = len(runs) - len(set(runs))
    assert out["counts"]["refresh_state"] >= 2
    assert reruns >= 1, "no batch was re-run after a refresh"
    assert len(fetched) == len(set(runs))
    assert out["closures"] >= 1
    assert out["counts"]["batch_steps"] == sum(
        len(written[k]) for k in runs)


@pytest.fixture
def launch_counts():
    saved = (dict(mc.LAUNCHES), dict(mc.GRID_LAUNCHES))
    mc.reset_launch_counts()
    yield
    mc.reset_launch_counts()
    mc.LAUNCHES.update(saved[0])
    mc.GRID_LAUNCHES.update(saved[1])


def test_replay_tally_counts_each_replay(launch_counts, monkeypatch):
    """Launches recorded under capture go to the tally of tallied() and
    nowhere else; count_replay adds a tally once per replay, by kernel
    and by grid; uncounted() suppresses replays as it does launches."""
    capturing = [True]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    mc._count("score_windows", 2051)    # captured outside tallied()
    with mc.tallied() as tally:
        for name in ("scatter_occupancy", "smear_quantize",
                     "score_windows"):
            mc._count(name, 2051)
        mc._count("score_windows", 561)
    capturing[0] = False
    assert not any(mc.LAUNCHES.values()) and not mc.GRID_LAUNCHES
    assert tally == {("scatter_occupancy", 2051): 1,
                     ("smear_quantize", 2051): 1,
                     ("score_windows", 2051): 1, ("score_windows", 561): 1}
    mc.count_replay(tally, 3)
    assert mc.LAUNCHES == {"scatter_occupancy": 3, "smear_quantize": 3,
                           "score_windows": 6, "score_ceiling": 0,
                           "ring_points": 0, "score_tail": 0,
                           "stream_update": 0, "chain_thomas": 0,
                           "device_loop": 0}
    assert mc.GRID_LAUNCHES[("score_windows", 561)] == 3
    with mc.uncounted():
        mc.count_replay(tally, 5)
    assert mc.LAUNCHES["score_windows"] == 6
    mc._count("score_windows", 2051)    # an eager launch
    assert mc.GRID_LAUNCHES[("score_windows", 2051)] == 4


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.mark.parametrize("n", [1, 13, 256])
def test_step_graph_replays_and_counts(launch_counts, n):
    """A batch of n scans replays the step graph n times and counts each
    replay's launches."""
    g = object.__new__(ts._StepGraph)
    g.graph = _FakeGraph()
    g.tally = {("score_windows", 2051): 1, ("smear_quantize", 2051): 1}
    g.run(n)
    assert g.graph.replays == n
    assert mc.LAUNCHES["score_windows"] == mc.LAUNCHES["smear_quantize"] == n
    assert mc.GRID_LAUNCHES[("score_windows", 2051)] == n
