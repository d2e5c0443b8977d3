"""workloads_torch.py's builders against the scripts they copy, and
configs_torch.py's commands at a cut, on the CPU.

bench_workload is held to bench.make_workload(), and the config 2-4
builders to scripts/bench_suite.py's: the worlds' segments, the
waypoints, the simulators' seeds and noise, the MapperConfig and
LaserConfig field by field, the first 20 simulated scans bit for bit,
the config-4 prior snapshot at 450 nodes (the JAX package's file loaded
with the port's load_snapshot, saved again, equal to the port's in every
array), and the tiled circuit. bench_suite inlines its waypoint lists
and simulators in its commands, so the JAX side runs the command itself
with LidarSimulator.simulate (and, for config 4, the prior's build and
the cache's existence test) patched to record what they were given."""
import copy
import dataclasses
import json
import math
import os
import types

import numpy as np
import pytest
import torch

import bench
import configs_torch
import workloads_torch as wl
from scripts import bench_suite as bs
from slam_toolbox_tpu import api as jax_api
from slam_toolbox_tpu.io import dataset as jds
from slam_toolbox_tpu_torch.io import dataset as tds
from slam_toolbox_tpu_torch.io.serialization import (
    load_snapshot, save_snapshot,
)

torch.set_num_threads(1)
N_SCANS = 20


class Captured(Exception):
    """What a patched simulate was given: the simulator, its generator's
    state before any draw, the waypoints and the step; `data` the scans
    of the first segment where it simulated them."""

    def __init__(self, sim, waypoints, step):
        super().__init__("captured")
        self.sim, self.step = sim, step
        self.waypoints = np.asarray(waypoints)
        self.state = (None if sim is None
                      else copy.deepcopy(sim.rng.bit_generator.state))
        self.data = None


def capture(monkeypatch, cls, then_raise=True):
    """Patch cls.simulate to record what it is given. It raises Captured,
    or (then_raise False) records it in the returned list and simulates
    only the first segment: the noise is drawn scan by scan, so those
    scans equal the whole run's first ones."""
    seen = []
    orig = cls.simulate

    def simulate(self, waypoints, step=0.25, dt=0.1):
        cap = Captured(self, waypoints, step)
        if then_raise:
            raise cap
        seen.append(cap)
        cap.data = orig(self, cap.waypoints[:2], step, dt)
        return cap.data

    monkeypatch.setattr(cls, "simulate", simulate)
    return seen


def stop_sessions(monkeypatch):
    """Patch the JAX package's SlamSession to record its configuration,
    laser and keywords, then raise Captured (the command stops there)."""
    made = []

    class Session:
        def __init__(self, cfg, laser, **kw):
            made.append((cfg, laser, kw))
            raise Captured(None, [], 0.0)

    monkeypatch.setattr(jax_api, "SlamSession", Session)
    return made


def simulate_head(cap, orig, n=N_SCANS):
    """The first n scans of the captured simulator's run, by `orig` (an
    unpatched simulate) from a simulator that has not drawn yet."""
    return orig(cap.sim, cap.waypoints[:2], cap.step)[:n]


def same_laser(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def same_cfg(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def same_sim(a, b):
    """Two captured simulators: the world, the noise and the generator's
    state (its seed, before any draw)."""
    np.testing.assert_array_equal(a.sim.world.segments,
                                  b.sim.world.segments)
    assert a.sim.range_noise == b.sim.range_noise
    assert tuple(a.sim.odom_noise) == tuple(b.sim.odom_noise)
    assert a.state == b.state
    same_laser(a.sim.laser, b.sim.laser)
    np.testing.assert_array_equal(a.waypoints, b.waypoints)
    assert a.step == b.step


def same_scans(a, b):
    assert len(a) == len(b)
    for (sa, ta), (sb, tb) in zip(a, b):
        np.testing.assert_array_equal(np.asarray(sa.ranges),
                                      np.asarray(sb.ranges))
        np.testing.assert_array_equal(np.asarray(sa.odom_pose),
                                      np.asarray(sb.odom_pose))
        np.testing.assert_array_equal(np.asarray(ta), np.asarray(tb))


def suite_args(**kw):
    base = dict(full=False, laps=4, drain=96, beam_res=1.0 / 3, sessions=3,
                loc_repeat=1, prior_nodes=0, budget=600.0)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_bench_workload_matches_make_workload(monkeypatch):
    monkeypatch.setenv("BENCH_LAPS", "2")
    jcfg, jlaser, jdata = bench.make_workload()
    cfg, laser, data = wl.bench_workload(2)
    same_cfg(cfg, jcfg)
    same_laser(laser, jlaser)
    same_scans(data, jdata)


def test_apartment_workload_matches_config2(monkeypatch):
    """Config 2 as cmd_config2 --full builds it: the apartment, 40 closed
    laps, the simulator, the session's MapperConfig and laser."""
    jseen = capture(monkeypatch, jds.LidarSimulator, then_raise=False)
    sessions = stop_sessions(monkeypatch)
    with pytest.raises(Captured):
        bs.cmd_config2(suite_args(full=True))
    tseen = capture(monkeypatch, tds.LidarSimulator, then_raise=False)
    cfg, laser, data = wl.apartment_workload()
    (j,), (t,), ((jcfg, jlaser, kw),) = jseen, tseen, sessions
    same_sim(t, j)
    assert len(j.waypoints) == 10 * wl.APARTMENT_LAPS
    assert len(jds.trajectory_from_waypoints(j.waypoints, j.step)) == 5080
    assert kw == dict(streaming=True, drain_every=96)
    same_cfg(cfg, jcfg)
    same_laser(laser, jlaser)
    same_scans(data[:N_SCANS], j.data[:N_SCANS])


@pytest.mark.parametrize("marginalize", [True, False])
def test_warehouse_workload_matches_config3(monkeypatch, marginalize):
    """Config 3 as cmd_config3 --laps 40 builds it (CONFIG3.json's 19,241
    raw scans): the serpentine, the simulator, and each variant's
    MapperConfig (SLAM_MARGINALIZE) and laser."""
    jseen = capture(monkeypatch, jds.LidarSimulator, then_raise=False)
    sessions = stop_sessions(monkeypatch)
    monkeypatch.setenv("SLAM_MARGINALIZE", "1" if marginalize else "0")
    with pytest.raises(Captured):
        bs.cmd_config3(suite_args(laps=wl.WAREHOUSE_LAPS))
    tseen = capture(monkeypatch, tds.LidarSimulator, then_raise=False)
    laser, data = wl.warehouse_workload()
    (j,), (t,), ((jcfg, jlaser, kw),) = jseen, tseen, sessions
    same_sim(t, j)
    assert len(jds.trajectory_from_waypoints(j.waypoints, j.step)) == 19241
    assert kw == dict(streaming=True, drain_every=96)
    same_cfg(wl.lifelong_cfg(marginalize), jcfg)
    same_laser(laser, jlaser)
    same_scans(data[:N_SCANS], j.data[:N_SCANS])


def test_prior_snapshot_matches_config4(tmp_path):
    """build_prior_snapshot at 450 nodes (three rows): the JAX package's
    snapshot, loaded with the port's load_snapshot and saved again, equal
    in every array (poses, ranges, edges) and the meta to the port's (its
    rows raycast in threads)."""
    laser = wl.suite_laser()
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    jworld = bs.build_prior_snapshot(jpath, 450, bs._laser())
    tworld, _, _ = wl.build_prior_snapshot(tpath, 450, laser)
    np.testing.assert_array_equal(tworld.segments, jworld.segments)
    np.testing.assert_array_equal(wl.prior_world(450).segments,
                                  jworld.segments)
    again = str(tmp_path / "again.npz")
    save_snapshot(load_snapshot(jpath, device="cpu"), again)
    with np.load(again) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    m = load_snapshot(tpath, device="cpu")
    assert m.solver.n_nodes == 450
    # 449 chain edges and a cross-row edge every 8th node of rows 1-2,
    # less row 2's first, which is its chain edge (row 1 ends above it)
    assert m.solver.n_edges == 449 + 25 + 7 - 1


def test_closed_session_lets_its_device_state_go():
    """SlamSession.close() after a streaming run (config 2's apartment at
    a cut): the pipeline, its pack pool, the matchers, their programs and
    the graph's scans are freed by close() itself, with the garbage
    collector off outside it (the session's objects refer to one another,
    so a session that is only dropped kept them, and on a card their
    memory, until the collector's next full pass)."""
    import gc
    import weakref

    from slam_toolbox_tpu_torch.api import SlamSession

    cfg, laser, data = wl.apartment_workload(1, 1.0)
    cfg = dataclasses.replace(cfg, correlation_search_space_resolution=0.05)
    sess = SlamSession(cfg, laser, streaming=True, drain_every=96,
                       device="cpu")
    for i, (scan, _) in enumerate(data[:130]):
        sess.process_scan(scan.ranges, scan.odom_pose, time=i * 0.1)
    sess.flush()
    m = sess.mapper
    held = [sess._pipe, sess._pipe.pack_pool, m.sequential_matcher,
            m.loop_matcher, m.graph, m.all_processed_scans()[0],
            *m.sequential_matcher._programs.values(),
            *m.loop_matcher._programs.values()]
    assert len(held) > 6 and sess.mapper.solver.n_nodes > 0
    refs = [weakref.ref(o) for o in held]
    del held, m
    gc.disable()
    try:
        sess.close()
        assert [r() for r in refs] == [None] * len(refs)
    finally:
        gc.enable()
    assert sess._pipe is None and sess.mapper.solver.n_nodes == 0


def test_keep_freed_memory_applies_in_its_own_process():
    """keep_freed_memory sets glibc's two thresholds (in a process of its
    own: the setting lasts for the process)."""
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-c", "import workloads_torch as wl; "
         "print(wl.keep_freed_memory())"],
        capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "True"


def test_localization_circuit_matches_config4(monkeypatch):
    """Config 4's circuit in the 100,010-node prior's world (cmd_config4
    with --prior-nodes 100010, its prior taken as cached): the waypoints,
    the simulator, the first 20 scans (both simulators cut to the first
    20 poses of their trajectory: the JAX one casts against all 14,361
    segments), the tiling against _repeat_circuit across the seam, and
    the localization settings against cmd_config4's _loc_cfg."""
    monkeypatch.setattr(bs.os.path, "exists",
                        lambda p: "slam_prior_" in str(p))
    capture(monkeypatch, jds.LidarSimulator)
    with pytest.raises(Captured) as jc:
        bs.cmd_config4(suite_args(prior_nodes=wl.PRIOR_NODES))
    monkeypatch.undo()
    laser = wl.suite_laser()
    world = wl.prior_world(wl.PRIOR_NODES)
    np.testing.assert_array_equal(world.segments,
                                  jc.value.sim.world.segments)
    capture(monkeypatch, tds.LidarSimulator)
    with pytest.raises(Captured) as tc:
        wl.loc_circuit(world, laser)
    monkeypatch.undo()
    t, j = tc.value, jc.value
    np.testing.assert_array_equal(t.waypoints, j.waypoints)
    assert (t.step, t.sim.range_noise, tuple(t.sim.odom_noise)) == (
        j.step, j.sim.range_noise, tuple(j.sim.odom_noise))
    assert t.state == j.state
    n_circuit = len(tds.trajectory_from_waypoints(t.waypoints, t.step))
    assert n_circuit == 1644
    assert math.ceil(wl.LOCALIZED_SCANS / n_circuit) * n_circuit >= (
        wl.LOCALIZED_SCANS)
    for mod in (jds, tds):
        orig = mod.trajectory_from_waypoints
        monkeypatch.setattr(mod, "trajectory_from_waypoints",
                            lambda w, s, orig=orig: orig(w, s)[:N_SCANS])
    head = simulate_head(j, jds.LidarSimulator.simulate)
    circuit = wl.loc_circuit(world, laser)
    same_scans(circuit, head)
    same_scans(wl.repeat_circuit(circuit, 4)[:N_SCANS],
               bs._repeat_circuit(head, 4, (0.012, 0.005), seed=31)
               [:N_SCANS])
    short = circuit[:7]
    same_scans(wl.repeat_circuit(short, 3),
               bs._repeat_circuit(short, 3, (0.012, 0.005), seed=31))
    code = next(c for c in bs.cmd_config4.__code__.co_consts
                if getattr(c, "co_name", "") == "_loc_cfg")
    same_cfg(wl.loc_cfg(), types.FunctionType(code, vars(bs))())


def run_command(capsys, *argv):
    """configs_torch.main on the CPU: rc 0 and the last line's JSON."""
    assert configs_torch.main(list(argv) + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("# configs_torch") and "not held" in out[0]
    rec = json.loads(out[-1])
    assert rec["device"]["type"] == "cpu" and rec["bars_held"] is False
    return rec


CUT = ("--resolution", "0.05", "--beam-deg", "1.0")


def test_configs_config2_at_a_cut(capsys):
    rec = run_command(capsys, "config2", "--laps", "1", "--scans", "80",
                      *CUT)
    assert rec["raw_scans"] == 80
    assert [p["tag"] for p in rec["passes"]] == ["config2 warm", "config2"]
    for p in rec["passes"]:
        assert p["accepted"] == p["nodes"] == 80
        assert np.isfinite(p["ate"]) and p["ate"] < 0.15
        assert p["resources"]["pool"]["used"] == 81
    assert rec["passes"][0]["ate"] == rec["passes"][1]["ate"]


@pytest.mark.parametrize("variant", ["marginalized", "reference"])
def test_configs_config3_at_a_cut(capsys, variant):
    rec = run_command(capsys, "config3", "--variant", variant, "--laps",
                      "1", "--scans", "90", *CUT)
    assert rec["variant"] == variant and rec["raw_scans"] == 90
    assert rec["accepted"] == 90 and rec["curve"][-1] == [90, rec["nodes"]]
    assert np.isfinite(rec["ate"]) and rec["reference"]["final_nodes"]
    assert set(rec["decay_ms"]) >= {"decay", "candidates", "score"}


def test_configs_config4_at_a_cut(capsys, tmp_path):
    rec = run_command(capsys, "config4", "--prior-nodes", "450", "--scans",
                      "90", "--cache", str(tmp_path), *CUT)
    snap = configs_torch.prior_path(450, wl.suite_laser(1.0), str(tmp_path))
    # the snapshot alone, under a name that holds its builder's hash (no
    # part file left by the rename)
    assert os.listdir(tmp_path) == [os.path.basename(snap)]
    assert rec["prior_nodes"] == 450 and rec["raw_scans"] == 90
    assert rec["localized"] == 90 and rec["nodes"] <= 450 + 10 + 1
    assert rec["rmse"] < 0.35 and rec["solves"].get("windowed", 0) >= 1
    assert rec["repeats"] * rec["circuit"] >= wl.LOCALIZED_SCANS


def _reference_decay(pkg, n_scans=2400):
    """Config 3's reference decay (delete-only, steady_state_min_candidates
    0) over the warehouse's first n_scans raw scans at a reduced geometry
    (0.05 m grid, 361 beams) in one package's streaming session (the JAX
    one with its fused verify, as the port runs it): every decision of
    the decay (scan, removed ids), the node curve every 200 scans, the
    survivors' ATE and the closures."""
    laser, data = wl.warehouse_workload(laps=n_scans // 479 + 1,
                                        beam_deg=1.0)
    cfg = wl.lifelong_cfg(False, correlation_search_space_resolution=0.05)
    if pkg == "jax":
        from slam_toolbox_tpu.mapper import lifelong as mod

        jcfg = bs._cfg(loop_match_minimum_chain_size=5,
                       marginalize_on_removal=False,
                       correlation_search_space_resolution=0.05)
        same_cfg(cfg, jcfg)
        sess = jax_api.SlamSession(jcfg, bs._laser(1.0), streaming=True,
                                   drain_every=96)
    else:
        from slam_toolbox_tpu_torch.api import SlamSession
        from slam_toolbox_tpu_torch.mapper import lifelong as mod

        sess = SlamSession(cfg, laser, streaming=True, drain_every=96,
                           device="cpu")
    ll = mod.LifelongMapper(
        sess.mapper, mod.LifelongConfig(steady_state_min_candidates=0))
    log, curve, gts = [], [], []
    evaluate = ll.evaluate_node_depreciation

    def logged(scan):
        removed = evaluate(scan)
        log.append((scan.unique_id, list(removed)))
        return removed

    ll.evaluate_node_depreciation = logged
    sess._ensure_pipe().post_finish = ll.stream_hook
    for i, (scan, tp) in enumerate(data[:n_scans]):
        if sess.process_scan(scan.ranges, scan.odom_pose,
                             time=i * 0.1) is not None:
            gts.append(tp)
        if i % 200 == 0:
            curve.append((i, sess.mapper.solver.n_nodes))
    sess.flush()
    surv = sess.mapper.all_processed_scans()
    est = np.stack([s.corrected_pose[:2] for s in surv])
    gt = np.stack([gts[s.unique_id][:2] for s in surv])
    ate = float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=1))))
    return dict(log=log, curve=curve, ate=ate,
                nodes=sess.mapper.solver.n_nodes)


@pytest.mark.slow
def test_reference_decay_follows_jax_on_the_warehouse(monkeypatch):
    """Config 3's reference variant, port against the JAX package, on the
    first 2,400 raw scans (5 laps) at a reduced geometry: every decay
    decision equal, the same node curve, the survivors' ATE within
    PARITY.md's 4 cm (slow: about 5 minutes). Prints the figures with
    -s."""
    monkeypatch.setenv("SLAM_FUSED_LOOP", "1")
    jax_run, port = _reference_decay("jax"), _reference_decay("torch")
    print(f"reference decay, 2,400 scans: JAX nodes {jax_run['nodes']} "
          f"ATE {jax_run['ate']} m; port nodes {port['nodes']} ATE "
          f"{port['ate']} m; curve {port['curve']}")
    assert port["log"] == jax_run["log"]
    assert port["curve"] == jax_run["curve"]
    assert abs(port["ate"] - jax_run["ate"]) < 0.04


@pytest.mark.slow
def test_reference_decay_parts_from_jax_only_at_a_near_tie():
    """Config 3's reference decay at full geometry (0.01 m, 1,081 beams)
    over the first 390 raw scans (past the drain at scan 384), the JAX
    package and the port on the CPU (tests/torch_decay_parting.py): up
    to the first scan whose match pose differs by more than 1e-4, the
    match responses agree within 1e-4 and every decay decision is equal;
    at that scan the two responses are within 1e-4 of each other, a near
    tie between poses one search step apart (0.01 m, 0.2 degrees), which
    float rounding decides (slow: about 12 minutes). Prints where they
    part with -s."""
    import torch_decay_parting as dp

    jax_run, port = dp.trace("jax", 390), dp.trace("torch", 390)
    part = dp.parting(port, jax_run)
    print(f"reference decay at full geometry, 390 scans: {part}")
    k = part["scan"]
    assert part["response_before"] < 1e-4 and part["pose_before"] < 1e-4
    if k is None:
        return
    (ra, xa, ya, ta), (rb, xb, yb, tb) = part["rows"]
    assert abs(ra - rb) < 1e-4
    assert max(abs(xa - xb), abs(ya - yb)) <= 0.0101
    assert abs(ta - tb) <= np.deg2rad(0.2) + 1e-6
    before = [(s, r) for s, r, _ in port["log"] if s < k]
    assert before == [(s, r) for s, r, _ in jax_run["log"] if s < k]
