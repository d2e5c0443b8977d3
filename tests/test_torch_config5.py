"""Config 5 (BASELINE.md's multi-session merge) in the port against the
JAX package, on the CPU at a cut.

workloads_torch's session builder is held to
scripts/bench_merge500k.build_session bit for bit (every scan's ranges,
corrected pose and odometry, the generator's state after each session),
and its threaded build's snapshots to the JAX build's saved by the JAX
package; the script's main() at 3 sessions of 450 nodes and 2 LM steps,
on a mesh of one device as the port solves it, to configs_torch's config5
at the same cut: the counts, the aligned sessions, the joint graph's
arrays, the alignments, the merged cells bit for bit on the same
corrections, chi2 and the CG iterations of each LM step. The script
writes MERGE500K.json beside its own directory, so its module's __file__
is pointed into a temporary directory; the repo's record is read before
and after and must not change. bench_suite's cmd_config5 is held to
workloads_torch.band_sessions (its simulators, seeds and waypoints), and
`config5 --variant sessions` runs at a cut."""
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

import configs_torch
import workloads_torch as wl
from scripts import bench_suite as bs
from slam_toolbox_tpu import api as jax_api
from slam_toolbox_tpu.io import dataset as jds
from slam_toolbox_tpu_torch.io.serialization import (
    load_snapshot, save_snapshot,
)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SESSIONS, NODES = 3, 450


@pytest.fixture(scope="module")
def bm():
    """scripts/bench_merge500k.py as a module, its main() not run."""
    import importlib

    return importlib.import_module("scripts.bench_merge500k")


def jax_laser(beams=wl.MERGE_BEAMS):
    from slam_toolbox_tpu.core.scan import LaserConfig

    return LaserConfig(
        beam_count=beams, min_angle=-np.pi / 2, max_angle=np.pi / 2,
        min_range=0.05, max_range=12.0, range_threshold=10.0, is_360=False)


def test_merge_sessions_match_build_session(bm, tmp_path):
    """Two sessions of 450 nodes: the port's serial builder equal to
    build_session scan for scan with the generator's state equal after
    each session; the threaded build's snapshots equal in every array
    and the meta to the JAX sessions saved by the JAX package (loaded
    with the port's load_snapshot and saved again)."""
    import dataclasses

    from slam_toolbox_tpu.io.dataset import SegmentWorld
    from slam_toolbox_tpu.io.serialization import (
        save_snapshot as jax_save,
    )

    laser = wl.merge_laser()
    assert dataclasses.asdict(laser) == dataclasses.asdict(jax_laser())
    world = wl.merge_world(2, NODES)
    origins = wl.merge_origins(2, NODES)
    jrng, trng = np.random.default_rng(7), np.random.default_rng(7)
    for s in range(2):
        jm = bm.build_session(s, NODES, jax_laser(),
                              SegmentWorld(world.segments), origins[s], jrng)
        tm = wl.build_merge_session(
            s, NODES, laser, origins[s], trng,
            map(wl.merge_aisle_ranges,
                wl.merge_aisle_jobs(world, laser, s, NODES, origins[s])))
        js, ts = jm.all_processed_scans(), tm.all_processed_scans()
        assert len(js) == len(ts) == NODES
        for a, b in zip(js, ts):
            np.testing.assert_array_equal(a.ranges, b.ranges)
            np.testing.assert_array_equal(a.odom_pose, b.odom_pose)
            np.testing.assert_array_equal(a.corrected_pose, b.corrected_pose)
        assert jrng.bit_generator.state == trng.bit_generator.state
        jax_save(jm, str(tmp_path / f"jax{s}.npz"))
    paths = [str(tmp_path / f"torch{s}.npz") for s in range(2)]
    rng = np.random.default_rng(7)
    wl.build_merge_snapshots(paths, NODES, laser, rng)
    assert rng.bit_generator.state == trng.bit_generator.state
    for s, path in enumerate(paths):
        again = str(tmp_path / f"again{s}.npz")
        save_snapshot(load_snapshot(str(tmp_path / f"jax{s}.npz"),
                                    device="cpu"), again)
        with np.load(again) as a, np.load(path) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    skipped = np.random.default_rng(7)
    wl.skip_merge_noise(skipped, 2, NODES)
    assert skipped.bit_generator.state == trng.bit_generator.state


def test_config5_matches_bench_merge500k(bm, monkeypatch, tmp_path,
                                         capsys):
    """The script's main() (--sessions 3 --nodes-per 450 --gn-steps 2, on
    one device) and configs_torch's config5 at the same cut on the CPU:
    the world, laser and session origins the script builds with; nodes,
    edges and the aligned sessions; the joint graph's arrays bit for bit;
    the alignments' corrections within 1e-5; the merged cells bit for bit
    on the JAX run's corrections; chi2 within 1e-3 relative; the CG
    iterations of each LM step within 1. The repo's MERGE500K.json is
    untouched."""
    import jax

    from slam_toolbox_tpu.api.merge import MapMerger as JaxMerger
    from slam_toolbox_tpu.dist import solver_dist as jsd
    from slam_toolbox_tpu_torch.api.merge import MapMerger

    record = os.path.join(REPO, "MERGE500K.json")
    with open(record, "rb") as f:
        before = f.read()
    built, grids, corrections, solves = [], {}, {}, []
    build = bm.build_session

    def recorded_build(sess_idx, nodes, laser, world, y0, rng):
        built.append((laser, world.segments, y0))
        return build(sess_idx, nodes, laser, world, y0, rng)

    def recording_merge(m, cls, key):
        merge = cls.merge

        def merge_and_record(self, *a, **kw):
            grid = merge(self, *a, **kw)
            if key not in grids:
                grids[key] = grid
                corrections[key] = [np.array(c) for c in self.corrections]
                if key == "torch":
                    # the port's merge of the JAX run's corrections
                    own = self.corrections
                    self.corrections = corrections["jax"]
                    grids["torch on jax"] = merge(self, *a, **kw)
                    self.corrections = own
            return grid
        m.setattr(cls, "merge", merge_and_record)

    solve = jsd.distributed_lm_solve

    def recorded_solve(mesh, *args, **kw):
        # the solve sets its last_cg_iters on the module's name: here
        solves.append(args)
        return solve(mesh, *args, **kw)

    devices = jax.devices
    os.makedirs(tmp_path / "jax")
    with monkeypatch.context() as m:
        m.setattr(jax, "devices", lambda *a, **k: devices(*a, **k)[:1])
        m.setattr(bm, "__file__",
                  str(tmp_path / "scripts" / "bench_merge500k.py"))
        m.setattr(bm.tempfile, "mkdtemp", lambda: str(tmp_path / "jax"))
        m.setattr(bm, "build_session", recorded_build)
        m.setattr(jsd, "distributed_lm_solve", recorded_solve)
        recording_merge(m, JaxMerger, "jax")
        m.setattr(sys, "argv", [
            "bench_merge500k.py", "--sessions", str(SESSIONS),
            "--nodes-per", str(NODES), "--gn-steps", "2"])
        bm.main()
    err = capsys.readouterr().err
    with open(tmp_path / "MERGE500K.json") as f:
        jrec = json.load(f)
    edges = int(next(line for line in err.splitlines()
                     if line.startswith("# joint graph:"))
                .split(" nodes, ")[1].split(" edges")[0])

    graphs = []
    joint = wl.joint_graph
    monkeypatch.setattr(wl, "joint_graph",
                        lambda *a: graphs.append(joint(*a)) or graphs[-1])
    recording_merge(monkeypatch, MapMerger, "torch")
    assert configs_torch.main([
        "config5", "--device", "cpu", "--sessions", str(SESSIONS),
        "--nodes-per", str(NODES), "--gn-steps", "2", "--cache",
        str(tmp_path / "cache")]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(record, "rb") as f:
        assert f.read() == before

    world = wl.merge_world(SESSIONS, NODES)
    assert [y0 for _, _, y0 in built] == wl.merge_origins(SESSIONS, NODES)
    for laser, segments, _ in built:
        np.testing.assert_array_equal(segments, world.segments)
        assert laser == jax_laser()
    assert rec["nodes"] == jrec["total_nodes"] == SESSIONS * NODES
    assert rec["edges"] == edges
    assert rec["aligned"] == jrec["aligned"]
    assert rec["grid"]["shape"] == jrec["grid_shape"]
    (jargs,), (g,) = solves, graphs
    for k, name in enumerate(("poses", "src", "dst", "rel", "sqrt_info",
                              "emask", "free")):
        np.testing.assert_array_equal(g[name], jargs[k], err_msg=name)
    # the alignments agree to float rounding (the matchers' f32 sums
    # differ in order), and the merge of one set of corrections is the
    # JAX merge's bit for bit; on its own corrections the port's grid
    # may differ in a cell whose beam ends that rounding moves across a
    # cell edge (1 of 134,400 here)
    for a, b in zip(corrections["torch"], corrections["jax"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    jgrid = grids["jax"]
    for key in ("torch on jax", "torch"):
        np.testing.assert_array_equal(grids[key].offset,
                                      np.asarray(jgrid.offset))
    np.testing.assert_array_equal(grids["torch on jax"].cells,
                                  np.asarray(jgrid.cells))
    differ = np.count_nonzero(grids["torch"].cells != np.asarray(jgrid.cells))
    assert differ <= jgrid.cells.size // 10000
    assert abs(rec["chi2"] - jrec["solve_chi2"]) <= 1e-3 * jrec["solve_chi2"]
    assert len(rec["cg_iters"]) == len(jrec["solve_cg_iters"])
    for a, b in zip(rec["cg_iters"], jrec["solve_cg_iters"]):
        assert abs(a - b) <= 1
    assert rec["chi2"] < rec["chi2_initial"] and rec["poses_finite"]
    assert rec["host_dxy"] < 0.01


class Recorded(Exception):
    pass


def test_band_sessions_match_cmd_config5(monkeypatch):
    """cmd_config5's three sessions (bench_suite's defaults): each
    simulator's world, noise, laser and generator state before any draw,
    its waypoints and step, and each SlamSession's configuration, laser
    and keywords, against workloads_torch.band_sessions."""
    import copy
    import dataclasses

    from slam_toolbox_tpu.api import merge as jmerge

    sims, sessions = [], []

    def simulate(self, waypoints, step=0.25, dt=0.1):
        sims.append((self, copy.deepcopy(self.rng.bit_generator.state),
                     np.asarray(waypoints), step))
        return []

    class Session:
        mapper = types.SimpleNamespace(solver=types.SimpleNamespace(
            n_nodes=0))

        def __init__(self, cfg, laser, **kw):
            sessions.append((cfg, laser, kw))

        def serialize(self, path):
            pass

    def stop(self, path):
        raise Recorded()

    monkeypatch.setattr(jds.LidarSimulator, "simulate", simulate)
    monkeypatch.setattr(jax_api, "SlamSession", Session)
    monkeypatch.setattr(jmerge.MapMerger, "add_submap", stop)
    with pytest.raises(Recorded):
        bs.cmd_config5(types.SimpleNamespace(
            full=False, laps=4, drain=96, beam_res=1.0 / 3, sessions=3,
            loc_repeat=1, prior_nodes=0, budget=600.0))
    monkeypatch.undo()
    laser, bands = wl.band_sessions(3)
    assert len(sims) == len(sessions) == len(bands) == 3
    for (jsim, state, wps, step), (cfg, jlaser, kw), (a0, per, sim, twps) \
            in zip(sims, sessions, bands):
        np.testing.assert_array_equal(sim.world.segments,
                                      jsim.world.segments)
        assert (sim.range_noise, tuple(sim.odom_noise)) == (
            jsim.range_noise, tuple(jsim.odom_noise))
        assert sim.rng.bit_generator.state == state
        assert dataclasses.asdict(sim.laser) == dataclasses.asdict(
            jsim.laser)
        np.testing.assert_array_equal(twps, wps)
        assert step == 0.3 and per == 2
        assert kw == dict(streaming=True, drain_every=96)
        assert dataclasses.asdict(wl.suite_cfg()) == dataclasses.asdict(cfg)
        assert dataclasses.asdict(laser) == dataclasses.asdict(jlaser)
    assert [b[0] for b in bands] == [0, 1, 2]


def test_config5_sessions_at_a_cut(capsys):
    """`config5 --variant sessions` on the CPU, each session cut to its
    first 40 raw scans at 0.05 m and 361 beams: three sessions mapped,
    their snapshots merged on both routes (bit-equal, held inside)."""
    assert configs_torch.main([
        "config5", "--variant", "sessions", "--device", "cpu", "--scans",
        "40", "--resolution", "0.05", "--beam-deg", "1.0"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("# configs_torch config5 sessions")
    rec = json.loads(out[-1])
    assert rec["variant"] == "sessions" and rec["bars_held"] is False
    assert [s["raw_scans"] for s in rec["sessions"]] == [40, 40, 40]
    assert [s["aisles"] for s in rec["sessions"]] == [[0, 1], [1, 2],
                                                      [2, 3]]
    assert all(s["nodes"] > 0 and np.isfinite(s["ate"])
               for s in rec["sessions"])
    assert len(rec["responses"]) == 2
    assert rec["grid"]["occupied"] > 0
    assert set(rec["stages"]["seconds"]) >= {
        "session0", "load", "align", "merge_device_route",
        "merge_native_route"}
