"""Command-line driver: run a dataset end-to-end and emit map + trajectory
+ metrics (replaces the reference's launch-file + rosbag workflow for the
engine layer). The PyTorch port's counterpart of slam_toolbox_tpu/api/cli.py.

Usage:
  python -m slam_toolbox_tpu_torch.api.cli demo --out /tmp/run  # synthetic
  python -m slam_toolbox_tpu_torch.api.cli run --dataset scans.npz \
      --out /tmp/run
  python -m slam_toolbox_tpu_torch.api.cli merge a.npz b.npz --out merged

Every command runs on the card (`--device cuda`, the default) and raises
without one; `--device cpu` runs the plain versions on the CPU.
`localize` keeps its arguments and raises NotImplementedError until
localization is ported (ROADMAP Queue 1 item 7).

Dataset format (npz): ranges (N, B), odom (N, 3), times (N,), plus laser
intrinsics as scalars (min_range, max_range, range_threshold, min_angle,
max_angle, angular_resolution).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np


def _tmp(name: str) -> str:
    """Default output prefix: `name` in the temporary directory."""
    return os.path.join(tempfile.gettempdir(), name)


def _save_pgm(grid, path_prefix: str) -> None:
    """Write .pgm/.yaml like map_saver (map_server conventions)."""
    from slam_toolbox_tpu_torch.kernels.occupancy import FREE, OCCUPIED

    cells = grid.cells[::-1]  # image convention: y down
    img = np.full(cells.shape, 205, np.uint8)  # unknown gray
    img[cells == FREE] = 254
    img[cells == OCCUPIED] = 0
    with open(path_prefix + ".pgm", "wb") as f:
        f.write(
            f"P5\n{cells.shape[1]} {cells.shape[0]}\n255\n".encode()
        )
        f.write(img.tobytes())
    with open(path_prefix + ".yaml", "w") as f:
        f.write(
            f"image: {path_prefix}.pgm\n"
            f"resolution: {grid.resolution}\n"
            f"origin: [{grid.offset[0]}, {grid.offset[1]}, 0.0]\n"
            "negate: 0\noccupied_thresh: 0.65\nfree_thresh: 0.196\n"
        )


def cmd_demo(args) -> int:
    from slam_toolbox_tpu_torch.api import SlamSession
    from slam_toolbox_tpu_torch.core.params import ONLINE_SYNC
    from slam_toolbox_tpu_torch.core.scan import LaserConfig
    from slam_toolbox_tpu_torch.io.dataset import LidarSimulator, SegmentWorld

    laser = LaserConfig(
        min_range=0.05, max_range=12.0, range_threshold=10.0,
        angular_resolution=np.deg2rad(1.0),
    )
    world = SegmentWorld.rooms(16.0, 10.0)
    sim = LidarSimulator(world, laser, range_noise=0.01,
                         odom_noise=(0.015, 0.006), seed=args.seed)
    waypoints = np.array([
        (-6.0, -3.5), (1.5, -3.5), (5.5, -3.5), (5.5, 0.5), (5.5, 3.5),
        (1.0, 3.5), (-3.0, 3.5), (-6.0, 3.0), (-6.5, -1.0), (-6.0, -3.5),
    ])
    data = sim.simulate(waypoints, step=args.step)
    cfg = ONLINE_SYNC.replace(minimum_time_interval=3600.0)
    sess = SlamSession(cfg, laser, streaming=args.streaming,
                       drain_every=args.drain, device=args.device)
    t0 = time.time()
    est, gt, odo = [], [], []
    for i, (scan, tp) in enumerate(data):
        out = sess.process_scan(scan.ranges, scan.odom_pose, time=i * 0.1)
        if out is not None:
            est.append(out[0])
            gt.append(tp)
            odo.append(scan.odom_pose)
    dt = time.time() - t0
    gt, odo = np.stack(gt), np.stack(odo)
    # corrected trajectory at save time (includes loop-closure updates to
    # old poses; with --streaming the per-scan outputs are priors anyway)
    est = sess.trajectory
    k = min(len(est), len(gt))
    _finish(sess, args.out, dt, k, est[:k], gt[:k], odo[:k])
    return 0


def cmd_run(args) -> int:
    from slam_toolbox_tpu_torch.api import SlamSession
    from slam_toolbox_tpu_torch.core.params import ONLINE_SYNC
    from slam_toolbox_tpu_torch.core.scan import LaserConfig

    ds = str(args.dataset)
    gt = None
    if ds.endswith((".clf", ".clf.gz", ".log", ".log.gz")) or (
        not ds.endswith((".npz", ".npy"))
    ):
        # recorded CARMEN text log (Intel Lab / ACES / MIT-style)
        from slam_toolbox_tpu_torch.io.carmen import read_carmen

        log = read_carmen(ds)
        laser = log.laser
        ranges = np.stack([r.ranges for r in log.records])
        odom = np.stack([r.odom_pose for r in log.records])
        times = np.array([r.timestamp for r in log.records])
        gt = log.ground_truth()
    else:
        z = np.load(ds)
        laser = LaserConfig(
            min_range=float(z["min_range"]),
            max_range=float(z["max_range"]),
            range_threshold=float(z["range_threshold"]),
            min_angle=float(z["min_angle"]),
            max_angle=float(z["max_angle"]),
            angular_resolution=float(z["angular_resolution"]),
        )
        ranges, odom = z["ranges"], z["odom"]
        times = (z["times"] if "times" in z
                 else np.arange(len(ranges)) * 0.1)
        gt = z["gt"] if "gt" in z else None
    cfg = ONLINE_SYNC.replace(minimum_time_interval=3600.0)
    sess = SlamSession(cfg, laser, streaming=args.streaming,
                       drain_every=args.drain, device=args.device)
    t0 = time.time()
    est, gts, odos = [], [], []
    for i in range(len(ranges)):
        out = sess.process_scan(ranges[i], odom[i], time=float(times[i]))
        if out is not None:
            est.append(out[0])
            odos.append(odom[i])
            if gt is not None:
                gts.append(gt[i])
    dt = time.time() - t0
    if gt is not None and est:
        # accepted-scan-aligned ATE: corrected trajectory at save time
        traj = sess.trajectory
        k = min(len(traj), len(gts))
        _finish(sess, args.out, dt, len(est), traj[:k],
                np.stack(gts)[:k], np.stack(odos)[:k])
    else:
        est = np.stack(est) if est else np.zeros((0, 3))
        _finish(sess, args.out, dt, len(est), est, None, None)
    return 0


def _finish(sess, out_prefix, dt, n, est, gt, odo):
    from slam_toolbox_tpu_torch.io.dataset import ate_rmse

    grid = sess.get_occupancy_grid()
    if grid is not None:
        _save_pgm(grid, out_prefix)
    np.savetxt(out_prefix + "_trajectory.txt", est)
    sess.serialize(out_prefix + ".posegraph.npz")
    metrics = {
        "scans_processed": int(n),
        "wall_time_s": round(dt, 2),
        "scans_per_sec": round(n / dt, 2) if dt > 0 else None,
        "nodes": sess.mapper.solver.n_nodes,
        "edges": len(sess.mapper.graph.edges) if sess.mapper.graph else 0,
    }
    if gt is not None:
        metrics["ate_rmse_m"] = round(ate_rmse(est, gt), 4)
        metrics["ate_odom_m"] = round(ate_rmse(odo, gt), 4)
    with open(out_prefix + "_metrics.json", "w") as f:
        json.dump(metrics, f, indent=2)
    print(json.dumps(metrics))


def cmd_localize(args) -> int:
    """Elastic localization against a serialized prior graph (the
    deserialize + LOCALIZE_AT_POSE service flow): not ported yet."""
    raise NotImplementedError(
        "localization is not ported yet (ROADMAP Queue 1 item 7)")


def cmd_merge(args) -> int:
    from slam_toolbox_tpu_torch.api.merge import MapMerger

    merger = MapMerger(device=args.device)
    for p in args.snapshots:
        merger.add_submap(p)
    grid = merger.merge(resolution=args.resolution)
    _save_pgm(grid, args.out)
    print(json.dumps({"width": grid.width, "height": grid.height}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="slam_toolbox_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("demo", help="synthetic end-to-end demo run")
    d.add_argument("--streaming", action="store_true",
                   help="device-resident batched pipeline (the bench path)")
    d.add_argument("--drain", type=int, default=48,
                   help="streaming drain cadence (scans per device batch)")
    d.add_argument("--out", default=_tmp("slam_demo"))
    d.add_argument("--seed", type=int, default=42)
    d.add_argument("--step", type=float, default=0.3)
    d.set_defaults(fn=cmd_demo)

    r = sub.add_parser("run", help="run a recorded dataset (npz)")
    r.add_argument("--dataset", required=True)
    r.add_argument("--out", default=_tmp("slam_run"))
    r.add_argument("--streaming", action="store_true",
                   help="device-resident batched pipeline (the bench path)")
    r.add_argument("--drain", type=int, default=48,
                   help="streaming drain cadence (scans per device batch)")
    r.set_defaults(fn=cmd_run)

    lz = sub.add_parser(
        "localize", help="localize a dataset against a prior graph"
    )
    lz.add_argument("--snapshot", required=True,
                    help="serialized .posegraph.npz prior")
    lz.add_argument("--dataset", required=True)
    lz.add_argument("--out", default=_tmp("slam_localize"))
    lz.add_argument("--initial-pose", default=None,
                    help="x,y,heading (default: dataset's first odom)")
    lz.add_argument("--streaming", action="store_true")
    lz.add_argument("--drain", type=int, default=8)
    lz.set_defaults(fn=cmd_localize)

    m = sub.add_parser("merge", help="merge serialized sessions")
    m.add_argument("snapshots", nargs="+")
    m.add_argument("--out", default=_tmp("slam_merged"))
    m.add_argument("--resolution", type=float, default=0.05)
    m.set_defaults(fn=cmd_merge)

    for p in (d, r, lz, m):
        p.add_argument("--device", default="cuda",
                       help="torch device; cuda (the default) raises "
                            "without a card, cpu runs the plain versions")

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
