"""Live-session demo: the test_SLAM.m equivalent on the simulator.

The reference's entry script connects to a LAN robot and loops forever
(test_SLAM.m:11-18: rosinit → SLAM('EKF_SLAM_UC') → while(1) runSlam()).
Here the robot is the deterministic simulator and the whole session runs as
one fused device program; pass --frames to also render reference-style
plots (viz.py).

Usage:  python examples/run_sim_slam.py [--ticks 200] [--frames out_dir]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from ekf_slam_tpu.config import EKFParams, RansacParams, SimConfig
from ekf_slam_tpu.session import SlamSession
from ekf_slam_tpu.sim import world as W
from ekf_slam_tpu.utils.metrics import MetricsLogger, filter_health


def main():
    from ekf_slam_tpu.utils.runtime import enable_compile_cache
    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=200)
    ap.add_argument("--frames", type=str, default=None,
                    help="directory for rendered frames")
    ap.add_argument("--algorithm", default="EKF_SLAM_UC",
                    choices=["EKF_SLAM", "EKF_SLAM_UC"])
    ap.add_argument("--batched", action="store_true",
                    help="use the joint batched-innovation update")
    ap.add_argument("--metrics", default=None, help="JSONL metrics path")
    args = ap.parse_args()

    cfg = SimConfig(n_beams=720, max_range=12.0)
    room = W.rectangle_room(4.0, 3.0)
    controls = W.circle_controls(args.ticks, dD=0.05, dTh=3.0)
    traj = W.simulate(room, controls, cfg, jax.random.PRNGKey(0))

    ekf_params = EKFParams(
        capacity=32, max_obs=8, ref_compat=False,
        association="known" if args.algorithm == "EKF_SLAM" else "signature",
        update_mode="batched" if args.batched else "sequential",
        dtype=jnp.float32)
    ransac_params = RansacParams(
        line_consensus=60, bearing_window_deg=15.0, wall_search_timeout=4,
        table_capacity=64, promote_count=5, ref_compat=False,
        dtype=jnp.float32)

    sess = SlamSession(algorithm=args.algorithm, ekf_params=ekf_params,
                       ransac_params=ransac_params, seed=1)
    carry, outs = sess.run(traj.odom, traj.ranges, traj.beam_angles)

    est = np.asarray(outs.pose)
    truth = np.asarray(traj.truth)
    ate = float(W.ate_rmse(jnp.asarray(est[:, :2]),
                           jnp.asarray(truth[:, :2])))
    ate_odo = float(W.ate_rmse(traj.odom[:, :2], traj.truth[:, :2]))
    h = filter_health(carry.filt)
    print(f"ticks={args.ticks}  landmarks={int(carry.filt.n_active)}  "
          f"observations={int(outs.n_obs.sum())}")
    print(f"ATE slam={ate:.4f} m   ATE odometry-only={ate_odo:.4f} m")
    print(f"P health: finite={bool(h.finite)} asym={float(h.asym):.2e} "
          f"min_diag={float(h.min_diag):.2e}")

    if args.metrics:
        log = MetricsLogger(path=args.metrics)
        for t in range(args.ticks):
            log.log(t, n_active=int(outs.n_active[t]),
                    n_obs=int(outs.n_obs[t]),
                    err=float(np.linalg.norm(est[t, :2] - truth[t, :2])))
        log.close()
        print(f"metrics -> {args.metrics}")

    if args.frames:
        from ekf_slam_tpu import viz
        from ekf_slam_tpu.ops.scan import scan_from_ranges, scan_to_world
        os.makedirs(args.frames, exist_ok=True)
        last_obs = jax.tree_util.tree_map(lambda a: a[-1], outs.obs)
        sw = scan_to_world(
            scan_from_ranges(traj.ranges[-1], traj.beam_angles),
            jnp.asarray(est[-1]))
        p = viz.save_frame(os.path.join(args.frames, "final.png"),
                           carry.filt, table=carry.table, obs=last_obs,
                           scan_world=sw, truth=traj.truth)
        print(f"frame -> {p}")


if __name__ == "__main__":
    main()
