"""Occupancy-grid mapping from a live SLAM run — SLAM.m's dead map path.

The reference sketches occupancy mapping and ships it commented out: the
scan→world transform with a hard-coded +12.5 grid offset feeding
``setOccupancy`` never runs (SLAM.m:118-124).  This demo is the working
version: run the full SLAM session (predict → RANSAC → gate → update),
then fuse every scan at its ESTIMATED pose into a log-odds occupancy grid
(ops/occupancy.py) — the whole fusion is one lax.scan device program.

Usage:  python examples/occupancy_mapping.py [--ticks 200] [--out map.png]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from ekf_slam_tpu.config import EKFParams, RansacParams, SimConfig
from ekf_slam_tpu.ops.occupancy import (init_grid, map_session,
                                        occupancy_probability)
from ekf_slam_tpu.session import SlamSession
from ekf_slam_tpu.sim import world as W


def main():
    from ekf_slam_tpu.utils.runtime import enable_compile_cache
    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=200)
    ap.add_argument("--resolution", type=float, default=0.1,
                    help="meters per grid cell")
    ap.add_argument("--out", type=str, default=None,
                    help="render the probability grid to this PNG")
    args = ap.parse_args()

    cfg = SimConfig(n_beams=720, max_range=12.0)
    room = W.rectangle_room(4.0, 3.0)
    controls = W.circle_controls(args.ticks, dD=0.05, dTh=3.0)
    traj = W.simulate(room, controls, cfg, jax.random.PRNGKey(0))

    sess = SlamSession(
        ekf_params=EKFParams(capacity=32, max_obs=8, ref_compat=False,
                             update_mode="batched", dtype=jnp.float32),
        ransac_params=RansacParams(
            line_consensus=60, bearing_window_deg=15.0,
            wall_search_timeout=4, table_capacity=64, promote_count=5,
            ref_compat=False, dtype=jnp.float32),
        seed=1)
    carry, outs = sess.run(traj.odom, traj.ranges, traj.beam_angles)

    # fuse every scan at its SLAM-estimated pose (one fused device program)
    half = 8.0
    size = int(2 * half / args.resolution)
    grid = init_grid(size, size, args.resolution, origin=(-half, -half))
    grid = map_session(grid, jnp.asarray(np.asarray(outs.pose)),
                       jnp.asarray(traj.ranges), traj.beam_angles)

    prob = np.asarray(occupancy_probability(grid))
    occupied = int((prob > 0.7).sum())
    free = int((prob < 0.3).sum())
    unknown = prob.size - occupied - free
    print(f"grid {size}x{size} @ {args.resolution} m: "
          f"occupied={occupied} free={free} unknown={unknown}")
    # the simulated room's walls should be mapped as a closed loop of
    # occupied cells around a free interior
    assert occupied > 0 and free > occupied
    print(f"landmarks={int(carry.filt.n_active)}  "
          f"wall cells trace the {4.0 * 2}x{3.0 * 2} m room")

    if args.out:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(6, 6))
        ax.imshow(prob, origin="lower", cmap="gray_r",
                  extent=[-half, half, -half, half], vmin=0, vmax=1)
        est = np.asarray(outs.pose)
        ax.plot(est[:, 0], est[:, 1], "c-", lw=1.2, label="estimated path")
        lm = np.asarray(carry.filt.landmarks)
        act = np.asarray(carry.filt.active)
        if act.any():
            ax.plot(lm[act, 0], lm[act, 1], "r+", ms=10, label="landmarks")
        ax.set_title("occupancy grid from SLAM-estimated poses\n"
                     "(the working form of SLAM.m:118-124's dead path)")
        ax.legend(loc="upper right")
        fig.savefig(args.out, dpi=110, bbox_inches="tight")
        print(f"map -> {args.out}")


if __name__ == "__main__":
    main()
