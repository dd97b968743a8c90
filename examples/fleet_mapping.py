"""Multi-robot fleet mapping: N independent SLAM sessions as one vmapped
device program (parallel/multi.py) — the data-parallel axis.

Usage: python examples/fleet_mapping.py [--robots 4] [--ticks 150]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from ekf_slam_tpu.config import EKFParams, RansacParams, SimConfig
from ekf_slam_tpu.parallel.multi import FleetSlamSession
from ekf_slam_tpu.sim import world as W


def main():
    from ekf_slam_tpu.utils.runtime import enable_compile_cache
    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--robots", type=int, default=4)
    ap.add_argument("--ticks", type=int, default=150)
    args = ap.parse_args()

    cfg = SimConfig(n_beams=720, max_range=12.0)
    room = W.rectangle_room(4.0, 3.0)

    # each robot drives a different loop in the same world
    trajs = []
    for i in range(args.robots):
        controls = W.circle_controls(args.ticks, dD=0.04 + 0.01 * i,
                                     dTh=2.0 + i)
        trajs.append(W.simulate(room, controls, cfg,
                                jax.random.PRNGKey(i)))
    odom = jnp.stack([t.odom for t in trajs], axis=1)      # [T,N,3]
    ranges = jnp.stack([t.ranges for t in trajs], axis=1)  # [T,N,B]
    beams = trajs[0].beam_angles

    fleet = FleetSlamSession(
        n_sessions=args.robots,
        ekf_params=EKFParams(capacity=32, max_obs=8, ref_compat=False,
                             update_mode="batched", dtype=jnp.float32),
        ransac_params=RansacParams(
            line_consensus=60, bearing_window_deg=15.0,
            wall_search_timeout=4, table_capacity=64, promote_count=5,
            ref_compat=False, dtype=jnp.float32),
        seed=100)
    carry, outs = fleet.run(odom, ranges, beams)

    for i in range(args.robots):
        est = np.asarray(outs.pose[:, i, :2], np.float64)
        truth = np.asarray(trajs[i].truth[:, :2], np.float64)
        ate = float(np.sqrt(np.mean(np.sum((est - truth) ** 2, -1))))
        print(f"robot {i}: {int(carry.filt.n_active[i])} landmarks, "
              f"ATE {ate:.3f} m")

    # fuse the robots' local maps into one global frame: ICP scan-match
    # alignment between robots + pose-graph optimization
    # (parallel/fleet_merge.py).  All robots here started at the origin, so
    # the deployment guesses are exact — the merge demonstrates the dedup
    # and the pipeline; see tests/test_fleet_merge.py for displaced starts.
    from ekf_slam_tpu.parallel.fleet_merge import (merge_maps,
                                                   robot_map_from_carry)
    maps = []
    for i in range(args.robots):
        ci = jax.tree_util.tree_map(lambda a, i=i: a[i], carry)
        maps.append(robot_map_from_carry(
            ci, np.asarray(trajs[i].ranges[0]), beams,
            anchor_guess=np.zeros(3)))
    res = merge_maps(maps, icp_min_inliers=60, icp_max_rmse=0.25)
    print(f"merged map: {res.landmarks.shape[0]} landmarks "
          f"(from {res.n_before_merge} across {args.robots} robots, "
          f"{res.n_icp_edges} scan-match alignments)")


if __name__ == "__main__":
    main()
