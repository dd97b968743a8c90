"""Elastic recovery demo: kill a live SLAM session, rejoin from the last
checkpoint, finish the run — final state identical to an uninterrupted one.

The reference's state dies with its MATLAB workspace (test_SLAM.m:5);
here the whole session carry is one pytree snapshotted every K ticks
(utils/recovery.py over utils/checkpointing.py).

Usage: python examples/elastic_recovery.py [--ticks 120] [--every 20]
       [--die-at 70] [--ckpt-dir /tmp/slam_ckpt]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    from ekf_slam_tpu.utils.runtime import enable_compile_cache
    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=120)
    ap.add_argument("--every", type=int, default=20)
    ap.add_argument("--die-at", type=int, default=70)
    ap.add_argument("--ckpt-dir", default="/tmp/slam_ckpt")
    args = ap.parse_args()

    import shutil
    for d in (args.ckpt_dir, args.ckpt_dir + "_ref"):
        shutil.rmtree(d, ignore_errors=True)   # stale snapshots from a
        # previous demo would otherwise resume past the crash point

    import jax
    import jax.numpy as jnp
    from ekf_slam_tpu.config import EKFParams, RansacParams, SimConfig
    from ekf_slam_tpu.session import SlamSession
    from ekf_slam_tpu.sim import world as W
    from ekf_slam_tpu.utils import recovery

    cfg = SimConfig(n_beams=720, max_range=12.0)
    room = W.rectangle_room(4.0, 3.0)
    traj = W.simulate(room, W.circle_controls(args.ticks, 0.05, 3.0), cfg,
                      jax.random.PRNGKey(0), start_pose=(0.0, 0.0, 0.0))

    def make_session():
        return SlamSession(
            ekf_params=EKFParams(capacity=32, max_obs=8, ref_compat=False,
                                 update_mode="batched", dtype=jnp.float32),
            ransac_params=RansacParams(
                line_consensus=60, bearing_window_deg=15.0,
                wall_search_timeout=4, table_capacity=32, promote_count=5,
                ref_compat=False, dtype=jnp.float32),
            seed=1)

    print(f"[1] live session, checkpoint every {args.every} ticks, "
          f"host dies at tick {args.die_at}…")
    try:
        recovery.run_with_checkpoints(
            make_session(), traj.odom, traj.ranges, traj.beam_angles,
            args.ckpt_dir, every=args.every, die_at_tick=args.die_at)
    except recovery.HostCrash as e:
        print(f"    CRASH: {e}")

    print("[2] restarted host: fresh session resumes from the snapshot…")
    final, _, start = recovery.resume_latest(
        make_session(), traj.odom, traj.ranges, traj.beam_angles,
        args.ckpt_dir, every=args.every)
    print(f"    resumed from tick {start}, replayed the tail")

    ref_carry, _, _ = recovery.run_with_checkpoints(
        make_session(), traj.odom, traj.ranges, traj.beam_angles,
        args.ckpt_dir + "_ref", every=args.every)
    dx = float(np.max(np.abs(np.asarray(final.filt.x)
                             - np.asarray(ref_carry.filt.x))))
    print(f"[3] uninterrupted-run comparison: max|Δx| = {dx:.3e} "
          f"(bit-continuous={dx == 0.0})")
    print(f"    pose={np.asarray(final.filt.x[:3])} "
          f"landmarks={int(final.filt.n_active)}")


if __name__ == "__main__":
    main()
