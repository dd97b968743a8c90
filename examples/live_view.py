"""Live SLAM display loop — the reference's per-tick plot cycle.

The reference redraws robot glyph, landmark markers, covariance
ellipses, candidates and scan scatter every tick
(/root/reference/EKF_SLAM.m:154-234 called from SLAM.m:131-139).  This
drives the session tick-by-tick and paints the same elements live: an
interactive window where a GUI backend exists, an animated GIF
(`--gif`) everywhere else.

Run:  python examples/live_view.py --ticks 40 --gif /tmp/slam_live.gif
"""
import argparse
import sys

import jax
import jax.numpy as jnp
import numpy as np

from ekf_slam_tpu import viz
from ekf_slam_tpu.config import EKFParams, RansacParams, SimConfig
from ekf_slam_tpu.ops.scan import scan_from_ranges, to_cartesian, to_world
from ekf_slam_tpu.session import SlamSession
from ekf_slam_tpu.sim import world as W


def main(argv=None):
    from ekf_slam_tpu.utils.runtime import enable_compile_cache
    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=40)
    ap.add_argument("--gif", default=None,
                    help="record the live view as an animated GIF "
                         "(the headless form of the window)")
    ap.add_argument("--every", type=int, default=1,
                    help="draw every Nth tick")
    args = ap.parse_args(argv)

    cfg = SimConfig(n_beams=720, max_range=12.0)
    room = W.rectangle_room(4.0, 3.0)
    traj = W.simulate(room, W.circle_controls(args.ticks, 0.05, 3.0), cfg,
                      jax.random.PRNGKey(0), start_pose=(0.0, 0.0, 0.0))
    odom = np.asarray(traj.odom)
    ranges = np.asarray(traj.ranges)

    sess = SlamSession(
        algorithm="EKF_SLAM_UC",
        ekf_params=EKFParams(capacity=32, max_obs=8, ref_compat=False,
                             update_mode="batched", dtype=jnp.float32),
        ransac_params=RansacParams(
            line_consensus=60, bearing_window_deg=15.0,
            wall_search_timeout=4, table_capacity=32, promote_count=5,
            ref_compat=False, dtype=jnp.float32),
        seed=1)
    carry = sess.init_carry(first_odom=odom[0])

    view = viz.LiveView(gif_path=args.gif)
    truth = np.asarray(traj.truth)
    for t in range(args.ticks):
        carry, out = sess.step(carry, odom[t], ranges[t],
                               traj.beam_angles)
        if t % args.every:
            continue
        scan = scan_from_ranges(jnp.asarray(ranges[t]), traj.beam_angles)
        sw = np.asarray(to_world(to_cartesian(scan), carry.filt.x[:3]))
        view.update(carry.filt, table=carry.table, obs=out.obs,
                    scan_world=sw[np.asarray(scan.valid)],
                    truth=truth[:t + 1])
    view.close()
    mode = "window" if view.interactive else "headless"
    print(f"live view: {view.frames} frames ({mode})"
          + (f", gif -> {args.gif}" if args.gif else ""))
    print(f"landmarks mapped: {int(carry.filt.n_active)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
