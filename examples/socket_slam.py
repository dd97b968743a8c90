"""Live SLAM over a process boundary — the reference's operating mode.

The reference connects to a robot over the network and blocks on each
scan/odometry message (`rosinit('192.168.1.13')`; `receive(laser)` —
/root/reference/test_SLAM.m:11-18, SLAM.m:73-74).  Here a FEEDER
PROCESS streams a simulated trajectory over a localhost TCP socket
(io/socket_feed.serve_trajectory) and this process consumes it with the
blocking SocketScanSource, pushing every tick through the micro-batched
streaming driver — then verifies the live result is TICK-EXACT against
the offline fused run of the same data.

Run:  python examples/socket_slam.py [--ticks 60] [--rate-hz 100]
"""
import argparse
import multiprocessing as mp
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

from ekf_slam_tpu.config import EKFParams, RansacParams, SimConfig
from ekf_slam_tpu.io.socket_feed import SocketScanSource, serve_trajectory
from ekf_slam_tpu.io.stream import StreamingSlamSession
from ekf_slam_tpu.session import SlamSession
from ekf_slam_tpu.sim import world as W


def make_session(seed=1):
    return SlamSession(
        algorithm="EKF_SLAM_UC",
        ekf_params=EKFParams(capacity=32, max_obs=8, ref_compat=False,
                             update_mode="batched", dtype=jnp.float32),
        ransac_params=RansacParams(
            line_consensus=60, bearing_window_deg=15.0,
            wall_search_timeout=4, table_capacity=32, promote_count=5,
            ref_compat=False, dtype=jnp.float32),
        seed=seed)


def main(argv=None):
    from ekf_slam_tpu.utils.runtime import enable_compile_cache
    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=60)
    ap.add_argument("--port", type=int, default=47311)
    ap.add_argument("--rate-hz", type=float, default=0.0,
                    help="feeder cadence (0 = unthrottled)")
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--native", action="store_true",
                    help="feed from the C++ robot-side binary "
                         "(native/scan_feeder.cc) replaying a recorded "
                         "scan log, instead of the Python feeder")
    args = ap.parse_args(argv)

    cfg = SimConfig(n_beams=720, max_range=12.0)
    room = W.rectangle_room(4.0, 3.0)
    traj = W.simulate(room, W.circle_controls(args.ticks, 0.05, 3.0), cfg,
                      jax.random.PRNGKey(0), start_pose=(0.0, 0.0, 0.0))
    odom = np.asarray(traj.odom, np.float32)
    ranges = np.asarray(traj.ranges, np.float32)

    # --- feeder process: the "robot" on the other side of the socket
    if args.native:
        # the C++ robot-side binary replaying a recorded scan log —
        # native on the robot like the reference's ROS publisher side
        import subprocess
        import tempfile
        import time

        from ekf_slam_tpu.io import scanlog
        from ekf_slam_tpu.io.socket_feed import native_feeder_path

        binary = native_feeder_path()
        if binary is None:
            print("no C++ toolchain for --native", file=sys.stderr)
            return 1
        tmp = tempfile.NamedTemporaryFile(suffix=".ekslog", delete=False)
        scanlog.write(tmp.name, odom, ranges)
        feeder_cmd = [binary, tmp.name, str(args.port)]
        if args.rate_hz:
            feeder_cmd.append(str(args.rate_hz))
        proc = subprocess.Popen(feeder_cmd)
        src = None
        for _ in range(100):                    # wait for listen
            try:
                src = SocketScanSource("127.0.0.1", args.port,
                                       connect_timeout=1.0)
                break
            except OSError:
                time.sleep(0.1)
        if src is None:
            print("native feeder did not come up", file=sys.stderr)
            return 1

        class _Joiner:
            def join(self, timeout=None):
                proc.wait(timeout=timeout)
        feeder = _Joiner()
    else:
        # Python feeder (spawn, not fork: forking a process that already
        # initialized JAX's thread pools can deadlock).  The feeder is
        # NumPy-only; JAX_PLATFORMS=cpu in its environment keeps the
        # re-imported main module from opening the accelerator this
        # process holds.
        ctx = mp.get_context("spawn")
        ready = ctx.Event()
        feeder = ctx.Process(
            target=serve_trajectory,
            args=(args.port, odom, ranges),
            kwargs=dict(rate_hz=args.rate_hz or None, ready_event=ready),
            daemon=True)
        parent_platforms = os.environ.get("JAX_PLATFORMS")
        os.environ["JAX_PLATFORMS"] = "cpu"
        try:
            feeder.start()
        finally:
            if parent_platforms is None:
                del os.environ["JAX_PLATFORMS"]
            else:
                os.environ["JAX_PLATFORMS"] = parent_platforms
        if not ready.wait(timeout=10):
            print("feeder did not come up", file=sys.stderr)
            return 1
        src = SocketScanSource("127.0.0.1", args.port)

    # --- live consumer: blocking receive → streaming driver
    sess = make_session()
    stream = StreamingSlamSession(sess, n_beams=src.n_beams,
                                  beam_angles=traj.beam_angles,
                                  window=args.window, first_odom=odom[0])
    got = []
    for od, rg in src:                      # blocks per tick, like receive()
        got.extend(stream.push(od, rg))
    got.extend(stream.flush())
    feeder.join(timeout=10)

    s = stream.stats.summary()
    print(f"live: {len(got)} ticks over the socket, "
          f"{s['ticks_per_sec']:.1f} ticks/s, "
          f"p50 {s['latency_p50_ms']:.0f} ms, "
          f"p99 {s['latency_p99_ms']:.0f} ms")

    # --- offline fused run of the IDENTICAL data (the same f32 arrays
    # the socket carried — under x64 test configs the sim emits f64)
    _, off = make_session().run(odom, ranges, traj.beam_angles)
    live_poses = np.stack([np.asarray(o.pose) for o in got])
    ok = (len(got) == args.ticks
          and np.array_equal(live_poses, np.asarray(off.pose)))
    print("tick-exact vs offline run:", "PASS" if ok else "FAIL")
    n_lm = int(np.asarray(got[-1].n_active))
    print(f"landmarks mapped: {n_lm}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
