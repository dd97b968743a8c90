"""Functional script pipeline — the SLAM_ransac.m equivalent, runnable.

The reference's legacy script (SLAM_ransac.m) inlines the whole loop with
free functions instead of classes, using its own noise constants
(Rc = [10, 1], SLAM_ransac.m:17) — and cannot actually run (it calls
EKF_SLAM_Prediction/EKF_SLAM_Measurement which don't exist in the repo).
This is that pipeline done functionally against the engine's pure kernels:
no session object, just predict / extract / append / update composed by the
script.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from ekf_slam_tpu.config import RansacParams, ref_compat_legacy
from ekf_slam_tpu.models import ekf
from ekf_slam_tpu.ops import ransac
from ekf_slam_tpu.ops.angles import angdiff_deg
from ekf_slam_tpu.ops.scan import scan_from_ranges
from ekf_slam_tpu.sim import world as W
from ekf_slam_tpu.state import init_state
from ekf_slam_tpu.config import SimConfig


def main():
    from ekf_slam_tpu.utils.runtime import enable_compile_cache
    enable_compile_cache()
    T = 150
    cfg = SimConfig(n_beams=720, max_range=12.0)
    room = W.rectangle_room(4.0, 3.0)
    traj = W.simulate(room, W.circle_controls(T, 0.05, 3.0), cfg,
                      jax.random.PRNGKey(0))

    # legacy preset: Rc=[10,1] (SLAM_ransac.m:17); corrected-math mode
    ep = ref_compat_legacy(capacity=32, ref_compat=False,
                           dtype=jnp.float32)
    rp = RansacParams(line_consensus=60, bearing_window_deg=15.0,
                      wall_search_timeout=4, table_capacity=64,
                      promote_count=5, ref_compat=False, dtype=jnp.float32)

    state = init_state(ep)
    table = ransac.init_table(rp)
    key = jax.random.PRNGKey(1)
    old_odom = np.asarray(traj.odom[0])

    # jit the pure kernels once — the functional API stays explicit, the
    # compilation is per-function, not per-tick
    predict = jax.jit(lambda s, u: ekf.predict(s, u, ep))
    extract = jax.jit(lambda t, r, x, n, k: ransac.extract(
        t, scan_from_ranges(r, traj.beam_angles), x, n, k, rp, ep.max_obs))
    measure = jax.jit(lambda s, o, u: ekf.measure(s, o, u, ep))

    # the inlined loop (SLAM_ransac.m:24-100), functional style
    for t in range(T):
        od = np.asarray(traj.odom[t])
        u = jnp.asarray([np.hypot(od[0] - old_odom[0], od[1] - old_odom[1]),
                         float(angdiff_deg(old_odom[2], od[2]))], jnp.float32)
        old_odom = od

        state = predict(state, u)                             # :74
        key, sub = jax.random.split(key)
        obs, table = extract(table, traj.ranges[t], state.x,
                             state.n_active, sub)             # :81
        state = measure(state, obs, u)                        # :96-99

    est = np.asarray(state.x[:3])
    truth = np.asarray(traj.truth[-1])
    print(f"final pose est {est.round(3)} vs truth {truth.round(3)}  "
          f"({int(state.n_active)} landmarks)")


if __name__ == "__main__":
    main()
