"""Minimal functional-API walkthrough — the runnable version of the
reference's dead API sketch (example.m, which references an undefined
handle at example.m:7 and cannot execute).

Drives predict/append/update directly with hand-made measurements of known
landmarks (BASELINE.json config 1: ~20 known-correspondence landmarks,
single-chip dense EKF).
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax.numpy as jnp
import numpy as np

from ekf_slam_tpu.config import EKFParams
from ekf_slam_tpu.models import ekf
from ekf_slam_tpu.ops.observations import obs_from_rows
from ekf_slam_tpu.state import init_state


def main():
    from ekf_slam_tpu.utils.runtime import enable_compile_cache
    enable_compile_cache()
    rng = np.random.default_rng(0)
    params = EKFParams(capacity=32, max_obs=8, association="known",
                       ref_compat=False, dtype=jnp.float32)
    state = init_state(params)

    landmarks = rng.uniform(-5, 5, (20, 2))
    pose = np.zeros(3)

    for t in range(100):
        u = np.array([0.05, 2.0])
        # ground truth motion (same unicycle model)
        th = pose[2]
        pose = pose + np.array([
            u[0] * np.cos(np.deg2rad(th + u[1])),
            u[0] * np.sin(np.deg2rad(th + u[1])), u[1]])
        pose[2] = np.mod(pose[2], 360.0)

        state = ekf.predict(state, jnp.asarray(u, jnp.float32), params)

        # observe the 4 nearest landmarks with id = landmark number
        d = landmarks - pose[:2]
        dist = np.hypot(d[:, 0], d[:, 1])
        near = np.argsort(dist)[:4]
        rows, locs = [], []
        for i in near:
            r = dist[i] + rng.normal(0, 0.01)
            b = np.mod(np.rad2deg(np.arctan2(d[i, 1], d[i, 0])) - pose[2],
                       360.0)
            rows.append([r, b, i + 1])
            locs.append(landmarks[i])
        obs = obs_from_rows(rows, locs, params.max_obs, jnp.float32)
        state = ekf.measure(state, obs, jnp.asarray(u, jnp.float32), params)

    est = np.asarray(state.x[:3])
    err = np.linalg.norm(est[:2] - pose[:2])
    print(f"after 100 ticks: {int(state.n_active)} landmarks, "
          f"pose error {err:.3f} m (odometry-only would drift unboundedly)")
    lm_err = []
    for k in range(int(state.n_active)):
        lm_est = np.asarray(state.x[3 + 2 * k:5 + 2 * k])
        sig = int(np.asarray(state.sig[k]))
        lm_err.append(np.linalg.norm(lm_est - landmarks[sig - 1]))
    print(f"mean landmark error: {np.mean(lm_err):.3f} m over "
          f"{len(lm_err)} landmarks")


if __name__ == "__main__":
    main()
