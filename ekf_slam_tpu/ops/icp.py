"""Scan matching: fixed-iteration 2-D point-to-point ICP under jit.

Supplies the loop-closure *measurement* the submap layer needs
(parallel/submaps.py): given two scans' world points in their own submap
frames and an initial guess, estimate the relative rigid transform.  No
reference analog — the reference has no loop closure at all (SURVEY.md §5).

Shape discipline: fixed iteration count (lax.scan), brute-force [N,M]
nearest-neighbor distances (a single fused distance matrix — no KD trees,
no data-dependent shapes), masked correspondence rejection, closed-form 2-D
Procrustes per iteration (no SVD: the optimal rotation angle is
atan2(Σ cross, Σ dot) of the centered correspondence pairs).
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax

from .angles import cosd, sind, wrap_to_180


class ICPResult(NamedTuple):
    pose: jnp.ndarray       # f[3] (tx, ty, theta_deg): dst ≈ R(theta)·src + t
    rmse: jnp.ndarray       # f    inlier RMS distance after alignment
    n_inliers: jnp.ndarray  # i32  matched pairs within the threshold


def _rotate(c, s, x, y):
    """(c·x − s·y, s·x + c·y), elementwise: the 2-D rotations here stay
    exact f32 instead of running as tiny matmuls at the backend's default
    precision (TF32 on a GPU, whose rounding biases every tick's
    estimated heading)."""
    return c * x - s * y, s * x + c * y


def _transform(pts: jnp.ndarray, pose: jnp.ndarray) -> jnp.ndarray:
    x, y = _rotate(cosd(pose[2]), sind(pose[2]), pts[:, 0], pts[:, 1])
    return jnp.stack([x + pose[0], y + pose[1]], axis=-1)


def icp(src: jnp.ndarray, src_valid: jnp.ndarray, dst: jnp.ndarray,
        dst_valid: jnp.ndarray, init_pose=None, iters: int = 20,
        max_pair_dist: float = 0.75) -> ICPResult:
    """Align ``src`` onto ``dst``: returns pose with dst ≈ T(pose)·src.

    src [N,2] / dst [M,2] with validity masks (fixed shapes, padded)."""
    dt = src.dtype
    if init_pose is None:
        init_pose = jnp.zeros((3,), dt)
    init_pose = jnp.asarray(init_pose, dt)

    big = jnp.asarray(1e9, dt)

    def step(pose, _):
        cur = _transform(src, pose)                        # [N,2]
        d2 = jnp.sum((cur[:, None, :] - dst[None, :, :]) ** 2, -1)
        d2 = jnp.where(dst_valid[None, :], d2, big)
        nn = jnp.argmin(d2, axis=1)                        # [N]
        nnd = jnp.sqrt(jnp.take_along_axis(d2, nn[:, None], 1)[:, 0])
        w = (src_valid & (nnd < max_pair_dist)).astype(dt)  # [N]
        tgt = dst[nn]                                      # [N,2]

        n = jnp.maximum(jnp.sum(w), 1.0)
        mu_s = jnp.sum(cur * w[:, None], 0) / n
        mu_t = jnp.sum(tgt * w[:, None], 0) / n
        cs = cur - mu_s
        ct = tgt - mu_t
        # optimal rotation: atan2 of summed cross/dot products
        num = jnp.sum(w * (cs[:, 0] * ct[:, 1] - cs[:, 1] * ct[:, 0]))
        den = jnp.sum(w * (cs[:, 0] * ct[:, 0] + cs[:, 1] * ct[:, 1]))
        dth = jnp.rad2deg(jnp.arctan2(num, den))
        c, s = cosd(dth), sind(dth)
        t = mu_t - jnp.stack(_rotate(c, s, mu_s[0], mu_s[1]))

        # compose the increment onto the running pose
        new_t = jnp.stack(_rotate(c, s, pose[0], pose[1])) + t
        new_pose = jnp.concatenate(
            [new_t, wrap_to_180(pose[2] + dth)[None]])
        return new_pose.astype(dt), None

    pose, _ = lax.scan(step, init_pose, None, length=iters)

    # final inlier stats
    cur = _transform(src, pose)
    d2 = jnp.sum((cur[:, None, :] - dst[None, :, :]) ** 2, -1)
    d2 = jnp.where(dst_valid[None, :], d2, big)
    nnd = jnp.sqrt(jnp.min(d2, axis=1))
    inl = src_valid & (nnd < max_pair_dist)
    n = jnp.maximum(jnp.sum(inl), 1)
    rmse = jnp.sqrt(jnp.sum(jnp.where(inl, nnd * nnd, 0.0)) / n)
    return ICPResult(pose=pose, rmse=rmse,
                     n_inliers=jnp.sum(inl).astype(jnp.int32))
