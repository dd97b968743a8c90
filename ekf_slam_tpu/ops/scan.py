"""Laser-scan geometry: polar beams → cartesian → world frame.

Replaces the ROS ``readCartesian`` + rotation seam (RANSAC.m:100-106,
SLAM.m:118-121).  A scan is a fixed-length beam grid with a validity mask —
the reference instead deletes NaN returns in place (RANSAC.m:96-97), which
would make every shape dynamic under jit.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .angles import cosd, sind


class Scan(NamedTuple):
    """One laser scan: ``ranges[i]`` along robot-frame bearing
    ``angles_deg[i]``; ``valid`` marks real returns (finite, in-range)."""

    ranges: jnp.ndarray      # f[B]
    angles_deg: jnp.ndarray  # f[B]
    valid: jnp.ndarray       # bool[B]


def scan_from_ranges(ranges: jnp.ndarray, angles_deg: jnp.ndarray) -> Scan:
    """Mask NaN/inf/non-positive returns (the reference's NaN strip,
    RANSAC.m:96-97)."""
    valid = jnp.isfinite(ranges) & (ranges > 0)
    return Scan(ranges=jnp.where(valid, ranges, 0.0),
                angles_deg=angles_deg, valid=valid)


def to_cartesian(scan: Scan) -> jnp.ndarray:
    """Robot-frame cartesian points [B,2] (ROS readCartesian equivalent)."""
    return jnp.stack([scan.ranges * cosd(scan.angles_deg),
                      scan.ranges * sind(scan.angles_deg)], axis=-1)


def to_world(points_local: jnp.ndarray, pose: jnp.ndarray) -> jnp.ndarray:
    """Rigid transform into the world frame (RANSAC.m:103-106):
    rot(theta_deg) · p + [x, y], written elementwise — a [B,2]×[2,2]
    matmul would run at the backend's default matmul precision (TF32 on
    a GPU), rounding every world point and biasing the rotation."""
    th = pose[2]
    c, s = cosd(th), sind(th)
    x, y = points_local[:, 0], points_local[:, 1]
    return jnp.stack([c * x - s * y + pose[0], s * x + c * y + pose[1]],
                     axis=-1)


def scan_to_world(scan: Scan, pose: jnp.ndarray) -> jnp.ndarray:
    return to_world(to_cartesian(scan), pose)
