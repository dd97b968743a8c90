"""Occupancy-grid mapping — the reference's sketched-but-dead map path.

SLAM.m:118-124 transforms scans into a world frame with a hard-coded +12.5
grid offset and calls ``setOccupancy`` — commented out and non-functional.
This module provides the real thing: a log-odds occupancy grid
updated from (pose, scan) wholly on device.

Design: no Bresenham (data-dependent loop lengths don't jit).  Each beam is
sampled at S fixed fractions of its measured range; samples before the hit
mark free space, the endpoint marks occupied.  All beams × samples become
one flat scatter-add of log-odds increments — a single fused update per
scan.  Cells saturate at ±clamp (standard log-odds bounds).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .angles import cosd, sind
from .scan import Scan


class OccupancyGrid(NamedTuple):
    """Log-odds grid: ``logodds[i, j]`` covers the cell with world x in
    ``origin[0] + [j, j+1) * resolution`` (x → columns, y → rows)."""
    logodds: jnp.ndarray   # f[H, W]
    origin: jnp.ndarray    # f[2] world position of cell (0, 0)'s corner
    resolution: float      # meters per cell


def init_grid(width: int, height: int, resolution: float,
              origin=(0.0, 0.0), dtype=jnp.float32) -> OccupancyGrid:
    """The reference's +12.5 offset (SLAM.m:120) was an ad-hoc world→grid
    shift; here the grid origin is explicit configuration."""
    return OccupancyGrid(
        logodds=jnp.zeros((height, width), dtype),
        origin=jnp.asarray(origin, dtype),
        resolution=float(resolution),
    )


def update_grid(grid: OccupancyGrid, scan: Scan, pose: jnp.ndarray,
                n_samples: int = 64, l_free: float = -0.4,
                l_occ: float = 2.0, clamp: float = 10.0) -> OccupancyGrid:
    """Fuse one scan at ``pose`` into the grid (one fused scatter-add)."""
    H, W = grid.logodds.shape
    res = grid.resolution
    th = pose[2]

    r = jnp.where(scan.valid, scan.ranges, 0.0)
    wa = scan.angles_deg + th
    dirx, diry = cosd(wa), sind(wa)                      # [B]

    # free-space samples at fixed fractions of each ray (endpoint excluded)
    frac = (jnp.arange(n_samples) + 0.5) / (n_samples + 1)   # (0,1)
    sx = pose[0] + r[:, None] * frac[None, :] * dirx[:, None]  # [B,S]
    sy = pose[1] + r[:, None] * frac[None, :] * diry[:, None]
    # endpoint (occupied)
    ex = pose[0] + r * dirx
    ey = pose[1] + r * diry

    def to_idx(x, y):
        j = jnp.floor((x - grid.origin[0]) / res).astype(jnp.int32)
        i = jnp.floor((y - grid.origin[1]) / res).astype(jnp.int32)
        ok = (i >= 0) & (i < H) & (j >= 0) & (j < W)
        return jnp.where(ok, i, 0), jnp.where(ok, j, 0), ok

    fi, fj, fok = to_idx(sx.reshape(-1), sy.reshape(-1))
    oi, oj, ook = to_idx(ex, ey)
    fok = fok & jnp.repeat(scan.valid, n_samples)
    ook = ook & scan.valid

    dt = grid.logodds.dtype
    lo = grid.logodds
    lo = lo.at[fi, fj].add(jnp.where(fok, jnp.asarray(l_free, dt), 0.0))
    lo = lo.at[oi, oj].add(jnp.where(ook, jnp.asarray(l_occ, dt), 0.0))
    lo = jnp.clip(lo, -clamp, clamp)
    return grid._replace(logodds=lo)


def occupancy_probability(grid: OccupancyGrid) -> jnp.ndarray:
    """P(occupied) per cell from log-odds."""
    return jax.nn.sigmoid(grid.logodds)


def map_session(grid: OccupancyGrid, poses: jnp.ndarray,
                ranges: jnp.ndarray, beam_angles: jnp.ndarray,
                n_samples: int = 64) -> OccupancyGrid:
    """Fuse a whole trajectory's scans as one lax.scan device program
    (poses [T,3], ranges [T,B])."""
    from .scan import scan_from_ranges

    def body(g, inp):
        pose, rng = inp
        return update_grid(g, scan_from_ranges(rng, beam_angles), pose,
                           n_samples=n_samples), None

    grid, _ = jax.lax.scan(body, grid, (poses, ranges))
    return grid
