"""Fixed-capacity, jit-stable SLAM filter state.

The reference grows its joint state by concatenation on every new landmark
(EKF_SLAM.m:79 ``h.x=[h.x, lx, ly]``, :91-97 covariance block growth), so every
shape is dynamic.  Under jit that would force a recompile per landmark; instead
the state is padded to a fixed capacity K and "append" becomes a masked write
(SURVEY.md §7).  The whole filter state is one pytree, which also makes
checkpoint/resume (utils/checkpointing.py) a single serialization.

Layout: ``x = [xr, yr, theta_deg, l0x, l0y, l1x, l1y, ...]`` with
``D = 3 + 2K``; landmark slot ``k`` occupies state rows ``3+2k : 5+2k``.
Inactive slots hold zeros in ``x`` and zero rows/cols in ``P`` so sparse
updates touching them are automatic no-ops.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .config import EKFParams


class FilterState(NamedTuple):
    """Joint robot+landmark EKF state (one pytree).

    Mirrors the reference's ``h.x`` / ``h.P`` / ``h.s`` properties
    (EKF_SLAM.m:6-9) plus the explicit active-mask bookkeeping that the
    reference encodes implicitly in array length.
    """

    x: jnp.ndarray        # f[D]      joint mean, theta in degrees at x[2]
    P: jnp.ndarray        # f[D, D]   joint covariance (dense, padded)
    sig: jnp.ndarray      # f[K]      landmark signatures (EKF_SLAM.m:9)
    active: jnp.ndarray   # bool[K]   slot occupied
    n_active: jnp.ndarray  # i32 ()   number of active landmarks

    @property
    def capacity(self) -> int:
        return self.sig.shape[0]

    @property
    def dim(self) -> int:
        return self.x.shape[0]

    @property
    def pose(self) -> jnp.ndarray:
        """Robot pose [x, y, theta_deg]."""
        return self.x[:3]

    @property
    def landmarks(self) -> jnp.ndarray:
        """Landmark positions as f[K, 2] (padded; see ``active``).

        Sliced by capacity, not to the end: ``dim`` may exceed 3+2K when the
        state is padded for even sharding over a device mesh."""
        K = self.capacity
        return self.x[3:3 + 2 * K].reshape(K, 2)


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def init_state(params: EKFParams, pad_to_multiple_of: int = 1,
               extra_dims: int = 0) -> FilterState:
    """Initial state: origin pose, P = 0.1*I on the pose block
    (EKF_SLAM.m:28-31), empty landmark set.

    ``pad_to_multiple_of``: round the joint dimension D up so covariance
    row-tiles divide evenly over a device mesh (D = 3+2K is odd, so sharded
    runs always need padding).  Extra rows are permanent zeros — every
    filter op is already masked by capacity/active.

    ``extra_dims``: append this many extra zero dims beyond 3+2K.  Used by
    the fast square-root filter (models/srekf_fast.py) as a process-noise
    column buffer: slot math never touches dims ≥ 3+2K, so those columns
    of the factor are guaranteed zero until a predict deposits √c·w there."""
    D, K = params.dim + extra_dims, params.capacity
    D = round_up(D, pad_to_multiple_of)
    dt = params.dtype
    cdt = params.cov_dt
    x = jnp.zeros((D,), dt)
    P = jnp.zeros((D, D), cdt).at[jnp.arange(3), jnp.arange(3)].set(
        jnp.asarray(params.p0_diag, cdt))
    return FilterState(
        x=x,
        P=P,
        sig=jnp.zeros((K,), dt),
        active=jnp.zeros((K,), bool),
        n_active=jnp.zeros((), jnp.int32),
    )


def lm_slice_index(k) -> jnp.ndarray:
    """State row of landmark slot k (0-based): 3 + 2k."""
    return 3 + 2 * k
