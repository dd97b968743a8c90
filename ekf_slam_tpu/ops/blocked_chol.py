"""Blocked right-looking Cholesky: O(D³) factorization at matmul rate.

A Cholesky's panel recursion is sequential; at large D (≈20k inside
`sr_recompress` at 10k landmarks) whether it runs near matmul rate
decides whether triangular square-root filtering is affordable at all
(the conditioning story the reference's (I−KH)·P form at
EKF_SLAM_UC.m:146 needs most at that scale).

This module restructures the factorization so that all O(D³) work is
plain GEMMs and only O(D·b²) runs through XLA's sequential kernels:

    for each panel k (width b, statically unrolled under jit):
        L_kk   = chol(A_kk)                       # b×b XLA chol
        L_kk⁻¹ = trsm(L_kk, I_b)                  # ONE b×b trsm
        L_col  = A[k+1:, k] @ L_kk⁻ᵀ              # GEMM  (panel solve)
        A[k+1:, k+1:] −= L_col @ L_colᵀ           # GEMM  (trailing syrk)

The explicit b×b inverse + GEMM in place of a D-wide triangular solve is
the same scheduling choice as models/batched.py's Cholesky-inverse gain.

Used by: models/srekf_fast.sr_recompress (factor reclamation),
models/srekf.factor_from_state at scale, and the round-4 panel update
(models/srekf.sr_update_panel) that makes a per-update triangular factor
viable at 10k landmarks.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax


@functools.partial(jax.jit, static_argnames=("block",))
def tri_inv_blocked(L: jnp.ndarray, block: int = 512) -> jnp.ndarray:
    """L⁻¹ for lower-triangular L with the O(d³) work as GEMMs.

    Recursive 2×2 block partition: inv([[A,0],[B,C]]) =
    [[A⁻¹,0],[−C⁻¹·B·A⁻¹, C⁻¹]] — only ≤``block``-sized trsms remain,
    so no triangular solve runs against a wide right-hand side."""
    d = L.shape[0]
    if d <= block:
        return lax.linalg.triangular_solve(
            L, jnp.eye(d, dtype=L.dtype), left_side=True, lower=True)
    h = max(block, ((d // 2) // block) * block)
    A, B, C = L[:h, :h], L[h:, :h], L[h:, h:]
    Ai = tri_inv_blocked(A, block=block)
    Ci = tri_inv_blocked(C, block=block)
    low = -Ci @ (B @ Ai)
    top = jnp.concatenate([Ai, jnp.zeros((h, d - h), L.dtype)], axis=1)
    return jnp.concatenate([top, jnp.concatenate([low, Ci], axis=1)],
                           axis=0)


@functools.partial(jax.jit, static_argnames=("block",))
def chol_blocked(A: jnp.ndarray, block: int = 512) -> jnp.ndarray:
    """Lower Cholesky factor of symmetric positive-definite ``A``.

    Exact same math as `jnp.linalg.cholesky` (matches to fp round-off,
    tests/test_blocked_chol.py); the panel count D/``block`` is a static
    Python loop so every GEMM has a fixed shape.  The input's lower
    triangle is the one read (like LAPACK potrf); the output's strict
    upper triangle is exactly zero.
    """
    D = A.shape[0]
    if D <= min(block, 512):
        return jnp.linalg.cholesky(A)
    if D <= block:
        # recursive panel: a large diagonal block factors through the
        # same GEMM-dominated scheme at block 512 (XLA's chol of a
        # 1024-2048 panel is itself panel-sequential)
        return chol_blocked(A, block=512)
    dt = A.dtype
    cols = []                       # finished [D-k0, b] column panels
    trail = A                       # trailing Schur complement, shrinking
    for k0 in range(0, D, block):
        b = min(block, D - k0)
        Akk = trail[:b, :b]
        Lkk = (jnp.linalg.cholesky(Akk) if b <= 512
               else chol_blocked(Akk, block=512))
        if k0 + b >= D:
            cols.append(Lkk)
            break
        Lkk_inv = tri_inv_blocked(Lkk)
        Lcol = trail[b:, :b] @ Lkk_inv.T              # [D-k0-b, b] GEMM
        cols.append(jnp.concatenate([Lkk, Lcol], axis=0))
        trail = trail[b:, b:] - jnp.matmul(
            Lcol, Lcol.T, preferred_element_type=dt)  # trailing syrk GEMM
    # assemble: panel k occupies rows k0:D of column block k0:k0+b
    L = jnp.zeros((D, D), dt)
    k0 = 0
    for c in cols:
        L = L.at[k0:, k0:k0 + c.shape[1]].set(c)
        k0 += c.shape[1]
    return L


def chol_for_state(P: jnp.ndarray, n_active, block: int = 1024
                   ) -> jnp.ndarray:
    """Cholesky of a filter covariance whose rows/cols beyond the active
    block (3+2·n_active) are zero: augment the inactive diagonal with 1
    so the factorization is well-defined, factor, and zero the inactive
    rows back out — the same construction as srekf.factor_from_state,
    with the blocked kernel."""
    D = P.shape[0]
    rng = jnp.arange(D)
    act = rng < 3 + 2 * n_active
    aug = jnp.where(act, jnp.zeros((D,), P.dtype), jnp.ones((D,), P.dtype))
    # O(D) diagonal scatter — adding jnp.diag(aug) would stream the full
    # D² matrix twice just to touch D elements (~20 ms at D=20k)
    L = chol_blocked(P.at[rng, rng].add(aug), block=block)
    return L * act[:, None].astype(P.dtype)
