"""Batched data association (maximum-likelihood gating).

The reference loops over every landmark per observation, building a dense
5×(3+2N) projection and a full H·P·Hᵀ inside the loop
(Correspondence.m:49-87) — O(N³) per observation worst case.  Here the gate
is computed for **all K landmark slots at once**: Φ_k only touches P's pose
block, the pose↔landmark strip, and the per-landmark 2×2 diagonal blocks, so
the whole gate is a handful of batched [K,2,·] contractions — O(K) work and
one strip read of P.

Shipped-reference behavior: the Mahalanobis position cost is computed and
then **discarded** — only the signature cost is used (Correspondence.m:69-75).
``params.association`` selects signature-only (ref-compat) or the full ML
gate the machinery was built for.
"""
from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from ..config import ASSOC_ML, ASSOC_ML_UNIQUE, EKFParams
from .angles import atan2d, wrap_to_180, wrap_to_360


def _exclusive(is_new: jnp.ndarray, slot: jnp.ndarray,
               best_cost: jnp.ndarray, K: int
               ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Batch-level mutual exclusion (association='ml_unique'): each slot
    accepts only its lowest-cost claimant.  Two parallel scatter-mins —
    no sequential assignment loop, any batch size.  Ties break to the
    lowest observation index (deterministic, matching argmin's
    first-occurrence rule).

    Returns (is_new, slot, losers): an out-claimed observation comes back
    is_new=True — so downstream append paths turn it into a NEW landmark
    (params.ml_losers='append', the default) — with the ``losers`` mask
    identifying exactly those rows so callers can instead invalidate them
    for the batch (ml_losers='drop')."""
    M = slot.shape[0]
    inf = jnp.asarray(jnp.inf, best_cost.dtype)
    claim = jnp.where(is_new, inf, best_cost)                   # [M]
    claimed = jnp.full((K,), inf, best_cost.dtype).at[slot].min(claim)
    midx = jnp.where(~is_new & (claim == claimed[slot]),
                     jnp.arange(M), M)
    claimed_m = jnp.full((K,), M, jnp.int32).at[slot].min(
        midx.astype(jnp.int32))
    winner = ~is_new & (jnp.arange(M) == claimed_m[slot])
    losers = ~is_new & ~winner
    return ~winner, slot, losers


def _lm_diag_blocks(P: jnp.ndarray, K: int) -> jnp.ndarray:
    """Per-landmark 2×2 diagonal blocks of P as [K,2,2].

    Extracted via three diagonal strips + stride-2 slices: strided slices
    of contiguous diagonals, where the natural advanced-indexing block
    gather would be a scattered read of 4K elements."""
    end = 3 + 2 * K
    d0 = jnp.diagonal(P)
    d1 = jnp.diagonal(P, 1)
    dm = jnp.diagonal(P, -1)
    p00, p11 = d0[3:end:2], d0[4:end:2]
    p01, p10 = d1[3:end:2], dm[3:end:2]
    return jnp.stack([jnp.stack([p00, p01], -1),
                      jnp.stack([p10, p11], -1)], axis=1)


def _phi_base(A: jnp.ndarray, B: jnp.ndarray, Prr: jnp.ndarray,
              Prl: jnp.ndarray, Pll: jnp.ndarray) -> jnp.ndarray:
    """Φ0_k = A·Prr·Aᵀ + A·Prl·Bᵀ + B·Prlᵀ·Aᵀ + B·Pll·Bᵀ as [K,2,2].

    Fully unrolled over the tiny (2,3) dims: ~60 [K]-vector mul-adds that
    XLA fuses into one elementwise pass.  Batched 2×3 matmuls would be
    padded onto matrix-unit tiles — far more work for the same math."""
    K = A.shape[0]

    def accum(i, j):
        # A Prr Aᵀ
        s = sum(A[:, i, p] * Prr[p, q] * A[:, j, q]
                for p in range(3) for q in range(3))
        # A Prl Bᵀ + B Prlᵀ Aᵀ
        s = s + sum(A[:, i, p] * Prl[:, p, q] * B[:, j, q]
                    for p in range(3) for q in range(2))
        s = s + sum(B[:, i, p] * Prl[:, q, p] * A[:, j, q]
                    for p in range(2) for q in range(3))
        # B Pll Bᵀ
        s = s + sum(B[:, i, p] * Pll[:, p, q] * B[:, j, q]
                    for p in range(2) for q in range(2))
        return s

    return jnp.stack([
        jnp.stack([accum(0, 0), accum(0, 1)], axis=-1),
        jnp.stack([accum(1, 0), accum(1, 1)], axis=-1),
    ], axis=1)


def gate_costs(state, z: jnp.ndarray, R2: jnp.ndarray, params: EKFParams
               ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-slot (position_cost, signature_cost) against measurement z.

    Vectorizes Correspondence.m:49-75 over all K slots.  Inactive slots are
    masked to +inf by the caller via ``state.active``."""
    x, P = state.x, state.P
    K = state.capacity
    th = x[2]

    lm = state.landmarks                       # [K,2]
    delta = lm - x[:2]                         # [K,2]
    q = jnp.sum(delta * delta, axis=-1)        # [K]
    q = jnp.where(q == 0, jnp.ones_like(q), q)  # guard empty slots
    sq = jnp.sqrt(q)
    dx, dy = delta[:, 0], delta[:, 1]

    zhat_r = sq
    zhat_phi = wrap_to_360(atan2d(dy, dx) - th)
    nu = jnp.stack([z[0] - zhat_r, z[1] - zhat_phi], axis=-1)   # [K,2]
    if not params.ref_compat:
        nu = nu.at[:, 1].set(wrap_to_180(nu[:, 1]))

    zero = jnp.zeros_like(q)
    # H_k = [A_k | B_k] over (pose, landmark_k)  (Correspondence.m:62-63)
    A = jnp.stack([
        jnp.stack([-sq * dx, -sq * dy, zero], axis=-1),
        jnp.stack([dy, -dx, -q], axis=-1),
    ], axis=1) / q[:, None, None]              # [K,2,3]
    B = jnp.stack([
        jnp.stack([sq * dx, sq * dy], axis=-1),
        jnp.stack([-dy, dx], axis=-1),
    ], axis=1) / q[:, None, None]              # [K,2,2]

    Prr = P[:3, :3]                            # [3,3]
    end = 3 + 2 * K                            # may be < dim if padded
    Prl = P[:3, 3:end].reshape(3, K, 2).transpose(1, 0, 2)     # [K,3,2]
    Pll = _lm_diag_blocks(P, K)                                # [K,2,2]

    Phi = _phi_base(A, B, Prr, Prl, Pll) + R2[None].astype(x.dtype)

    n0, n1 = nu[:, 0], nu[:, 1]
    if params.noise_model == "fit":
        # stable Cholesky form for the anisotropic fit-propagated R
        # (see batch_costs — the det form cancels in f32)
        tiny = jnp.asarray(jnp.finfo(x.dtype).tiny, x.dtype)
        l00 = jnp.sqrt(jnp.maximum(Phi[:, 0, 0], tiny))
        l10 = Phi[:, 1, 0] / l00
        l11 = jnp.sqrt(jnp.maximum(Phi[:, 1, 1] - l10 * l10, tiny))
        y0 = n0 / l00
        y1 = (n1 - l10 * y0) / l11
        position_cost = y0 * y0 + y1 * y1
    else:
        # batched 2x2 solve: position_cost = nu' Phi^-1 nu
        # (Correspondence.m:69)
        det = (Phi[:, 0, 0] * Phi[:, 1, 1] - Phi[:, 0, 1] * Phi[:, 1, 0])
        inv00, inv11 = Phi[:, 1, 1] / det, Phi[:, 0, 0] / det
        inv01, inv10 = -Phi[:, 0, 1] / det, -Phi[:, 1, 0] / det
        position_cost = (n0 * (inv00 * n0 + inv01 * n1)
                         + n1 * (inv10 * n0 + inv11 * n1))

    sc = jnp.asarray(params.s_cost, x.dtype)
    signature_cost = (z[2] - state.sig) ** 2 / sc              # Corresp.m:71
    return position_cost, signature_cost


def batch_costs(state, zs: jnp.ndarray, Rs: jnp.ndarray, params: EKFParams,
                strips=None) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """The [M,K] gate cost planes: (position_cost, signature_cost).

    position_cost[m,k] = ν'Φ⁻¹ν of observation m against slot k — the
    per-observation NIS (normalized innovation squared) when evaluated at
    the associated slot, which is how utils/metrics-style consistency
    reporting consumes it (SlamSession(collect_nis=True)).

    The innovation covariance splits as Φ_mk = Φ0_k + R_m: the
    P-dependent base Φ0 is assembled ONCE from P's pose strip and
    landmark-diagonal blocks, then each measurement adds its own R in
    rank-1 broadcast form — every intermediate is a single [M,K] plane
    (the naive [M,K,2,2] Φ tensor costs 4× the memory traffic and the
    gate is bandwidth-bound)."""
    x, P = state.x, state.P
    K = state.capacity
    th = x[2]

    lm = state.landmarks
    delta = lm - x[:2]
    q = jnp.sum(delta * delta, axis=-1)
    q = jnp.where(q == 0, jnp.ones_like(q), q)
    sq = jnp.sqrt(q)
    dx, dy = delta[:, 0], delta[:, 1]

    zhat_r = sq
    zhat_phi = wrap_to_360(atan2d(dy, dx) - th)
    n0 = zs[:, 0:1] - zhat_r[None, :]                            # [M,K]
    n1 = zs[:, 1:2] - zhat_phi[None, :]                          # [M,K]
    if not params.ref_compat:
        n1 = wrap_to_180(n1)

    zero = jnp.zeros_like(q)
    A = jnp.stack([
        jnp.stack([-sq * dx, -sq * dy, zero], axis=-1),
        jnp.stack([dy, -dx, -q], axis=-1),
    ], axis=1) / q[:, None, None]
    B = jnp.stack([
        jnp.stack([sq * dx, sq * dy], axis=-1),
        jnp.stack([-dy, dx], axis=-1),
    ], axis=1) / q[:, None, None]

    if strips is None:
        Prr = P[:3, :3]
        end = 3 + 2 * K
        Prl = P[:3, 3:end].reshape(3, K, 2).transpose(1, 0, 2)
        Pll = _lm_diag_blocks(P, K)
    else:
        Prr, Prl, Pll = strips

    Phi0 = _phi_base(A, B, Prr, Prl, Pll)                        # [K,2,2]

    Rt = Rs.astype(x.dtype)
    s00 = Phi0[None, :, 0, 0] + Rt[:, None, 0, 0]                # [M,K]
    s11 = Phi0[None, :, 1, 1] + Rt[:, None, 1, 1]
    s01 = Phi0[None, :, 0, 1] + Rt[:, None, 0, 1]
    s10 = Phi0[None, :, 1, 0] + Rt[:, None, 1, 0]
    if params.noise_model == "fit":
        # Cholesky-form evaluation: the fit-propagated R is strongly
        # anisotropic (condition ~1e6), and the adjugate/det form below
        # cancels catastrophically in f32 (negative "NIS" observed on
        # chip).  ν'Φ⁻¹ν = ‖L⁻¹ν‖² via 2×2 forward substitution is
        # stable for any PSD Φ.  Static branch: the tuned headline
        # schedules (scaled/constant R) keep the cheaper det form.
        tiny = jnp.asarray(jnp.finfo(x.dtype).tiny, x.dtype)
        l00 = jnp.sqrt(jnp.maximum(s00, tiny))
        l10 = s10 / l00
        l11 = jnp.sqrt(jnp.maximum(s11 - l10 * l10, tiny))
        y0 = n0 / l00
        y1 = (n1 - l10 * y0) / l11
        position_cost = y0 * y0 + y1 * y1
    else:
        det = s00 * s11 - s01 * s10
        position_cost = (n0 * (s11 * n0 - s01 * n1)
                         + n1 * (-s10 * n0 + s00 * n1)) / det    # [M,K]

    sc = jnp.asarray(params.s_cost, x.dtype)
    signature_cost = (zs[:, 2:3] - state.sig[None, :]) ** 2 / sc  # [M,K]
    return position_cost, signature_cost


def gate_batch(state, zs: jnp.ndarray, Rs: jnp.ndarray, params: EKFParams,
               strips=None, return_losers: bool = False
               ) -> Tuple[jnp.ndarray, ...]:
    """Associate M measurements at once: (is_new [M], slot [M]).

    ``return_losers``: additionally return the bool[M] mask of
    observations that gated onto a slot but LOST it to a lower-cost
    claimant under association='ml_unique' (all-False in other modes) —
    by default such losers come back is_new=True and downstream appends
    turn each into a new landmark (see EKFParams.ml_losers).

    ``strips``: optional precomputed (Prr [3,3], Prl [K,3,2], Pll [K,2,2])
    in place of reading them from ``state.P`` — used by the square-root
    filter (models/srekf.sr_strips), where P is stored as its Cholesky
    factor and the strips come from the factor directly.

    The innovation covariance splits as Φ_mk = Φ_k + R_m: the P-dependent
    base Φ_k is assembled ONCE from P's pose strip and landmark-diagonal
    blocks, then each measurement adds its own R and evaluates its costs —
    so the per-measurement work is O(K) elementwise with no extra reads of
    P.  This is the fast path behind models/batched.measure_batched; the
    scalar ``gate`` keeps the reference's one-at-a-time semantics."""
    position_cost, signature_cost = batch_costs(state, zs, Rs, params,
                                                strips=strips)
    x = state.x
    K = state.capacity

    if params.association in (ASSOC_ML, ASSOC_ML_UNIQUE):
        cost = position_cost + signature_cost
    else:
        cost = signature_cost
    inf = jnp.asarray(jnp.inf, cost.dtype)
    cost = jnp.where(state.active[None, :], cost, inf)
    passes = cost <= jnp.asarray(params.s_thresh, cost.dtype)
    is_new = jnp.logical_not(jnp.any(passes, axis=1))
    slot = jnp.argmin(jnp.where(passes, cost, inf), axis=1).astype(jnp.int32)
    if params.association == ASSOC_ML_UNIQUE:
        best = jnp.take_along_axis(cost, slot[:, None], 1)[:, 0]
        out = _exclusive(is_new, slot, best, K)
        return out if return_losers else out[:2]
    if return_losers:
        return is_new, slot, jnp.zeros_like(is_new)
    return is_new, slot


def gate(state, z: jnp.ndarray, R2: jnp.ndarray, params: EKFParams
         ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Associate measurement z: returns (is_new, slot, cost_vector).

    Mirrors the accept logic at Correspondence.m:78-86: a slot associates iff
    its cost ≤ s_thresh; among passing slots the first minimum wins
    (jnp.argmin = first occurrence, matching the strict-< update rule)."""
    position_cost, signature_cost = gate_costs(state, z, R2, params)
    if params.association in (ASSOC_ML, ASSOC_ML_UNIQUE):
        # the intent the reference commented out (Correspondence.m:74);
        # ml_unique's exclusion is a batch concept — one observation at a
        # time gates identically to plain ML
        cost = position_cost + signature_cost
    else:
        cost = signature_cost                  # shipped behavior (:75)
    inf = jnp.asarray(jnp.inf, cost.dtype)
    cost = jnp.where(state.active, cost, inf)
    passes = cost <= jnp.asarray(params.s_thresh, cost.dtype)
    is_new = jnp.logical_not(jnp.any(passes))
    slot = jnp.argmin(jnp.where(passes, cost, inf)).astype(jnp.int32)
    return is_new, slot, cost
