"""Batched-innovation EKF update: M observations in one pass over P.

The reference applies observations strictly sequentially — each Kalman
update rewrites the full covariance before the next begins
(EKF_SLAM_UC.m:109-150), so M observations cost M full passes over the
(3+2K)² covariance.  On an accelerator that is pure memory-bandwidth
waste: the joint
batched-innovation update stacks the M measurement Jacobians into one
[2M × D] observation model and applies a single rank-2M correction

    S = H P Hᵀ + R   (2M×2M),  K = P Hᵀ S⁻¹  (D×2M),  P ← P − K·(P Hᵀ)ᵀ

touching P exactly once.  With all observations gated against the same
pre-update state this is the textbook-correct joint EKF update (it equals
the sequential chain when observations are independent and the filter is
linear-consistent; it is NOT bit-identical to the reference's sequential
order — use models/ekf.measure for ref-compat parity).

Invalid/masked observation slots contribute zero Jacobian rows and an
identity S block, making them exact no-ops — so the batch size is a static
shape and jit never recompiles.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..config import ASSOC_KNOWN, EKFParams
from ..models import ekf
from ..ops.angles import wrap_to_180
from ..ops.observations import ObsBatch
from ..state import FilterState


def _innovation_blocks(x: jnp.ndarray, slots: jnp.ndarray,
                       params: EKFParams):
    """vmapped ẑ / A (pose block) / B (landmark block) per observation."""
    def one(slot):
        return ekf.innovation(x, slot, params)
    return jax.vmap(one)(slots)            # zhat [M,2], A [M,2,3], B [M,2,2]


def innovation_operator(x: jnp.ndarray, zs: jnp.ndarray, slots: jnp.ndarray,
                        valid: jnp.ndarray, params: EKFParams, dt
                        ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Stacked observation model for M measurements: (Ht [D,2M], nu [2M]).

    Column pair 2m of the dense Hᵀ holds A_mᵀ in the pose rows and B_mᵀ in
    landmark slot_m's row pair; invalid slots contribute zero columns and a
    zero innovation, making them exact no-ops in any downstream update."""
    D = x.shape[0]
    M = zs.shape[0]

    zhat, A, B = _innovation_blocks(x, slots, params)
    vmask = valid.astype(dt)
    A = A * vmask[:, None, None]                               # [M,2,3]
    B = B * vmask[:, None, None]                               # [M,2,2]

    nu = zs[:, :2].astype(dt) - zhat
    if not params.ref_compat:
        nu = nu.at[:, 1].set(wrap_to_180(nu[:, 1]))
    nu = (nu * vmask[:, None]).reshape(2 * M)

    cols = 3 + 2 * slots                                       # i32[M]
    midx = jnp.arange(M)
    Ht = jnp.zeros((D, 2 * M), dt)
    Ht = Ht.at[0:3, :].set(
        A.transpose(2, 0, 1).reshape(3, 2 * M))                # pose rows
    rowpair = cols[:, None] + jnp.arange(2)[None, :]           # [M,2]
    colpair = 2 * midx[:, None] + jnp.arange(2)[None, :]       # [M,2]
    Ht = Ht.at[rowpair[:, :, None], colpair[:, None, :]].add(
        B.transpose(0, 2, 1))                                  # [M,2,2]
    return Ht, nu


def noise_block(Rs: jnp.ndarray, valid: jnp.ndarray, dt) -> jnp.ndarray:
    """Block-diagonal R [2M,2M]; invalid slots get identity blocks so the
    joint innovation system stays well-conditioned where H/nu are zero."""
    M = Rs.shape[0]
    Rblk = jnp.zeros((2 * M, 2 * M), dt)
    ridx = jnp.arange(M)
    Rblk = Rblk.at[2 * ridx, 2 * ridx].set(
        jnp.where(valid, Rs[:, 0, 0].astype(dt), 1.0))
    Rblk = Rblk.at[2 * ridx + 1, 2 * ridx + 1].set(
        jnp.where(valid, Rs[:, 1, 1].astype(dt), 1.0))
    Rblk = Rblk.at[2 * ridx, 2 * ridx + 1].set(
        jnp.where(valid, Rs[:, 0, 1].astype(dt), 0.0))
    Rblk = Rblk.at[2 * ridx + 1, 2 * ridx].set(
        jnp.where(valid, Rs[:, 1, 0].astype(dt), 0.0))
    return Rblk


def gather_pairs(P: jnp.ndarray, starts: jnp.ndarray) -> jnp.ndarray:
    """Rows ``starts[i]`` and ``starts[i] + 1`` of ``P`` for every i, stacked
    as [2M, D]: the observed row pairs read by the rows-mode update (and by
    srekf_fast's factor-space analog).  Whole contiguous rows, so XLA emits
    a plain row gather."""
    rp = (starts[:, None] + jnp.arange(2)[None, :]).reshape(-1)
    return jnp.take(P, rp, axis=0)


def syrk_downdate(P: jnp.ndarray, W: jnp.ndarray) -> jnp.ndarray:
    """The symmetric rank-R downdate P − W·Wᵀ (``correction='syrk'``).

    The product accumulates in f32 when the storage dtype is narrower
    (bf16 P), and the difference is rounded to the storage dtype once."""
    acc = jnp.float32 if P.dtype in (jnp.bfloat16, jnp.float16) else P.dtype
    C = jnp.matmul(W, W.T, preferred_element_type=acc)
    return (P.astype(acc) - C).astype(P.dtype)


def hp_from_rows(P: jnp.ndarray, x: jnp.ndarray, zs: jnp.ndarray,
                 slots: jnp.ndarray, valid: jnp.ndarray, params: EKFParams,
                 dt) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(HP [2M,D], Ht [D,2M], nu [2M]) from the OBSERVED rows of a
    symmetric P.

    H has 2M+3 nonzero columns, so H·P touches only P's pose rows and one
    contiguous row pair per gated landmark — an [2M,D] row gather (rows
    are contiguous in memory, unlike the strided columns that made the
    naive P·Hᵀ gather catastrophic) plus tiny [2,2]/[2,3] contractions.
    By symmetry P·Hᵀ = (H·P)ᵀ, so the full D²·2M GEMM of the dense path
    disappears (params.pht_mode='rows').  The dense Ht (cheap scatter
    build, needed for S = HP·Ht) is returned so the caller shares the
    masked Jacobian blocks."""
    D = x.shape[0]
    M = zs.shape[0]
    zhat, A, B = _innovation_blocks(x, slots, params)
    vmask = valid.astype(dt)
    A = A * vmask[:, None, None]                               # [M,2,3]
    B = B * vmask[:, None, None]                               # [M,2,2]

    nu = zs[:, :2].astype(dt) - zhat
    if not params.ref_compat:
        nu = nu.at[:, 1].set(wrap_to_180(nu[:, 1]))
    nu = (nu * vmask[:, None]).reshape(2 * M)

    rows = 3 + 2 * slots                                       # i32[M]
    Plm = gather_pairs(P, rows).reshape(M, 2, D).astype(dt)
    Ppose = P[:3].astype(dt)                                   # [3,D]
    HP = (jnp.einsum("mij,jd->mid", A, Ppose)
          + jnp.einsum("mij,mjd->mid", B, Plm)).reshape(2 * M, D)

    # dense Ht for the S GEMM (same scatter as innovation_operator)
    midx = jnp.arange(M)
    Ht = jnp.zeros((D, 2 * M), dt)
    Ht = Ht.at[0:3, :].set(A.transpose(2, 0, 1).reshape(3, 2 * M))
    rowpair = rows[:, None] + jnp.arange(2)[None, :]
    colpair = 2 * midx[:, None] + jnp.arange(2)[None, :]
    Ht = Ht.at[rowpair[:, :, None], colpair[:, None, :]].add(
        B.transpose(0, 2, 1))
    return HP, Ht, nu


def update_batch(state: FilterState, zs: jnp.ndarray, slots: jnp.ndarray,
                 Rs: jnp.ndarray, valid: jnp.ndarray, params: EKFParams
                 ) -> FilterState:
    """Joint update of M (range, bearing) observations against ``slots``.

    zs: f[M,2+] measured (range, bearing, ...); Rs: f[M,2,2]; valid: bool[M].

    Gather-free formulation: the sparse per-observation Jacobians are
    scattered into ONE dense Hᵀ [D, 2M], so P·Hᵀ and H·(P·Hᵀ) are plain
    matmuls and P is streamed exactly twice (once for P·Hᵀ, once for the
    rank-2M correction) — no gather of strided P columns.

    ``params.pht_mode='rows'`` replaces the P·Hᵀ GEMM with a row gather
    using P's symmetry (see hp_from_rows) — half the matmul flops and one
    fewer full pass over P; the correction GEMM (the irreducible dense
    rank-2M write) is unchanged.
    """
    x, P = state.x, state.P
    # Mixed precision (params.cov_dtype=bf16): P is stored bf16 — halving
    # the memory bytes of the P-streaming passes — and the two O(D²·M)
    # GEMMs run with bf16 operands + f32 accumulation
    # (preferred_element_type).  bf16 GEMM inputs cost nothing beyond
    # what bf16 *storage* already quantized.  Everything small (S, the
    # Cholesky solve, the mean, Kg·S) stays f32.
    ct = x.dtype
    fast16 = P.dtype == jnp.bfloat16

    def mm(a, b):
        """Large GEMM in the storage precision, accumulated in ct."""
        if fast16:
            return jnp.matmul(a.astype(jnp.bfloat16),
                              b.astype(jnp.bfloat16),
                              preferred_element_type=ct)
        return a @ b

    if params.pht_mode == "rows":
        HP, Ht, nu = hp_from_rows(P, x, zs, slots, valid, params, ct)
        PHt = HP.T                                             # symmetry
        # S = H·(P·Hᵀ): a D·(2M)² GEMM against the (cheap) dense Hᵀ
        S = HP @ Ht
    else:
        Ht, nu = innovation_operator(x, zs, slots, valid, params, ct)
        PHt = mm(P, Ht)                                        # [D,2M]
        S = Ht.T @ PHt                                         # [2M,2M]
    S = S + noise_block(Rs, valid, ct)

    # S is symmetric PSD (H·P·Hᵀ + R with identity blocks in masked slots).
    # Kg = PHt·S⁻¹ via an EXPLICIT Cholesky inverse + GEMM, so the D-wide
    # work is one matmul instead of a triangular solve against a D-wide
    # right-hand side.  The inverse itself is ONE triangular solve (L⁻¹
    # against eye) + a GEMM (S⁻¹ = L⁻ᵀL⁻¹).  S is R-regularized, so the
    # explicit inverse is numerically safe here.
    L = jnp.linalg.cholesky(S)
    Linv = lax.linalg.triangular_solve(
        L, jnp.eye(2 * zs.shape[0], dtype=ct), left_side=True, lower=True)

    if params.correction == "syrk":
        # Symmetric-downdate form: Kg·(H·P) = PHᵀ·S⁻¹·(PHᵀ)ᵀ = W·Wᵀ with
        # W = PHᵀ·L⁻ᵀ (syrk_downdate).  The mean uses the same factor:
        # Kg·nu = W·(L⁻¹·nu) — no S⁻¹ or Kg is ever formed.
        W = PHt @ Linv.T                                       # [D,2M]
        x = x + W @ (Linv @ nu)
        Wk = W.astype(jnp.bfloat16) if fast16 else W
        P = syrk_downdate(P, Wk)
        if params.symmetrize:
            P = 0.5 * (P + P.T)
        return state._replace(x=x, P=P)

    Sinv = Linv.T @ Linv                                       # [2M,2M]
    Kg = PHt @ Sinv                                            # [D,2M]

    x = x + Kg @ nu
    if params.joseph:
        KB = mm(Kg, PHt.T)
        P = (P - KB - KB.T + mm(Kg @ S, Kg.T)).astype(P.dtype)
    else:
        P = (P - mm(Kg, PHt.T)).astype(P.dtype)
    if params.symmetrize:
        P = 0.5 * (P + P.T)
    return state._replace(x=x, P=P)


def update_chunked(state: FilterState, zs: jnp.ndarray, slots: jnp.ndarray,
                   Rs: jnp.ndarray, valid: jnp.ndarray, params: EKFParams
                   ) -> FilterState:
    """``update_batch`` applied in ``params.update_chunks`` sequential
    chunks (each chunk linearizes against the running state — standard
    sequential-group EKF conditioning, at least as consistent as the single
    joint update).

    Why: the innovation solve (Cholesky + inverse of the 2M×2M S) costs
    O(M³) per batch = O(M²) per observation, while the two P passes cost
    O(D²·M).  At small D the solve dominates; G chunks cut its per-update
    cost by G² at the price of G× the (cheap) P passes.
    """
    G = max(1, int(params.update_chunks))
    M = zs.shape[0]
    if G == 1 or G >= M:
        return update_batch(state, zs, slots, Rs, valid, params)
    # ceil-divide so a non-divisible M still gets the requested scheduling:
    # G-1 chunks of ceil(M/G) plus a final smaller remainder chunk (slices
    # by python ints stay static shapes under jit).
    m = -(-M // G)
    for g0 in range(0, M, m):
        sl = slice(g0, min(g0 + m, M))
        state = update_batch(state, zs[sl], slots[sl], Rs[sl], valid[sl],
                             params)
    return state


def measure_batched(state: FilterState, obs: ObsBatch, u: jnp.ndarray,
                    params: EKFParams) -> FilterState:
    """Fast-mode measurement phase: gate all observations against the
    pre-update state, apply ONE joint update, then append the new landmarks
    sequentially (appends are O(D), not O(D²), so sequential is fine).

    Semantic difference vs models/ekf.measure (ref order): association and
    linearization use the tick's prior state for every observation instead
    of the running partially-updated state.
    """
    M = obs.rng.shape[0]
    zs = jnp.stack([obs.rng, obs.bearing,
                    obs.index.astype(params.dtype)], axis=-1)
    Rs = ekf.obs_noise_batch(obs, zs, params)                  # [M,2,2]

    obs_valid = obs.valid
    if params.association == ASSOC_KNOWN:
        is_new = zs[:, 2] > state.n_active.astype(params.dtype)
        slots = jnp.clip(obs.index - 1, 0, state.capacity - 1)
    else:
        from ..ops.association import gate_batch
        if params.ml_losers == "drop":
            # ml_unique out-claimed observations are invalidated for the
            # batch instead of becoming duplicate appends (EKFParams
            # .ml_losers; the default 'append' keeps is_new semantics)
            is_new, slots, losers = gate_batch(
                state, zs, Rs, params, return_losers=True)
            obs_valid = obs_valid & ~losers
        else:
            is_new, slots = gate_batch(state, zs, Rs, params)
    first = state.n_active == 0
    is_new = jnp.logical_or(is_new, first)

    upd_valid = obs_valid & ~is_new
    state = update_chunked(state, zs, slots, Rs, upd_valid, params)

    # sequential masked appends for the new ones (cheap rank-type writes)
    def body(ii, s):
        def do(s):
            return ekf.append(s, u, Rs[ii], obs.loc[ii], zs[ii, 2], params)
        return lax.cond(obs_valid[ii] & is_new[ii], do, lambda s: s, s)
    return lax.fori_loop(0, M, body, state)
