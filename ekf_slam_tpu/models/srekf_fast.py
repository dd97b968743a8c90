"""Fast square-root EKF-SLAM: the O(M·D²) GEMM-only update path.

``models/srekf.py`` keeps the factor lower-triangular by QR-ing a
(2M+D)×(2M+D) pre-array every update — O((2M+D)³) Householder work, a
sequential recurrence that runs far below matmul rate.  At the
10k-landmark scale (D ≈ 20k, 2M = 4096) that is ~2·10¹³ badly-scheduled
FLOPs per tick: the square-root option would be unusable exactly where f32
conditioning needs it most (the dense update it guards is the reference's
(I−KH)·P at EKF_SLAM_UC.m:142-146).

This module drops the triangularity invariant instead of the cost:

* the factor ``S`` is a **general** D×D square root, P = S·Sᵀ — still PSD
  by construction (any real S is a factor of a PSD matrix, no matter how
  it is rounded), which is the property the square-root form is for;
* the measurement update is the closed-form Andrews-family update
  (Andrews 1968): with V = H·S (built from OBSERVED rows of S — the same
  row-gather trick as the dense path's ``pht_mode='rows'``),

      Sm = V·Vᵀ + R,      C = chol(Sm)              (innovation factor)
      G  = C⁻¹·V,         W = C⁻¹·chol(R)
      S' = S − (S·Gᵀ)·(I+W)⁻¹·G,   x' = x + (S·Gᵀ)·(C⁻¹ν)

  The identity (I+W)(I+Wᵀ) = I + W + Wᵀ + W·Wᵀ with G·Gᵀ = I − W·Wᵀ gives
  α + αᵀ − α(I − W·Wᵀ)αᵀ = I for α = (I+W)⁻¹, hence
  S'·S'ᵀ = P − S·Gᵀ·G·Sᵀ = P − P·Hᵀ·Sm⁻¹·H·P **exactly** — the Kalman
  posterior.  Every triangular solve is replaced by an explicit
  triangular inverse (one trsm against eye) + GEMM so the D-wide work
  runs at matmul rate, the same scheduling choice as models/batched.py's
  Cholesky-inverse gain.  Cost: two [D,D]×[D,2M] GEMMs (S·Gᵀ and the
  correction) + three [2M,2M]×[2M,D] GEMMs + one [2M,2M] Cholesky —
  O(M·D²), vs the QR path's O((2M+D)³).
* process noise is rank-1 per tick (c·w·wᵀ, EKF_SLAM.m:40-51), so predict
  absorbs it **exactly in O(D)** by writing √c·w into a spare zero column
  of S: S' = S + (√c·w)·e_cᵀ has S'S'ᵀ = SSᵀ + c·w·wᵀ whenever column c of
  S is zero.  Spare columns come from padding the state by
  ``params.sr_noise_buffer`` extra dims (state.init_state(extra_dims=...));
  one is consumed per predict and all are reclaimed by a periodic
  ``sr_recompress`` (dense P = SSᵀ via one D³ GEMM + one Cholesky — both
  GEMM-blocked, amortized over the buffer period, unlike the per-tick QR
  they replace).

Invariant (tests/test_srekf_fast.py): never-touched slot and buffer
COLUMNS of S stay exactly zero through predict/update/append — updates
map zero columns to zero columns (column c of H·S is H·S[:,c]), predict
only writes the scheduled buffer column, and appends write rows whose
entries at fresh columns are jxr·S[:3, fresh] = 0 — so ``sr_append``'s
O(D) slot write and the noise-column deposit stay exact for the general
factor.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..config import ASSOC_KNOWN, EKFParams
from ..ops.angles import cosd, sind, wrap_to_180, wrap_to_360
from ..ops.observations import ObsBatch
from ..state import FilterState
from . import ekf
from .batched import _innovation_blocks, gather_pairs
from .srekf import sr_append, sr_strips


def buffer_start(state: FilterState) -> int:
    """First noise-buffer column: the dim right past the last slot."""
    return 3 + 2 * state.capacity


def buffer_size(state: FilterState) -> int:
    """Number of spare noise columns the state was padded with."""
    return state.dim - buffer_start(state)


# ---------------------------------------------------------------------------
# H·S from observed rows (the factor-space analog of batched.hp_from_rows)
# ---------------------------------------------------------------------------

def _hs_rows(S: jnp.ndarray, x: jnp.ndarray, zs: jnp.ndarray,
             slots: jnp.ndarray, valid: jnp.ndarray, params: EKFParams,
             dt) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(H·S [2M,D], ν [2M]) touching only S's pose rows and one contiguous
    row pair per gated landmark — no dense H is ever materialized."""
    D = S.shape[1]
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
    Slm = gather_pairs(S, rows).reshape(M, 2, D).astype(dt)
    Spose = S[:3].astype(dt)                                   # [3,D]
    HS = (jnp.einsum("mij,jd->mid", A, Spose)
          + jnp.einsum("mij,mjd->mid", B, Slm)).reshape(2 * M, D)
    return HS, nu


def _sqrt_noise_block(Rs: jnp.ndarray, valid: jnp.ndarray, dt) -> jnp.ndarray:
    """Lower-Cholesky of the block-diagonal measurement noise, built from
    the closed-form 2×2 factors (masked slots get identity blocks, matching
    batched.noise_block)."""
    M = Rs.shape[0]
    tiny = jnp.asarray(jnp.finfo(dt).tiny, dt)
    r00 = jnp.where(valid, Rs[:, 0, 0].astype(dt), 1.0)
    r10 = jnp.where(valid, Rs[:, 1, 0].astype(dt), 0.0)
    r11 = jnp.where(valid, Rs[:, 1, 1].astype(dt), 1.0)
    l00 = jnp.sqrt(jnp.maximum(r00, tiny))
    l10 = r10 / l00
    l11 = jnp.sqrt(jnp.maximum(r11 - l10 * l10, tiny))
    idx = jnp.arange(M)
    sqR = jnp.zeros((2 * M, 2 * M), dt)
    sqR = sqR.at[2 * idx, 2 * idx].set(l00)
    sqR = sqR.at[2 * idx + 1, 2 * idx].set(l10)
    sqR = sqR.at[2 * idx + 1, 2 * idx + 1].set(l11)
    return sqR


# ---------------------------------------------------------------------------
# Measurement update (Andrews closed form — no QR)
# ---------------------------------------------------------------------------

def sr_update_andrews(state: FilterState, zs: jnp.ndarray, slots: jnp.ndarray,
                      Rs: jnp.ndarray, valid: jnp.ndarray, params: EKFParams
                      ) -> FilterState:
    """Joint square-root update of M observations in O(M·D²) GEMM work.

    Exactness (f64 parity vs models/batched.update_batch in
    tests/test_srekf_fast.py): for α = (I+W)⁻¹ the posterior gram is

      S'S'ᵀ = P − S·Gᵀ(α + αᵀ − α(I − W·Wᵀ)αᵀ)G·Sᵀ
            = P − S·Gᵀ·G·Sᵀ           [bracket = I, see module docstring]
            = P − P·Hᵀ·Sm⁻¹·H·P,

    the exact Kalman posterior (same math the QR pre-array encodes,
    srekf.sr_update_batch; reference dense form EKF_SLAM_UC.m:142-146).
    Masked lanes: zero H rows + identity R blocks make the corresponding
    columns of S·Gᵀ zero, so they cannot contribute to S' or x'."""
    x, S = state.x, state.P
    D = S.shape[1]
    M = zs.shape[0]
    dt = S.dtype

    HS, nu = _hs_rows(S, x, zs, slots, valid, params, dt)      # [2M,D]
    sqR = _sqrt_noise_block(Rs, valid, dt)                     # [2M,2M]

    Sm = HS @ HS.T                                             # [2M,2M] GEMM
    # exact block-diagonal R = sqR·sqRᵀ added without a second GEMM
    idx = jnp.arange(M)
    d0, d1 = 2 * idx, 2 * idx + 1
    Sm = Sm.at[d0, d0].add(sqR[d0, d0] ** 2)
    Sm = Sm.at[d1, d0].add(sqR[d1, d0] * sqR[d0, d0])
    Sm = Sm.at[d0, d1].add(sqR[d1, d0] * sqR[d0, d0])
    Sm = Sm.at[d1, d1].add(sqR[d1, d0] ** 2 + sqR[d1, d1] ** 2)

    # Explicit triangular inverses: ONE trsm each against eye (O(M³) at
    # trsm rate), then every D-wide application is a full-rate GEMM
    # instead of a left-solve against the D-wide HS (models/batched.py's
    # gain schedule).
    eye = jnp.eye(2 * M, dtype=dt)
    C = jnp.linalg.cholesky(Sm)                                # lower
    Cinv = lax.linalg.triangular_solve(C, eye, left_side=True, lower=True)
    G = Cinv @ HS                                              # [2M,D] GEMM
    W = Cinv @ sqR                                             # [2M,2M] GEMM
    y = Cinv @ nu                                              # C⁻¹ν

    SGt = S.astype(dt) @ G.T                                   # [D,2M] GEMM
    x = x + (SGt @ y).astype(x.dtype)                          # K·ν

    IW = W.at[jnp.arange(2 * M), jnp.arange(2 * M)].add(1.0)   # I + W, lower
    IWinv = lax.linalg.triangular_solve(IW, eye, left_side=True, lower=True)
    Y = IWinv @ G                                              # [2M,D] GEMM
    S = S - SGt @ Y                                            # [D,D] GEMM

    act = jnp.arange(S.shape[0]) < 3 + 2 * state.n_active
    # rows beyond the active block stay exactly zero; COLUMNS are left
    # untouched — the noise-buffer deposits live in pose rows 0..2.
    return state._replace(x=x, P=S * act[:, None].astype(dt))


def sr_update_chunked(state: FilterState, zs: jnp.ndarray,
                      slots: jnp.ndarray, Rs: jnp.ndarray,
                      valid: jnp.ndarray, params: EKFParams) -> FilterState:
    """``sr_update_andrews`` in ``params.update_chunks`` sequential chunks.

    Same scheduling economics as batched.update_chunked: the two O(M·D²)
    factor GEMMs are chunk-invariant, while the O(M²·D) G/Y GEMMs and the
    O(M³) Cholesky/inverses shrink by G and G² — at 10k landmarks the
    chunk-512 schedule carries over from the dense path
    (utils/schedule.py)."""
    G = max(1, int(params.update_chunks))
    M = zs.shape[0]
    if G == 1 or G >= M:
        return sr_update_andrews(state, zs, slots, Rs, valid, params)
    m = -(-M // G)
    for g0 in range(0, M, m):
        sl = slice(g0, min(g0 + m, M))
        state = sr_update_andrews(state, zs[sl], slots[sl], Rs[sl],
                                  valid[sl], params)
    return state


# ---------------------------------------------------------------------------
# Prediction: O(D) row-axpys + exact rank-1 noise into a spare zero column
# ---------------------------------------------------------------------------

def sr_predict_fast(state: FilterState, u: jnp.ndarray, params: EKFParams,
                    noise_col) -> FilterState:
    """Square-root prediction without re-triangularization.

    Covariance math of EKF_SLAM.m:40-51: P' = F·P·Fᵀ + c·w·wᵀ.  F·S is two
    row-axpys (F differs from I in two entries, EKF_SLAM.m:62-64), and the
    rank-1 noise is absorbed EXACTLY by writing √c·w into column
    ``noise_col`` — valid iff that column of S is currently all zero (the
    session schedules one fresh buffer column per tick and reclaims them
    with sr_recompress; tests/test_srekf_fast.py asserts the invariant)."""
    x, S = state.x, state.P
    dt = S.dtype
    th = x[2]
    dD, dTh = u[0], u[1]

    w = jnp.stack([dD * cosd(th), dD * sind(th), dTh]).astype(dt)
    sqc = jnp.sqrt(jnp.asarray(params.c_process, dt))

    new_pose, f13, f23 = ekf.motion_model(x[:3], u, params.ref_compat)
    new_pose = new_pose.at[2].set(wrap_to_360(new_pose[2]))
    x = x.at[:3].set(new_pose.astype(x.dtype))

    S = S.at[0].add(f13 * S[2]).at[1].add(f23 * S[2])          # F·S
    S = lax.dynamic_update_slice(
        S, (sqc * w)[:, None],
        (jnp.zeros((), jnp.int32), jnp.asarray(noise_col, jnp.int32)))
    return state._replace(x=x, P=S)


# ---------------------------------------------------------------------------
# Periodic recompression: reclaim the noise-buffer columns
# ---------------------------------------------------------------------------

def sr_recompress(state: FilterState) -> FilterState:
    """General factor → fresh lower-triangular factor of the same P.

    One D×D GEMM (P = S·Sᵀ) + one blocked Cholesky
    (ops/blocked_chol.chol_blocked: all O(D³) work as GEMMs).  Restores
    every inactive/buffer column to exact
    zero, so the noise-column budget resets.  Conditioning: the Gram
    S·Sᵀ of a real factor is PSD by construction, but FORMING it squares
    the condition number — the chol route is valid only for
    κ(P) ≲ 1/eps of the working dtype; past that its panel Cholesky
    hits a round-off-negative pivot and NaNs (observed under the f32
    tiny-R stress, tests/test_srekf_fast.py).  When that happens the
    recompression falls back (lax.cond — the branch is only executed
    when taken) to QR re-triangularization of Sᵀ: orthogonal transforms
    see only κ(S) = √κ(P), the square-root representation's actual
    safety envelope, at XLA's (slow) Householder rate — an emergency
    path, not a schedule."""
    from ..ops.blocked_chol import chol_for_state
    S = state.P
    G = jnp.matmul(S, S.T, preferred_element_type=S.dtype)
    L_tri = chol_for_state(G, state.n_active)
    tri = state._replace(P=L_tri)
    D = tri.P.shape[0]
    act = (jnp.arange(D) < 3 + 2 * state.n_active).astype(state.P.dtype)

    def qr_path(_):
        from .srekf import _retriangularize
        return _retriangularize(state.P.T, D) * act[:, None]

    ok = jnp.isfinite(jnp.diagonal(tri.P)).all()
    L = jax.lax.cond(ok, lambda _: tri.P, qr_path, None)
    return state._replace(P=L)


def sr_update_panel(state: FilterState, zs: jnp.ndarray, slots: jnp.ndarray,
                    Rs: jnp.ndarray, valid: jnp.ndarray, params: EKFParams
                    ) -> FilterState:
    """Strict-triangular joint update: the round-4 replacement for the
    O((2M+D)³) QR pre-array (srekf.sr_update_batch) at scale.

    Two phases, both GEMM-dominated:
      1. the chunked closed-form Andrews update (factor-space algebra
         only — unconditionally PSD), O(M·D²) GEMMs;
      2. fused re-triangularization: Gram + blocked Cholesky
         (sr_recompress), O(D³/3) GEMMs + D/b small panel Choleskys.

    Why not the textbook blocked partial-Householder (compact-WY panel
    QR of the pre-array)?  Its panel factorization is a sequential
    recurrence over 2M Householder columns — latency-bound, each tiny
    step paying loop overhead that no matmul amortizes.  The Gram-based
    route (CholeskyQR lineage) moves the same
    information through matmuls; the innovation Gram is R-regularized
    (benign), and the posterior is only ever represented through factors
    so rounding cannot make it indefinite.  The irreducible premium of a
    triangular-per-update factor is the Gram+chol (~D³·4/3 GEMM flops);
    `srekf_fast` amortizes exactly that over the noise-buffer period —
    set ``sr_noise_buffer=1`` in a session to get this strict mode
    end-to-end (the per-tick recompress cond then always fires)."""
    st = sr_update_chunked(state, zs, slots, Rs, valid, params)
    return sr_recompress(st)


# ---------------------------------------------------------------------------
# Full measurement phase (gate → joint Andrews update → O(D) appends)
# ---------------------------------------------------------------------------

def sr_measure_fast(state: FilterState, obs: ObsBatch, u: jnp.ndarray,
                    params: EKFParams) -> FilterState:
    """General-factor counterpart of srekf.sr_measure_batched: gating
    strips come from full rows of S (no triangularity assumption —
    srekf.sr_strips(triangular=False)), the joint update is the chunked
    closed-form Andrews pass, appends are unchanged (a fresh slot's
    columns are untouched zeros, so sr_append's O(D) block write stays
    exact)."""
    from ..ops.association import gate_batch

    M = obs.rng.shape[0]
    zs = jnp.stack([obs.rng, obs.bearing,
                    obs.index.astype(params.dtype)], axis=-1)
    Rs = ekf.obs_noise_batch(obs, zs, params)

    obs_valid = obs.valid
    if params.association == ASSOC_KNOWN:
        is_new = zs[:, 2] > state.n_active.astype(params.dtype)
        slots = jnp.clip(obs.index - 1, 0, state.capacity - 1)
    else:
        strips = sr_strips(state.P, state.capacity, triangular=False)
        if params.ml_losers == "drop":
            # see models/batched.measure_batched: out-claimed ml_unique
            # observations invalidated instead of appended
            is_new, slots, losers = gate_batch(state, zs, Rs, params,
                                               strips=strips,
                                               return_losers=True)
            obs_valid = obs_valid & ~losers
        else:
            is_new, slots = gate_batch(state, zs, Rs, params, strips=strips)
    first = state.n_active == 0
    is_new = jnp.logical_or(is_new, first)

    upd_valid = obs_valid & ~is_new
    state = sr_update_chunked(state, zs, slots, Rs, upd_valid, params)

    def body(ii, s):
        def do(s):
            return sr_append(s, u, Rs[ii], obs.loc[ii], zs[ii, 2], params)
        return lax.cond(obs_valid[ii] & is_new[ii], do, lambda s: s, s)
    return lax.fori_loop(0, M, body, state)
