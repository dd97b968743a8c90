"""Square-root (Cholesky-factor) EKF-SLAM: conditioning beyond f32's reach.

The reference propagates the dense covariance with the (I−KH)·P form
(EKF_SLAM_UC.m:146), which loses symmetry and — in finite precision — can
drive P indefinite; the Joseph form (models/ekf.py, ``params.joseph``) fixes
symmetry but still squares the condition number carried through storage.
This module instead propagates the **Cholesky factor** L with P = L·Lᵀ:
PSD by construction at any precision, and the effective condition number is
κ(L) = √κ(P) — the classical square-root filter (Kaminski/Bierman), which
the reference has no analog of.

Design notes:

* The factor lives in the ordinary ``FilterState`` pytree with ``P``
  holding L (lower triangular; inactive slot rows are zero).  Slots are
  appended in increasing order, so lower-triangularity is invariant.
* **append is O(D)**: the new cross strip of P is ``jxr·P[:3,:]`` — a linear
  map of P's first three rows (EKF_SLAM.m:92-96) — so the new *factor* rows
  are the same map of L's first three rows, and the new diagonal factor is
  just chol₂ₓ₂(jz·R·jzᵀ).  No solve, no refactorization.
* **gating is O(D²)**: the strips gate_batch needs (pose block, pose↔landmark
  strip, landmark 2×2 diagonal blocks) come out of L with one [3,3] GEMM,
  one [3,D]×[D,2K] contraction, and two elementwise row-dot passes.
* **predict / update re-triangularize by QR** of the standard pre-arrays —
  O(D³)/tick.  That is the cost of guaranteed PSD in f32; this mode is for
  conditioning-critical regimes (tiny R, long sequences, ≳10k landmarks in
  f32) — the throughput path remains models/batched.py (Joseph form stays
  PSD at the benchmarked scales, see tests/test_sim_session.py).

Parity: every op here equals its dense counterpart exactly in exact
arithmetic (tests/test_srekf.py checks L·Lᵀ against models/ekf.py /
models/batched.py at f64).
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..config import ASSOC_KNOWN, EKFParams
from ..ops.angles import cosd, sind
from ..ops.observations import ObsBatch
from ..state import FilterState
from . import ekf
from .batched import innovation_operator, noise_block


# ---------------------------------------------------------------------------
# Dense ↔ factor conversion
# ---------------------------------------------------------------------------

def factor_from_state(state: FilterState) -> FilterState:
    """Dense-P state → square-root state (P field holds L, P = L·Lᵀ).

    Active rows are the leading 3+2·n_active (appends are in slot order), so
    the padded P is block-diagonal [P_active, 0]; augmenting the inactive
    diagonal with 1 makes Cholesky well-defined without touching the active
    factor, then the inactive rows are zeroed back out.  The factorization
    is the blocked GEMM-dominated kernel (ops/blocked_chol.py)."""
    from ..ops.blocked_chol import chol_for_state
    return state._replace(P=chol_for_state(state.P, state.n_active))


def state_to_dense(state: FilterState) -> FilterState:
    """Square-root state → dense-P state (P = L·Lᵀ)."""
    return state._replace(P=state.P @ state.P.T)


def _retriangularize(pre: jnp.ndarray, d: int) -> jnp.ndarray:
    """QR-retriangularization: returns lower-triangular L [d,d] with
    L·Lᵀ = preᵀ·pre (``pre`` is the transposed stacked factor, [n,d]).

    Columns are sign-fixed so diag(L) ≥ 0 — the canonical Cholesky factor
    (QR's R is sign-ambiguous); keeps diag(L) usable as a health signal
    (utils/faults.check_tick with ``factored=True``)."""
    R = jnp.linalg.qr(pre, mode="r")[:d, :]
    s = jnp.where(jnp.diagonal(R) < 0, -1.0, 1.0).astype(R.dtype)
    return (R * s[:, None]).T


def _sign_fix(L: jnp.ndarray) -> jnp.ndarray:
    """Flip factor columns so diag(L) ≥ 0 (L·Lᵀ invariant)."""
    s = jnp.where(jnp.diagonal(L) < 0, -1.0, 1.0).astype(L.dtype)
    return L * s[None, :]


# ---------------------------------------------------------------------------
# Prediction
# ---------------------------------------------------------------------------

def sr_predict(state: FilterState, u: jnp.ndarray, params: EKFParams
               ) -> FilterState:
    """Square-root prediction (covariance math of EKF_SLAM.m:40-51).

    P' = F·P·Fᵀ + c·W·Wᵀ  →  L' from QR of the (D+1)×D pre-array
    [ (F·L)ᵀ ; √c·Wᵀ ].  F·L is L plus two row-axpys (F differs from I in
    two entries, EKF_SLAM.m:62-64)."""
    x, L = state.x, state.P
    dt = L.dtype
    th = x[2]
    dD, dTh = u[0], u[1]

    W = jnp.stack([dD * cosd(th), dD * sind(th), dTh]).astype(dt)
    sqc = jnp.sqrt(jnp.asarray(params.c_process, dt))
    wrow = jnp.zeros((1, L.shape[0]), dt).at[0, :3].set(sqc * W)

    new_pose, f13, f23 = ekf.motion_model(x[:3], u, params.ref_compat)
    from ..ops.angles import wrap_to_360
    new_pose = new_pose.at[2].set(wrap_to_360(new_pose[2]))
    x = x.at[:3].set(new_pose.astype(x.dtype))

    FL = L.at[0].add(f13 * L[2]).at[1].add(f23 * L[2])
    pre = jnp.concatenate([FL.T, wrow], axis=0)        # [(D+1), D]
    L = _retriangularize(pre, L.shape[0])
    # keep inactive rows exactly zero (QR column pivoting is not used, so
    # trailing zero columns stay zero — this is belt-and-braces masking)
    act = jnp.arange(L.shape[0]) < 3 + 2 * state.n_active
    return state._replace(x=x, P=L * act[:, None].astype(dt))


# ---------------------------------------------------------------------------
# Landmark append (O(D), no refactorization)
# ---------------------------------------------------------------------------

def _chol2(Sym: jnp.ndarray) -> jnp.ndarray:
    """Closed-form lower Cholesky of a 2×2 PSD matrix, guarded for the
    zero/degenerate case (masked lanes must stay finite)."""
    tiny = jnp.asarray(jnp.finfo(Sym.dtype).tiny, Sym.dtype)
    l00 = jnp.sqrt(jnp.maximum(Sym[0, 0], tiny))
    l10 = Sym[1, 0] / l00
    l11 = jnp.sqrt(jnp.maximum(Sym[1, 1] - l10 * l10, tiny))
    z = jnp.zeros_like(l00)
    return jnp.stack([jnp.stack([l00, z]), jnp.stack([l10, l11])])


def sr_append(state: FilterState, u: jnp.ndarray, R2: jnp.ndarray,
              loc: jnp.ndarray, signature: jnp.ndarray, params: EKFParams
              ) -> FilterState:
    """Append a landmark into the next free slot of the factor (no-op at
    capacity).  Same covariance blocks as ekf.append (EKF_SLAM.m:84-97):
    the factor rows are jxr·L[:3,:] (cross) and chol₂ₓ₂(jz·R·jzᵀ) (diag) —
    see module docstring for why no solve is needed."""
    K = state.capacity

    def do_append(s: FilterState) -> FilterState:
        x, L = s.x, s.P
        dt = L.dtype
        th = x[2]
        dD, dTh = u[0], u[1]
        jxr = jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], dt)
        jxr = jxr.at[0, 2].set(-dD * sind(th)).at[1, 2].set(dD * cosd(th))
        jz = jnp.stack([
            jnp.stack([cosd(dTh), -dD * sind(dTh)]),
            jnp.stack([sind(dTh), dD * cosd(dTh)]),
        ]).astype(dt)

        Lr = jxr @ L[:3, :]                              # [2, D] cross rows
        Ld = _chol2(jz @ R2.astype(dt) @ jz.T)           # [2, 2] diag factor

        slot = s.n_active
        row = jnp.asarray(3 + 2 * slot, jnp.int32)
        zero = jnp.zeros((), jnp.int32)
        L = lax.dynamic_update_slice(L, Lr, (row, zero))
        L = lax.dynamic_update_slice(L, Ld, (row, row))
        x = lax.dynamic_update_slice(x, loc.astype(x.dtype), (row,))
        return FilterState(
            x=x, P=L,
            sig=s.sig.at[slot].set(jnp.asarray(signature, s.sig.dtype)),
            active=s.active.at[slot].set(True),
            n_active=s.n_active + 1,
        )

    return lax.cond(state.n_active < K, do_append, lambda s: s, state)


# ---------------------------------------------------------------------------
# Measurement update (QR pre-array)
# ---------------------------------------------------------------------------

def sr_update_batch(state: FilterState, zs: jnp.ndarray, slots: jnp.ndarray,
                    Rs: jnp.ndarray, valid: jnp.ndarray, params: EKFParams
                    ) -> FilterState:
    """Joint square-root update of M observations (math of
    EKF_SLAM_UC.m:125-146, batched as in models/batched.update_batch).

    QR of the (2M+D)×(2M+D) pre-array  [[chol(R)ᵀ, 0], [LᵀHᵀ, Lᵀ]]  yields
    the post-array  [[X₁₁, X₁₂], [0, L'ᵀ]]  with X₁₁ᵀX₁₁ = S = HPHᵀ+R,
    X₁₂ᵀ = K·X₁₁ᵀ, and L'L'ᵀ = P − K·S·Kᵀ — the exact Kalman posterior,
    PSD by construction.  x += X₁₂ᵀ·(X₁₁⁻ᵀ·ν) avoids ever forming K."""
    x, L = state.x, state.P
    D = x.shape[0]
    M = zs.shape[0]
    dt = L.dtype

    Ht, nu = innovation_operator(x, zs, slots, valid, params, dt)
    Rblk = noise_block(Rs, valid, dt)
    # Rblk is block-diagonal 2×2 (identity in masked slots): chol is cheap.
    sqR = jnp.linalg.cholesky(Rblk)                      # lower [2M,2M]

    U = L.T @ Ht                                         # [D,2M] = (H·L)ᵀ
    pre = jnp.concatenate([
        jnp.concatenate([sqR.T, jnp.zeros((2 * M, D), dt)], axis=1),
        jnp.concatenate([U, L.T], axis=1),
    ], axis=0)                                           # [(2M+D), (2M+D)]
    Rfac = jnp.linalg.qr(pre, mode="r")
    X11 = Rfac[:2 * M, :2 * M]                           # upper, X11ᵀX11 = S
    X12 = Rfac[:2 * M, 2 * M:]                           # [2M, D]
    Lp = _sign_fix(Rfac[2 * M:, 2 * M:].T)               # lower, the new L

    y = jax.scipy.linalg.solve_triangular(X11.T, nu, lower=True)
    x = x + X12.T @ y

    act = jnp.arange(D) < 3 + 2 * state.n_active
    return state._replace(x=x, P=Lp * act[:, None].astype(dt))


# ---------------------------------------------------------------------------
# Gating strips + full measurement phase
# ---------------------------------------------------------------------------

def sr_strips(L: jnp.ndarray, K: int, triangular: bool = True
              ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """The P pieces the batched gate needs, straight from the factor:
    (Prr [3,3], Prl [K,3,2], Pll [K,2,2]) — O(D²) elementwise, no dense P.

    ``triangular=False``: the factor is a GENERAL square root (P = S·Sᵀ with
    S not lower-triangular — models/srekf_fast.py), so the pose rows span
    all columns; the strip contractions run full-width ([3,D]·[D,2K] — still
    O(D·K), tiny next to the update GEMMs).  The diagonal-block row-dots are
    width-agnostic either way."""
    end = 3 + 2 * K
    w = 3 if triangular else L.shape[1]              # tri: pose rows end at col 2
    Prr = L[:3, :w] @ L[:3, :w].T
    Prl = (L[:3, :w] @ L[3:end, :w].T).reshape(3, K, 2).transpose(1, 0, 2)
    d0 = jnp.sum(L * L, axis=1)                      # diag of L·Lᵀ
    d1 = jnp.sum(L[:-1] * L[1:], axis=1)             # first superdiagonal
    p00, p11 = d0[3:end:2], d0[4:end:2]
    p01 = d1[3:end:2]
    Pll = jnp.stack([jnp.stack([p00, p01], -1),
                     jnp.stack([p01, p11], -1)], axis=1)
    return Prr, Prl, Pll


def sr_measure_batched(state: FilterState, obs: ObsBatch, u: jnp.ndarray,
                       params: EKFParams) -> FilterState:
    """Square-root counterpart of models/batched.measure_batched: gate all
    observations against the prior factor, one joint QR update, then O(D)
    appends for the new landmarks."""
    from ..ops.association import gate_batch

    M = obs.rng.shape[0]
    zs = jnp.stack([obs.rng, obs.bearing,
                    obs.index.astype(params.dtype)], axis=-1)
    Rs = ekf.obs_noise_batch(obs, zs, params)

    if params.association == ASSOC_KNOWN:
        is_new = zs[:, 2] > state.n_active.astype(params.dtype)
        slots = jnp.clip(obs.index - 1, 0, state.capacity - 1)
    else:
        strips = sr_strips(state.P, state.capacity)
        is_new, slots = gate_batch(state, zs, Rs, params, strips=strips)
    first = state.n_active == 0
    is_new = jnp.logical_or(is_new, first)

    upd_valid = obs.valid & ~is_new
    state = sr_update_batch(state, zs, slots, Rs, upd_valid, params)

    def body(ii, s):
        def do(s):
            return sr_append(s, u, Rs[ii], obs.loc[ii], zs[ii, 2], params)
        return lax.cond(obs.valid[ii] & is_new[ii], do, lambda s: s, s)
    return lax.fori_loop(0, M, body, state)
