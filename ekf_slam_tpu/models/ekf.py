"""EKF-SLAM filter core: predict / append / update as pure jittable functions.

Covers the math of the reference's filter classes (EKF_SLAM.m, EKF_SLAM_UC.m,
append.m) re-designed for an accelerator:

* **predict** — the reference forms dense F and Q and does two full (3+2N)^2
  matmuls per tick (EKF_SLAM.m:40-51).  F differs from I in exactly two
  entries (EKF_SLAM.m:62-64), so F·P·Fᵀ is two row-axpys + two col-axpys:
  O(D) instead of O(D²) FLOPs, and XLA fuses it into a single pass over P.
* **update** — the reference materializes a sparse 5×D projection F_k, a 2×D
  H, and the dense (I−KH)·P product (EKF_SLAM_UC.m:135-146): O(D³) per
  observation.  Here H never exists: the update works on the five relevant
  rows/columns of P and applies a rank-2 correction P −= K·(HP), O(D²)
  bandwidth-bound work that is the optimal cost for a dense-covariance EKF.
* **append** — the reference grows x/P by concatenation (EKF_SLAM.m:79,91-97);
  here it is a masked dynamic-slice write into the padded state, so shapes
  stay static under jit.

All angles are degrees, matching the reference.  ``params.ref_compat``
reproduces the reference's numeric quirks (SURVEY.md §2.3); with it off the
mathematically-correct forms are used.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..config import ASSOC_KNOWN, EKFParams
from ..ops.angles import atan2d, cosd, sind, wrap_to_180, wrap_to_360
from ..ops.association import gate
from ..state import FilterState

_DEG = jnp.pi / 180.0


# ---------------------------------------------------------------------------
# Prediction
# ---------------------------------------------------------------------------

def motion_model(pose: jnp.ndarray, u: jnp.ndarray, ref_compat: bool
                 ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Differential-drive motion model + the two nonzero Jacobian entries.

    Reference EKF_SLAM.m:56-65: position advances along theta+dTheta; the
    Jacobian is evaluated at theta (pre-increment) and omits the pi/180
    factor a degree-valued theta requires — both reproduced when
    ``ref_compat`` (SURVEY.md §2.3)."""
    th, dD, dTh = pose[2], u[0], u[1]
    new_pose = jnp.stack([
        pose[0] + dD * cosd(th + dTh),
        pose[1] + dD * sind(th + dTh),
        th + dTh,
    ])
    if ref_compat:
        f13 = -dD * sind(th)
        f23 = dD * cosd(th)
    else:
        f13 = -dD * sind(th + dTh) * _DEG
        f23 = dD * cosd(th + dTh) * _DEG
    return new_pose, f13, f23


def predict(state: FilterState, u: jnp.ndarray, params: EKFParams
            ) -> FilterState:
    """EKF prediction step (reference EKF_SLAM.m:40-51).

    ``P ← F P Fᵀ + Q`` with F = I + f13·e0e2ᵀ + f23·e1e2ᵀ, applied as sparse
    row/col axpys; Q is the 3×3 block W·C·Wᵀ (EKF_SLAM.m:42-44)."""
    x, P = state.x, state.P
    th = x[2]
    dD, dTh = u[0], u[1]

    W = jnp.stack([dD * cosd(th), dD * sind(th), dTh])
    Qb = jnp.asarray(params.c_process, P.dtype) * jnp.outer(W, W)
    if any(q > 0 for q in params.q_floor):
        # constant per-tick pose-noise floor (config.EKFParams.q_floor) —
        # the reference's rank-1 Q adds nothing on straight driving
        Qb = Qb + jnp.diag(jnp.asarray(params.q_floor, P.dtype))

    new_pose, f13, f23 = motion_model(x[:3], u, params.ref_compat)
    new_pose = new_pose.at[2].set(wrap_to_360(new_pose[2]))
    x = x.at[:3].set(new_pose.astype(x.dtype))

    # F·P: rows 0,1 pick up f·(row 2).  Then (F·P)·Fᵀ: cols 0,1 pick up
    # f·(col 2 of F·P).  Finally add Q on the pose block.  Multiplies run
    # in the state dtype; results cast to P's storage dtype (bf16 storage
    # under params.cov_dtype keeps compute full-precision).
    row2 = P[2]
    if params.masked_writes:
        # where-selected full-plane form: every write is elementwise, so a
        # row-sharded P never moves (the scatter form below makes GSPMD
        # all-gather P, experiments/scaling_harness.py); untouched entries
        # are bit-identical (select, not add-zero).
        D = P.shape[0]
        ridx = jnp.arange(D)
        r = ridx[:, None]
        c = ridx[None, :]
        P = jnp.where(r == 0, P + (f13 * row2[None, :]).astype(P.dtype), P)
        P = jnp.where(r == 1, P + (f23 * row2[None, :]).astype(P.dtype), P)
        col2 = P[:, 2]
        P = jnp.where(c == 0, P + (f13 * col2[:, None]).astype(P.dtype), P)
        P = jnp.where(c == 1, P + (f23 * col2[:, None]).astype(P.dtype), P)
        Qb_full = jnp.zeros_like(P).at[:3, :3].set(Qb.astype(P.dtype))
        P = jnp.where((r < 3) & (c < 3), P + Qb_full, P)
    else:
        P = (P.at[0].add((f13 * row2).astype(P.dtype))
              .at[1].add((f23 * row2).astype(P.dtype)))
        col2 = P[:, 2]
        P = (P.at[:, 0].add((f13 * col2).astype(P.dtype))
              .at[:, 1].add((f23 * col2).astype(P.dtype)))
        P = P.at[:3, :3].add(Qb.astype(P.dtype))

    return state._replace(x=x, P=P)


# ---------------------------------------------------------------------------
# Landmark append (masked, fixed capacity)
# ---------------------------------------------------------------------------

def append(state: FilterState, u: jnp.ndarray, R2: jnp.ndarray,
           loc: jnp.ndarray, signature: jnp.ndarray, params: EKFParams
           ) -> FilterState:
    """Append a landmark into the next free slot (no-op when at capacity).

    Covariance blocks follow the reference's "SLAM for Dummies" construction
    (EKF_SLAM.m:84-97): new diag block jxr·P_rr·jxrᵀ + jz·R·jzᵀ, cross strip
    jxr·P[0:3,:] to the robot and every existing landmark.  Inactive columns
    of P are zero, so one strip write covers exactly the reference's loop.
    Note the reference's jz is built from (dD, dTheta) rather than the
    inverse-measurement bearing — reproduced as-is (SURVEY.md §2.3).
    """
    K = state.capacity

    def do_append(s: FilterState) -> FilterState:
        x, P = s.x, s.P
        ct = x.dtype                       # compute dtype (f32 under bf16 P)
        th = x[2]
        dD, dTh = u[0], u[1]
        jxr = jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], ct)
        jxr = jxr.at[0, 2].set(-dD * sind(th)).at[1, 2].set(dD * cosd(th))
        jz = jnp.stack([
            jnp.stack([cosd(dTh), -dD * sind(dTh)]),
            jnp.stack([sind(dTh), dD * cosd(dTh)]),
        ]).astype(ct)

        if params.masked_writes:
            # full-row contraction instead of slicing P's top rows: the
            # row slice of a row-sharded P reshards it (one D²/n all-to-all
            # per append, measured); padding jxr to [2,D] keeps the dot
            # local (partial sums + a [2,D] psum).
            jxr_pad = jnp.zeros((2, P.shape[0]), ct).at[:, :3].set(jxr)
            cross = (jxr_pad @ P.astype(ct)).astype(P.dtype)     # [2, D]
            diag = (cross[:, :3].astype(ct) @ jxr.T
                    + jz @ R2.astype(ct) @ jz.T).astype(P.dtype)
        else:
            cross = (jxr @ P[:3, :].astype(ct)).astype(P.dtype)  # [2, D]
            diag = (jxr @ P[:3, :3].astype(ct) @ jxr.T
                    + jz @ R2.astype(ct) @ jz.T).astype(P.dtype)

        slot = s.n_active
        row = jnp.asarray(3 + 2 * slot, jnp.int32)
        zero = jnp.zeros((), jnp.int32)
        if params.masked_writes:
            # where-selected writes: the dynamic-update-slice at a traced
            # row forces GSPMD to all-gather a row-sharded P (2×P bytes
            # per append, measured) — these stay local.
            D = P.shape[0]
            ridx = jnp.arange(D)
            is_r0 = (ridx == row)[:, None]
            is_r1 = (ridx == row + 1)[:, None]
            is_c0 = (ridx == row)[None, :]
            is_c1 = (ridx == row + 1)[None, :]
            P = jnp.where(is_r0, cross[0][None, :], P)
            P = jnp.where(is_r1, cross[1][None, :], P)
            P = jnp.where(is_c0, cross[0][:, None], P)
            P = jnp.where(is_c1, cross[1][:, None], P)
            dval = jnp.where(is_r0,
                             jnp.where(is_c0, diag[0, 0], diag[0, 1]),
                             jnp.where(is_c0, diag[1, 0], diag[1, 1]))
            P = jnp.where((is_r0 | is_r1) & (is_c0 | is_c1), dval, P)
        else:
            P = lax.dynamic_update_slice(P, cross, (row, zero))
            P = lax.dynamic_update_slice(P, cross.T, (zero, row))
            P = lax.dynamic_update_slice(P, diag, (row, row))
        x = lax.dynamic_update_slice(x, loc.astype(x.dtype), (row,))
        return FilterState(
            x=x, P=P,
            sig=s.sig.at[slot].set(jnp.asarray(signature, s.sig.dtype)),
            active=s.active.at[slot].set(True),
            n_active=s.n_active + 1,
        )

    return lax.cond(state.n_active < K, do_append, lambda s: s, state)


# ---------------------------------------------------------------------------
# Measurement update
# ---------------------------------------------------------------------------

def _inv2(S: jnp.ndarray) -> jnp.ndarray:
    """Closed-form 2×2 inverse (the reference's phi^-1, EKF_SLAM_UC.m:144)."""
    det = S[0, 0] * S[1, 1] - S[0, 1] * S[1, 0]
    return jnp.array([[S[1, 1], -S[0, 1]], [-S[1, 0], S[0, 0]]],
                     S.dtype) / det


def innovation(x: jnp.ndarray, slot, params: EKFParams
               ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Predicted measurement ẑ and the 2×5 measurement Jacobian blocks.

    Reference EKF_SLAM_UC.m:125-139 ("Line 13..15" of Thrun Table 10.1):
    δ = μ_k − x_r, q = δᵀδ, ẑ = [√q, wrapTo360(atan2d(δy,δx) − θ)],
    H = (1/q)·[−√qδx, −√qδy, 0, √qδx, √qδy; δy, −δx, −q, −δy, δx].
    Returns (ẑ, A=pose block [2,3], B=landmark block [2,2])."""
    th = x[2]
    lm = lax.dynamic_slice(x, (jnp.asarray(3 + 2 * slot, jnp.int32),), (2,))
    delta = lm - x[:2]
    q = jnp.sum(delta * delta)       # elementwise: no TF32 dot on a GPU
    # q = 0 only for padded/empty slots (or a landmark exactly at the robot,
    # degenerate in the reference too) — guard so masked lanes stay finite
    # (NaN * 0 would poison batched updates).
    q = jnp.where(q == 0, jnp.ones_like(q), q)
    sq = jnp.sqrt(q)
    zhat = jnp.stack([sq, wrap_to_360(atan2d(delta[1], delta[0]) - th)])
    dx, dy = delta[0], delta[1]
    A = jnp.stack([
        jnp.stack([-sq * dx, -sq * dy, jnp.zeros_like(q)]),
        jnp.stack([dy, -dx, -q]),
    ]) / q
    B = jnp.stack([
        jnp.stack([sq * dx, sq * dy]),
        jnp.stack([-dy, dx]),
    ]) / q
    return zhat, A, B


def update(state: FilterState, z: jnp.ndarray, slot, R2: jnp.ndarray,
           params: EKFParams) -> FilterState:
    """Kalman update against landmark ``slot`` (reference EKF_SLAM_UC.m:125-146).

    Rank-2 form: PHᵀ is assembled from P's pose columns + the slot's column
    pair, K = PHᵀ·Φ⁻¹, and P ← P − K·(HP).  Identical math to the reference's
    dense (I−KH)P, at O(D²) instead of O(D³)."""
    x, P = state.x, state.P
    D = x.shape[0]
    zhat, A, B = innovation(x, slot, params)
    Hs = jnp.concatenate([A, B], axis=1)                      # [2,5]

    col = jnp.asarray(3 + 2 * slot, jnp.int32)
    zero = jnp.zeros((), jnp.int32)
    G = jnp.concatenate(
        [P[:, :3], lax.dynamic_slice(P, (zero, col), (D, 2))], axis=1)  # [D,5]
    PHt = G @ Hs.T                                            # [D,2]

    rows5 = jnp.concatenate(
        [PHt[:3], lax.dynamic_slice(PHt, (col, zero), (2, 2))], axis=0)  # [5,2]
    S = Hs @ rows5 + R2.astype(x.dtype)                       # [2,2]
    Kg = PHt @ _inv2(S)                                       # [D,2]

    nu = z[:2].astype(x.dtype) - zhat
    if not params.ref_compat:
        # the reference never re-wraps the bearing innovation
        # (EKF_SLAM_UC.m:145) — correct mode does.
        nu = nu.at[1].set(wrap_to_180(nu[1]))

    x = x + Kg @ nu

    HP = Hs @ jnp.concatenate(
        [P[:3], lax.dynamic_slice(P, (col, zero), (2, D))], axis=0)  # [2,D]
    sdt = P.dtype                  # storage dtype (bf16 under cov_dtype)
    if params.joseph:
        # P' = P − K·B − (K·B)ᵀ + K·Φ·Kᵀ  (Joseph form, PSD-preserving)
        KB = Kg @ HP
        P = (P - KB - KB.T + Kg @ S @ Kg.T).astype(sdt)
    else:
        P = (P - Kg @ HP).astype(sdt)
    if params.symmetrize:
        P = 0.5 * (P + P.T)
    return state._replace(x=x, P=P)


# ---------------------------------------------------------------------------
# Per-tick measurement phase: association + append/update over the obs batch
# ---------------------------------------------------------------------------

def measurement_noise(z: jnp.ndarray, params: EKFParams) -> jnp.ndarray:
    """Measurement noise R [2,2] for one row z = [r, phi, ...].

    params.noise_model='scaled' (default): the reference's value-scaled
    R = diag(z_r*rc0, z_phi*rc1) (EKF_SLAM_UC.m:110).  'constant':
    R = diag(rc0², rc1²) with rc = (sigma_r m, sigma_phi deg) — honest
    constant stds (see config.EKFParams.noise_model for why the scaled
    form's bearing term is a gating hazard at scale)."""
    dt = params.dtype
    if params.noise_model in ("constant", "fit"):
        # 'fit' without an ObsBatch covariance degrades to the floor
        return jnp.diag(jnp.asarray(
            [params.rc[0] ** 2, params.rc[1] ** 2], dt))
    rc0 = jnp.asarray(params.rc[0], dt)
    rc1 = jnp.asarray(params.rc[1], dt)
    return jnp.diag(jnp.stack([z[0] * rc0, z[1] * rc1])).astype(dt)


def measurement_noise_batch(zs: jnp.ndarray, params: EKFParams
                            ) -> jnp.ndarray:
    """``measurement_noise`` vmapped over an [M,·] batch → [M,2,2]."""
    if params.noise_model == "fit":
        # the caller should route through obs_noise_batch (needs the
        # ObsBatch's propagated covariance); bare-z paths get the floor
        return jnp.broadcast_to(
            jnp.diag(jnp.asarray([params.rc[0] ** 2, params.rc[1] ** 2],
                                 params.dtype)),
            (zs.shape[0], 2, 2))
    return jax.vmap(lambda z: measurement_noise(z, params))(zs)


def obs_noise_batch(obs, zs: jnp.ndarray, params: EKFParams) -> jnp.ndarray:
    """Per-observation measurement noise [M,2,2] for an ObsBatch.

    noise_model='fit': the extractor-propagated anisotropic covariance
    (ObsBatch.R) plus the diag(rc0², rc1²) sensor floor — the honest
    model for perpendicular-foot features, whose error is dominated by
    lever_arm x fitted-angle uncertainty along the wall line (see
    config.EKFParams.noise_model).  Other modes ignore obs.R."""
    if params.noise_model == "fit" and obs.R is not None:
        floor = jnp.diag(jnp.asarray(
            [params.rc[0] ** 2, params.rc[1] ** 2], params.dtype))
        return obs.R.astype(params.dtype) + floor[None]
    return measurement_noise_batch(zs, params)


def measure(state: FilterState, obs: "ObsBatch", u: jnp.ndarray,
            params: EKFParams) -> FilterState:
    """Process one tick's observations sequentially (reference loop
    EKF_SLAM_UC.m:109-150: each update mutates P for the next, so the chain
    is inherently sequential — expressed as a fori_loop over fixed slots).

    ``obs`` is an ObsBatch (ops/ransac.py): padded rows
    [range, bearing_deg, index] + world-frame loc + valid mask.
    """
    def body(ii, s: FilterState) -> FilterState:
        z = jnp.stack([obs.rng[ii], obs.bearing[ii],
                       obs.index[ii].astype(params.dtype)])
        # R scales with the measured values (EKF_SLAM_UC.m:110) in the
        # default noise_model='scaled'; see measurement_noise.
        R2 = measurement_noise(z, params)
        if params.noise_model == "fit" and obs.R is not None:
            R2 = R2 + obs.R[ii].astype(params.dtype)
        loc = obs.loc[ii]

        def on_valid(s):
            if params.association == ASSOC_KNOWN:
                # EKF_SLAM.m:118: new iff the carried id exceeds the state's
                # landmark count; update indexes by the loop counter
                # (EKF_SLAM.m:123 quirk) or by the id in correct mode.
                is_new = z[2] > s.n_active.astype(z.dtype)
                slot = (ii if params.ref_compat
                        else obs.index[ii].astype(jnp.int32) - 1)
                slot = jnp.asarray(slot, jnp.int32)
            else:
                is_new, slot, _ = gate(s, z, R2, params)
            # First-ever landmark is appended unconditionally
            # (EKF_SLAM_UC.m:112-113).
            is_new = jnp.logical_or(is_new, s.n_active == 0)
            return lax.cond(
                is_new,
                lambda s: append(s, u, R2, loc, z[2], params),
                lambda s: update(s, z, slot, R2, params),
                s,
            )

        return lax.cond(obs.valid[ii], on_valid, lambda s: s, s)

    return lax.fori_loop(0, obs.rng.shape[0], body, state)
