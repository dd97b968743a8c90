"""Explicit-collective distributed batched update (shard_map + psum).

parallel/sharded.py lets GSPMD derive the collectives from sharding
constraints; this module spells the same algorithm out with ``shard_map``
so the communication pattern is explicit, auditable, and independently
benchmarkable.  With P row-tiled over the ``map`` axis (device d owns
``P[rows_d, :]``) and the dense observation model Hᵀ [D, 2M] replicated:

1. ``PHt_local = P_local @ Ht``                    — pure local matmul;
2. ``S = Σ_d Ht[rows_d]ᵀ @ PHt_local + R``        — **psum**: the
   Schur-complement combine (each device contributes its row
   block's interaction; 2M×2M ≈ 1 MB);
3. solve + gain: replicated 2M×2M Cholesky, ``Kg_local = PHt_local·S⁻¹``;
4. ``dx = Σ_d Kg_local @ nu`` restricted to local rows — assembled with a
   second **psum** of masked row contributions (D floats);
5. ``P_local −= Kg_local @ PHtᵀ`` — needs PHtᵀ's columns for ALL rows:
   one **all_gather** of PHt over the map axis (D×2M), the only
   volume-bearing collective.

Per-batch communication: O(D·M) bytes regardless of device count — the
EKF analog of sequence-parallel attention's collective footprint.
"""
from __future__ import annotations

from functools import partial
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import EKFParams
from ..models.batched import _innovation_blocks
from ..ops.angles import wrap_to_180
from ..state import FilterState


def build_dense_ht(state: FilterState, zs, slots, Rs, valid,
                   params: EKFParams):
    """Replicated observation-model pieces: dense Ht [D,2M], stacked
    innovation nu [2M], block-diag R [2M,2M] (identity in masked slots).
    Built in the COMPUTE dtype (state.x) — bf16 covariance storage keeps
    the small algebra f32, like models/batched.update_batch."""
    x = state.x
    D = x.shape[0]
    M = zs.shape[0]
    dt = x.dtype

    zhat, A, B = _innovation_blocks(x, slots, params)
    vmask = valid.astype(dt)
    A = A * vmask[:, None, None]
    B = B * vmask[:, None, None]

    nu = zs[:, :2].astype(dt) - zhat
    if not params.ref_compat:
        nu = nu.at[:, 1].set(wrap_to_180(nu[:, 1]))
    nu = (nu * vmask[:, None]).reshape(2 * M)

    cols = 3 + 2 * slots
    midx = jnp.arange(M)
    Ht = jnp.zeros((D, 2 * M), dt)
    Ht = Ht.at[0:3, :].set(A.transpose(2, 0, 1).reshape(3, 2 * M))
    rowpair = cols[:, None] + jnp.arange(2)[None, :]
    colpair = 2 * midx[:, None] + jnp.arange(2)[None, :]
    Ht = Ht.at[rowpair[:, :, None], colpair[:, None, :]].add(
        B.transpose(0, 2, 1))

    Rblk = jnp.zeros((2 * M, 2 * M), dt)
    Rblk = Rblk.at[2 * midx, 2 * midx].set(
        jnp.where(valid, Rs[:, 0, 0].astype(dt), 1.0))
    Rblk = Rblk.at[2 * midx + 1, 2 * midx + 1].set(
        jnp.where(valid, Rs[:, 1, 1].astype(dt), 1.0))
    return Ht, nu, Rblk


def systolic_syrk_downdate(P_local, W_full, axis: str, n_dev: int):
    """Distributed P ← P − W·Wᵀ exploiting symmetry: the SYRK correction
    (models/batched.syrk_downdate) brought to a row-sharded P.

    Round-robin over pair distances s = 0..⌊n/2⌋: at step s, device i
    computes the unordered-pair Gram ``acc = W_i·W_{i−s}ᵀ`` ONCE, writes
    its own tile (i, i−s), and ppermutes ``accᵀ`` to device i−s — whose
    mirror tile (i−s, i) is the transpose by definition.  So each device
    does (⌊n/2⌋+1)/n of the full Gram's flops and the output is
    bit-symmetric (both tiles of a pair come from the same accumulator).

    Communication: ⌊(n−1)/2⌋ ppermutes of one (D/n)² tile each ride the
    ``axis`` ring — O(D²/(2n)) bytes/device/update.  That is OUTSIDE the
    O(D·M) budget of the gemm-form update (module doc), so this is a
    trade: the exchange beats the recompute whenever
    bytes/(link rate) < 2·t²·2M/(matmul rate).  SCALING.md carries the
    collective audit; the gemm correction stays available where the
    budget rules.

    For even n the antipodal step s = n/2 is computed on both members of
    the pair (comm-free) rather than exchanged.

    Must be called INSIDE a shard_map body with ``axis`` bound.
    P_local: [D/n, D]; W_full: [D, 2M] replicated."""
    D = W_full.shape[0]
    r = D // n_dev
    dt = P_local.dtype
    fast16 = dt == jnp.bfloat16
    acc_dt = jnp.float32 if dt in (jnp.bfloat16, jnp.float32) else dt
    i = jax.lax.axis_index(axis)
    zero = jnp.zeros((), jnp.int32)

    def wtile(j):
        t = jax.lax.dynamic_slice(
            W_full, (j.astype(jnp.int32) * r, zero), (r, W_full.shape[1]))
        return t.astype(jnp.bfloat16) if fast16 else t

    def sub_tile(out, j, acc):
        """out[:, j·r:(j+1)·r] −= acc, subtracting in the accumulation
        dtype (the storage may be bf16)."""
        c0 = (j.astype(jnp.int32) * r, )
        cur = jax.lax.dynamic_slice(out, (zero, c0[0]), (r, r))
        new = (cur.astype(acc_dt) - acc).astype(dt)
        return jax.lax.dynamic_update_slice(out, new, (zero, c0[0]))

    Wi = wtile(i)
    out = P_local
    half = n_dev // 2
    for s in range(half + 1):
        j = jnp.mod(i - s, n_dev)
        acc = jnp.matmul(Wi, wtile(j).T, preferred_element_type=acc_dt)
        out = sub_tile(out, j, acc)
        if s == 0 or (n_dev % 2 == 0 and s == half):
            continue          # diagonal / antipodal double-compute steps
        perm = [(k, (k - s) % n_dev) for k in range(n_dev)]
        accT = jax.lax.ppermute(acc.T, axis, perm)   # from device i+s
        out = sub_tile(out, jnp.mod(i + s, n_dev), accT)
    return out


def sharded_update_batch(state: FilterState, zs, slots, Rs, valid,
                         params: EKFParams, mesh: Mesh,
                         axis: str = "map") -> FilterState:
    """Distributed joint update with explicit collectives (see module doc).

    ``state.P`` must have D divisible by the mesh's map axis (use
    ``init_state(pad_to_multiple_of=...)``).

    ``params.correction`` selects the covariance-correction form:
      'gemm' — Kg·PHtᵀ with one all_gather of PHt (O(D·M) bytes, the
               audited default);
      'syrk' — W = PHt·L⁻ᵀ, one all_gather of W (same O(D·M) bytes in
               place of PHt's), then the systolic symmetric downdate
               (half flops + bit-symmetric P, plus O(D²/2n) ppermute
               bytes — see systolic_syrk_downdate for the trade)."""
    Ht, nu, Rblk = build_dense_ht(state, zs, slots, Rs, valid, params)
    D = state.x.shape[0]
    n_dev = mesh.shape[axis]
    rows_per = D // n_dev
    dt = state.P.dtype                 # covariance storage dtype
    ct = state.x.dtype                 # compute dtype (f32/f64)
    fast16 = dt == jnp.bfloat16
    syrk = params.correction == "syrk"

    def mm(a, b):
        """Large GEMM in the storage precision, accumulated in ct —
        models/batched.update_batch's mixed-precision policy."""
        if fast16:
            return jnp.matmul(a.astype(jnp.bfloat16),
                              b.astype(jnp.bfloat16),
                              preferred_element_type=ct)
        return a @ b

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(axis, None), P(), P(), P()),
             out_specs=(P(axis, None), P()))
    def upd(P_local, Ht, nu, Rblk):
        d = jax.lax.axis_index(axis)
        r0 = jnp.asarray(d * rows_per, jnp.int32)
        zero = jnp.zeros((), jnp.int32)

        PHt_local = mm(P_local, Ht)                          # [rows,2M] ct
        # Schur combine: each device contributes its row block
        Ht_rows = jax.lax.dynamic_slice(
            Ht, (r0, zero), (rows_per, Ht.shape[1]))         # [rows,2M]
        S = jax.lax.psum(Ht_rows.T @ PHt_local, axis)        # [2M,2M] ct
        S = S + Rblk

        if syrk:
            # Kg·(H·P) = W·Wᵀ with W = PHᵀ·L⁻ᵀ (S = L·Lᵀ): same algebra
            # as the single-chip syrk path (models/batched.update_batch)
            L = jnp.linalg.cholesky(S)
            eye = jnp.eye(S.shape[0], dtype=ct)
            Linv = jax.lax.linalg.triangular_solve(
                L, eye, left_side=True, lower=True)
            W_local = PHt_local @ Linv.T                     # [rows,2M] ct
            dx_local = W_local @ (Linv @ nu)                 # [rows]
            dx = jnp.zeros((D,), ct)
            dx = jax.lax.dynamic_update_slice(dx, dx_local, (r0,))
            dx = jax.lax.psum(dx, axis)
            # one all_gather of W in the STORAGE dtype (bf16 halves the
            # O(D·M) bytes AND matches the single-chip kernel's W
            # quantization), then the mirror exchange accumulates in ct
            W_full = jax.lax.all_gather(W_local.astype(dt), axis,
                                        tiled=True)
            P_local = systolic_syrk_downdate(P_local, W_full, axis,
                                             n_dev)
            return P_local, dx

        chol = jax.scipy.linalg.cho_factor(S, lower=True)
        Kg_local = jax.scipy.linalg.cho_solve(chol, PHt_local.T).T

        # state correction: scatter local row contributions into [D]
        dx_local = Kg_local @ nu                             # [rows]
        dx = jnp.zeros((D,), ct)
        dx = jax.lax.dynamic_update_slice(dx, dx_local, (r0,))
        dx = jax.lax.psum(dx, axis)                          # [D] replicated

        # covariance correction needs PHtᵀ for ALL rows: one all_gather
        # (storage dtype — halves the volume-bearing collective at bf16)
        PHt_full = jax.lax.all_gather(PHt_local.astype(dt), axis,
                                      tiled=True)            # [D,2M]
        P_local = (P_local.astype(ct)
                   - mm(Kg_local, PHt_full.T)).astype(dt)
        return P_local, dx

    P_new, dx = upd(state.P, Ht, nu, Rblk)
    x = state.x + dx
    if params.symmetrize:
        # NOTE: transposing a row-sharded D×D matrix is a full all-to-all
        # outside the audited collective set above — O(D²/n) bytes/device.
        # Prefer params.joseph/srekf for PSD control in sharded runs; this
        # stays for parity with the single-device flag.
        P_new = 0.5 * (P_new + P_new.T)
    return state._replace(x=x, P=P_new)


def sr_update_sharded(state: FilterState, zs, slots, Rs, valid,
                      params: EKFParams, mesh: Mesh,
                      axis: str = "map") -> FilterState:
    """Distributed closed-form Andrews square-root update (the
    models/srekf_fast.sr_update_andrews math) over a ROW-SHARDED general
    factor S — PSD-by-construction filtering at map scale (round-4 lift
    of the sharded session's square-root rejection).

    The collective footprint is SMALLER than the dense path's: the
    correction S' = S − (S·Gᵀ)·Y is row-local once G and Y are known, so
    the only collectives are

      1. one psum assembling H·S [2M,D] from per-device row
         contributions (H touches the 3 pose rows + one row pair per
         gated landmark — each device contributes the rows it owns);
      2. the usual O(D) psum assembling the state correction.

    No all-gather at all — O(D·M) bytes total, vs the dense form's PHt
    gather PLUS the same-size psum.  The 2M×2M innovation algebra
    (Cholesky, triangular inverses) is computed replicated on every
    device, like the dense path's solve.

    Chunking (`params.update_chunks`) applies outside, as in
    sr_update_chunked."""
    from ..models.batched import _innovation_blocks
    from ..models.srekf_fast import _sqrt_noise_block

    x = state.x
    Dtot = state.P.shape[0]          # includes noise-buffer columns
    M = zs.shape[0]
    dt = state.P.dtype
    n_dev = mesh.shape[axis]
    # the row-local math below assumes an even row split with ALL THREE
    # pose rows on device 0 (Spose = S_local[:3] masked by d==0) — a
    # misconfigured mesh would silently drop pose rows, so fail loudly
    # at trace time instead (pad the state: init_state(pad_to_multiple_of
    # =n_dev or a larger tile))
    if Dtot % n_dev != 0:
        raise ValueError(
            f"sr_update_sharded: factor dim {Dtot} is not divisible by "
            f"the {n_dev}-device {axis!r} axis — pad the state so the "
            "row shards are even")
    rows_per = Dtot // n_dev
    if rows_per < 3:
        raise ValueError(
            f"sr_update_sharded: {rows_per} rows/device < the 3 pose "
            "rows that must live on device 0 — use fewer devices or a "
            "larger state")

    # replicated observation-model pieces (masked like the single-chip
    # path: invalid slots → zero Jacobian rows, identity R blocks)
    zhat, A, B = _innovation_blocks(x, slots, params)
    vmask = valid.astype(dt)
    A = A * vmask[:, None, None]                               # [M,2,3]
    B = B * vmask[:, None, None]                               # [M,2,2]
    nu = zs[:, :2].astype(dt) - zhat
    if not params.ref_compat:
        nu = nu.at[:, 1].set(wrap_to_180(nu[:, 1]))
    nu = (nu * vmask[:, None]).reshape(2 * M)
    sqR = _sqrt_noise_block(Rs, valid, dt)                     # [2M,2M]
    rows = (3 + 2 * slots).astype(jnp.int32)                   # i32[M]

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(axis, None), P(), P(), P(), P(), P()),
             out_specs=(P(axis, None), P()))
    def upd(S_local, A, B, nu, sqR, rows):
        d = jax.lax.axis_index(axis)
        r0 = (d * rows_per).astype(jnp.int32)

        # -- 1. H·S from locally-owned rows, psum-assembled ------------
        # pose rows 0..2 live on device 0 (masked elsewhere)
        pose_own = (d == 0).astype(dt)
        Spose = S_local[:3, :] * pose_own                      # [3,Dtot]
        HS = jnp.einsum("mij,jd->mid", A, Spose)               # [M,2,Dtot]
        # landmark coordinate rows: global rows (rows+j); a pair may
        # straddle a device boundary, so each of the two rows is gathered
        # and masked independently
        for j in (0, 1):
            g = rows + j                                       # i32[M]
            own = ((g >= r0) & (g < r0 + rows_per))
            loc = jnp.clip(g - r0, 0, rows_per - 1)
            Srows = jnp.take(S_local, loc, axis=0)             # [M,Dtot]
            Srows = Srows * own.astype(dt)[:, None]
            HS = HS + B[:, :, j][:, :, None] * Srows[:, None, :]
        HS = jax.lax.psum(HS.reshape(2 * M, Dtot), axis)       # [2M,Dtot]

        # -- 2. replicated innovation algebra (srekf_fast math) --------
        Sm = HS @ HS.T
        idx = jnp.arange(M)
        d0, d1 = 2 * idx, 2 * idx + 1
        Sm = Sm.at[d0, d0].add(sqR[d0, d0] ** 2)
        Sm = Sm.at[d1, d0].add(sqR[d1, d0] * sqR[d0, d0])
        Sm = Sm.at[d0, d1].add(sqR[d1, d0] * sqR[d0, d0])
        Sm = Sm.at[d1, d1].add(sqR[d1, d0] ** 2 + sqR[d1, d1] ** 2)
        eye = jnp.eye(2 * M, dtype=dt)
        C = jnp.linalg.cholesky(Sm)
        Cinv = jax.lax.linalg.triangular_solve(C, eye, left_side=True,
                                               lower=True)
        G = Cinv @ HS                                          # [2M,Dtot]
        Wm = Cinv @ sqR
        y = Cinv @ nu
        IW = Wm.at[jnp.arange(2 * M), jnp.arange(2 * M)].add(1.0)
        IWinv = jax.lax.linalg.triangular_solve(IW, eye, left_side=True,
                                                lower=True)
        Y = IWinv @ G                                          # [2M,Dtot]

        # -- 3. row-local factor correction + psum-assembled dx --------
        SGt_local = S_local @ G.T                              # [rows,2M]
        dx_local = SGt_local @ y
        dx = jnp.zeros((Dtot,), dt)
        dx = jax.lax.dynamic_update_slice(dx, dx_local, (r0,))
        dx = jax.lax.psum(dx, axis)
        S_local = S_local - SGt_local @ Y                      # local GEMM
        return S_local, dx

    S_new, dx = upd(state.P, A, B, nu, sqR, rows)
    x = state.x + dx
    act = jnp.arange(Dtot) < 3 + 2 * state.n_active
    return state._replace(x=x, P=S_new * act[:, None].astype(dt))


def sr_update_sharded_chunked(state: FilterState, zs, slots, Rs, valid,
                              params: EKFParams, mesh: Mesh,
                              axis: str = "map") -> FilterState:
    """``sr_update_sharded`` in ``params.update_chunks`` sequential
    chunks — the same scheduling economics as srekf_fast's
    sr_update_chunked (quadratic innovation terms shrink by G²)."""
    G = max(1, int(params.update_chunks))
    M = zs.shape[0]
    if G == 1 or G >= M:
        return sr_update_sharded(state, zs, slots, Rs, valid, params,
                                 mesh, axis)
    m = -(-M // G)
    for g0 in range(0, M, m):
        sl = slice(g0, min(g0 + m, M))
        state = sr_update_sharded(state, zs[sl], slots[sl], Rs[sl],
                                  valid[sl], params, mesh, axis)
    return state


def sr_measure_shard_map(state: FilterState, obs, u, params: EKFParams,
                         mesh: Mesh, axis: str = "map") -> FilterState:
    """Square-root measurement phase over the sharded mesh: gate from
    full-width factor strips, one chunked distributed Andrews update,
    then the O(D) sequential appends (GSPMD-placed dynamic writes) —
    the srekf_fast.sr_measure_fast flow with the joint update routed
    through sr_update_sharded."""
    import jax
    from jax import lax

    from ..models import ekf
    from ..models.srekf import sr_append, sr_strips
    from ..ops.association import gate_batch

    zs = jnp.stack([obs.rng, obs.bearing,
                    obs.index.astype(params.dtype)], axis=-1)
    Rs = ekf.obs_noise_batch(obs, zs, params)

    strips = sr_strips(state.P, state.capacity, triangular=False)
    is_new, slots = gate_batch(state, zs, Rs, params, strips=strips)
    first = state.n_active == 0
    is_new = jnp.logical_or(is_new, first)

    upd_valid = obs.valid & ~is_new
    state = sr_update_sharded_chunked(state, zs, slots, Rs, upd_valid,
                                      params, mesh, axis)

    def body(ii, s):
        def do(s):
            return sr_append(s, u, Rs[ii], obs.loc[ii], zs[ii, 2], params)
        return lax.cond(obs.valid[ii] & is_new[ii], do, lambda s: s, s)
    return lax.fori_loop(0, zs.shape[0], body, state)


def measure_batched_shard_map(state: FilterState, obs, u, params: EKFParams,
                              mesh: Mesh, axis: str = "map") -> FilterState:
    """Measurement phase with the explicit-collective joint update.

    Mirrors models/batched.measure_batched (gate against the tick's prior
    state → ONE joint update → sequential masked appends) but routes the
    rank-2M update through ``sharded_update_batch`` so every collective is
    explicit (module doc).  Appends are O(D) dynamic-slice writes left to
    GSPMD.  Selected by ShardedSlamSession(update_path='shard_map')."""
    import jax
    from jax import lax

    from ..models import ekf
    from ..ops.association import gate_batch

    zs = jnp.stack([obs.rng, obs.bearing,
                    obs.index.astype(params.dtype)], axis=-1)
    Rs = ekf.obs_noise_batch(obs, zs, params)

    is_new, slots = gate_batch(state, zs, Rs, params)
    first = state.n_active == 0
    is_new = jnp.logical_or(is_new, first)

    upd_valid = obs.valid & ~is_new
    state = sharded_update_batch(state, zs, slots, Rs, upd_valid, params,
                                 mesh, axis=axis)

    def body(ii, s):
        def do(s):
            return ekf.append(s, u, Rs[ii], obs.loc[ii], zs[ii, 2], params)
        return lax.cond(obs.valid[ii] & is_new[ii], do, lambda s: s, s)
    return lax.fori_loop(0, zs.shape[0], body, state)
