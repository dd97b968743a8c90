"""Fast square-root filter (models/srekf_fast.py) vs the dense paths.

f64 exact-arithmetic parity of the closed-form Andrews update against
models/batched.update_batch, the zero-column invariants that make the O(D)
noise absorption and appends valid for a GENERAL factor, and the f32
PSD-by-construction property at the conditioning stress the QR path was too
slow to protect."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ekf_slam_tpu.config import EKFParams
from ekf_slam_tpu.models import batched, ekf, srekf, srekf_fast
from ekf_slam_tpu.ops.observations import obs_from_rows
from ekf_slam_tpu.state import init_state

from test_batched import measurement_of
from test_ekf_core import make_pair

PARAMS = EKFParams(capacity=8, max_obs=4, ref_compat=False,
                   dtype=jnp.float64)
BUF = 6   # noise-buffer columns used by the unit tests


def with_buffer(state, extra=BUF):
    """Embed a dense state into one padded by ``extra`` buffer dims."""
    D = state.dim
    x = jnp.zeros((D + extra,), state.x.dtype).at[:D].set(state.x)
    P = jnp.zeros((D + extra, D + extra), state.P.dtype).at[:D, :D].set(
        state.P)
    return state._replace(x=x, P=P)


def general_factor(state, seed=7):
    """Factor the padded dense state, then mix the active block by a random
    orthogonal Q (S·Sᵀ invariant) so the factor is genuinely non-triangular."""
    sr = srekf.factor_from_state(state)
    d = 3 + 2 * int(state.n_active)
    Q = jnp.asarray(np.linalg.qr(
        np.random.default_rng(seed).normal(size=(d, d)))[0], state.P.dtype)
    S = sr.P.at[:d, :d].set(sr.P[:d, :d] @ Q)
    return sr._replace(P=S)


def assert_factor_matches(sr_state, dense_state, rtol=1e-8, atol=1e-10):
    d = dense_state.dim
    P_sr = np.asarray(sr_state.P @ sr_state.P.T)[:d, :d]
    np.testing.assert_allclose(P_sr, np.asarray(dense_state.P),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(np.asarray(sr_state.x[:d]),
                               np.asarray(dense_state.x),
                               rtol=rtol, atol=atol)


def batch_of(state, slots, nudge=0.05):
    zs, Rs = [], []
    for i, slot in enumerate(slots):
        z = measurement_of(state, slot)
        z[0] += nudge * (1 + i)
        zs.append(z)
        Rs.append(np.diag([z[0] * 0.1, abs(z[1]) * 5.0 + 0.1]))
    return (jnp.asarray(np.stack(zs)), jnp.asarray(slots, jnp.int32),
            jnp.asarray(np.stack(Rs)), jnp.ones((len(slots),), bool))


def test_update_andrews_matches_dense():
    """S'·S'ᵀ equals the dense joint posterior exactly (f64), for both a
    triangular and a fully general (orthogonally mixed) factor."""
    state, _ = make_pair(4, seed=2)
    zs, slots, Rs, valid = batch_of(state, [0, 2, 3])
    dense = batched.update_batch(state, zs, slots, Rs, valid, PARAMS)
    for sr0 in (srekf.factor_from_state(with_buffer(state)),
                general_factor(with_buffer(state))):
        sr1 = srekf_fast.sr_update_andrews(sr0, zs, slots, Rs, valid,
                                           PARAMS)
        assert_factor_matches(sr1, dense, rtol=1e-7, atol=1e-9)


def test_update_masked_lanes_are_noops():
    state, _ = make_pair(3, seed=4)
    zs, slots, Rs, _ = batch_of(state, [0, 1, 2])
    valid = jnp.array([True, False, True])
    sr0 = general_factor(with_buffer(state))
    full = srekf_fast.sr_update_andrews(sr0, zs, slots, Rs, valid, PARAMS)
    keep = jnp.array([0, 2])
    only = srekf_fast.sr_update_andrews(
        sr0, zs[keep], slots[keep], Rs[keep], jnp.ones((2,), bool), PARAMS)
    np.testing.assert_allclose(np.asarray(full.x), np.asarray(only.x),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(full.P @ full.P.T), np.asarray(only.P @ only.P.T),
        rtol=1e-8, atol=1e-11)


def test_update_chunked_equals_sequential_chunks():
    """G-chunked schedule ≡ applying the Andrews update chunk by chunk."""
    state, _ = make_pair(4, seed=5)
    zs, slots, Rs, valid = batch_of(state, [0, 1, 2, 3])
    sr0 = general_factor(with_buffer(state))
    p2 = dataclasses.replace(PARAMS, update_chunks=2)
    chunked = srekf_fast.sr_update_chunked(sr0, zs, slots, Rs, valid, p2)
    manual = srekf_fast.sr_update_andrews(sr0, zs[:2], slots[:2], Rs[:2],
                                          valid[:2], PARAMS)
    manual = srekf_fast.sr_update_andrews(manual, zs[2:], slots[2:], Rs[2:],
                                          valid[2:], PARAMS)
    np.testing.assert_allclose(np.asarray(chunked.P), np.asarray(manual.P),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(np.asarray(chunked.x), np.asarray(manual.x),
                               rtol=1e-12, atol=1e-14)


def test_predict_fast_matches_dense():
    """O(D) predict (row-axpys + noise column) reproduces F·P·Fᵀ + c·w·wᵀ."""
    state, _ = make_pair(3, seed=3)
    u = jnp.array([0.15, 7.0])
    dense = ekf.predict(state, u, PARAMS)
    sr0 = srekf.factor_from_state(with_buffer(state))
    col = state.dim  # first buffer column
    sr1 = srekf_fast.sr_predict_fast(sr0, u, PARAMS, col)
    assert_factor_matches(sr1, dense, rtol=1e-9, atol=1e-12)
    # the scheduled column now holds √c·w; the OTHER buffer columns stay 0
    S = np.asarray(sr1.P)
    assert np.any(S[:3, col] != 0)
    assert np.all(S[:, col + 1:] == 0)


def test_zero_column_invariant_through_ops():
    """Fresh slot columns and unscheduled buffer columns stay EXACTLY zero
    through predict/update/append — the invariant that makes the O(D)
    noise deposit and sr_append's block write exact for a general factor."""
    state, _ = make_pair(3, seed=6)          # 3 active of capacity 8
    sr = srekf.factor_from_state(with_buffer(state))
    d0 = state.dim                            # buffer start
    fresh0 = 3 + 2 * 3                        # first fresh slot column

    u = jnp.array([0.1, 4.0])
    sr = srekf_fast.sr_predict_fast(sr, u, PARAMS, d0)
    zs, slots, Rs, valid = batch_of(state, [0, 2])
    sr = srekf_fast.sr_update_andrews(sr, zs, slots, Rs, valid, PARAMS)
    S = np.asarray(sr.P)
    assert np.all(S[:, fresh0:d0] == 0)       # fresh slot columns
    assert np.all(S[:, d0 + 1:] == 0)         # unscheduled buffer columns

    R = jnp.asarray(np.diag([0.02, 0.4]))
    sr = srekf.sr_append(sr, u, R, jnp.array([1.1, -0.8]), 4.0, PARAMS)
    sr = srekf_fast.sr_predict_fast(sr, u, PARAMS, d0 + 1)
    S = np.asarray(sr.P)
    assert int(sr.n_active) == 4
    assert np.all(S[:, fresh0 + 2:d0] == 0)   # remaining fresh slots
    assert np.all(S[:, d0 + 2:] == 0)         # remaining buffer columns


def test_append_on_general_factor_matches_dense():
    state, _ = make_pair(2, seed=8)
    u = jnp.array([0.1, 3.0])
    R = jnp.asarray(np.diag([0.02, 0.5]))
    loc = jnp.array([1.5, -0.7])
    dense = ekf.append(state, u, R, loc, 3.0, PARAMS)
    sr = srekf.sr_append(general_factor(with_buffer(state)), u, R, loc,
                         3.0, PARAMS)
    assert int(sr.n_active) == int(dense.n_active) == 3
    assert_factor_matches(sr, dense, rtol=1e-8, atol=1e-10)


def test_strips_from_general_factor():
    """sr_strips(triangular=False) reads the gate's P pieces from a
    general factor: pose block, pose↔landmark strip, diagonal blocks."""
    state, _ = make_pair(4, seed=9)
    S = general_factor(with_buffer(state)).P
    Prr, Prl, Pll = srekf.sr_strips(S, PARAMS.capacity, triangular=False)
    P = np.asarray(state.P)
    K = PARAMS.capacity
    np.testing.assert_allclose(np.asarray(Prr), P[:3, :3],
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(Prl),
        P[:3, 3:3 + 2 * K].reshape(3, K, 2).transpose(1, 0, 2),
        rtol=1e-9, atol=1e-12)
    for k in range(K):
        blk = P[3 + 2 * k:5 + 2 * k, 3 + 2 * k:5 + 2 * k]
        np.testing.assert_allclose(np.asarray(Pll[k]), blk,
                                   rtol=1e-9, atol=1e-12)


def test_measure_fast_matches_batched():
    """Full measurement phase (gate → chunked Andrews → appends) against
    the dense batched phase: same associations, same posterior, same
    appended landmark."""
    rng = np.random.default_rng(0)
    state, _ = make_pair(3, seed=10)
    u = jnp.array([0.05, 2.0])
    z0 = measurement_of(state, 0, noise=0.01, rng=rng)
    z2 = measurement_of(state, 2, noise=0.01, rng=rng)
    rows = [z0.tolist(), z2.tolist(), [1.5, 100.0, 9.0]]   # 2 updates + new
    locs = [[0.0, 0.0], [0.0, 0.0], [-0.3, 1.5]]
    obs = obs_from_rows(rows, locs, PARAMS.max_obs, jnp.float64)
    dense = batched.measure_batched(state, obs, u, PARAMS)
    sr = srekf_fast.sr_measure_fast(general_factor(with_buffer(state)),
                                    obs, u, PARAMS)
    assert int(sr.n_active) == int(dense.n_active) == 4
    assert_factor_matches(sr, dense, rtol=1e-7, atol=1e-9)


def test_recompress_restores_triangular_zero_buffer():
    state, _ = make_pair(3, seed=11)
    sr = srekf.factor_from_state(with_buffer(state))
    u = jnp.array([0.1, 4.0])
    for j in range(3):                       # consume three buffer columns
        sr = srekf_fast.sr_predict_fast(sr, u, PARAMS, state.dim + j)
    P_before = np.asarray(sr.P @ sr.P.T)
    sr = srekf_fast.sr_recompress(sr)
    S = np.asarray(sr.P)
    assert np.allclose(S, np.tril(S))                  # triangular again
    assert np.all(S[:, state.dim:] == 0)               # buffer reclaimed
    np.testing.assert_allclose(np.asarray(sr.P @ sr.P.T), P_before,
                               rtol=1e-9, atol=1e-11)  # same covariance


def test_session_srekf_fast_matches_batched():
    """update_mode='srekf_fast' end-to-end (predict → gate → Andrews →
    append → periodic recompress) tracks the dense batched session at f64;
    sr_noise_buffer < T forces several recompressions along the way."""
    from ekf_slam_tpu.session import SlamSession
    from test_sim_session import SIM_RANSAC, make_traj

    traj, _ = make_traj(T=60)
    common = dict(capacity=16, max_obs=8, ref_compat=False,
                  dtype=jnp.float64)
    sr_sess = SlamSession(
        algorithm="EKF_SLAM_UC",
        ekf_params=EKFParams(update_mode="srekf_fast", sr_noise_buffer=8,
                             **common),
        ransac_params=SIM_RANSAC, seed=1)
    dn_sess = SlamSession(
        algorithm="EKF_SLAM_UC",
        ekf_params=EKFParams(update_mode="batched", **common),
        ransac_params=SIM_RANSAC, seed=1)
    sr_carry, sr_outs = sr_sess.run(traj.odom, traj.ranges,
                                    traj.beam_angles)
    dn_carry, dn_outs = dn_sess.run(traj.odom, traj.ranges,
                                    traj.beam_angles)
    assert int(sr_carry.filt.n_active) == int(dn_carry.filt.n_active) >= 1
    assert int(sr_carry.sr_tick) == 60
    np.testing.assert_allclose(np.asarray(sr_outs.pose),
                               np.asarray(dn_outs.pose),
                               rtol=1e-6, atol=1e-7)
    d = 3 + 2 * int(dn_carry.filt.n_active)
    P_sr = np.asarray(sr_carry.filt.P @ sr_carry.filt.P.T)[:d, :d]
    np.testing.assert_allclose(P_sr, np.asarray(dn_carry.filt.P)[:d, :d],
                               rtol=1e-5, atol=1e-7)


def test_update_panel_matches_dense_and_is_triangular():
    """The round-4 strict-triangular update (Andrews + fused blocked
    re-triangularization): posterior equals the dense joint update at f64
    AND the output factor is lower-triangular with the buffer columns
    exactly zero — per-update triangularity without the O((2M+D)³) QR."""
    state, _ = make_pair(4, seed=21)
    zs, slots, Rs, valid = batch_of(state, [0, 1, 3])
    dense = batched.update_batch(state, zs, slots, Rs, valid, PARAMS)
    sr0 = general_factor(with_buffer(state))
    sr1 = srekf_fast.sr_update_panel(sr0, zs, slots, Rs, valid, PARAMS)
    assert_factor_matches(sr1, dense, rtol=1e-7, atol=1e-9)
    S = np.asarray(sr1.P)
    assert np.allclose(S, np.tril(S))
    assert np.all(S[:, state.dim:] == 0)


def test_session_triangular_every_tick():
    """sr_noise_buffer=1 turns srekf_fast into the strict-triangular
    mode: the per-tick recompress cond always fires, so the POST-TICK
    factor is always lower-triangular; trajectory parity vs the dense
    batched session holds as in the buffered case."""
    from ekf_slam_tpu.session import SlamSession
    from test_sim_session import SIM_RANSAC, make_traj

    traj, _ = make_traj(T=40)
    common = dict(capacity=16, max_obs=8, ref_compat=False,
                  dtype=jnp.float64)
    tri_sess = SlamSession(
        algorithm="EKF_SLAM_UC",
        ekf_params=EKFParams(update_mode="srekf_fast", sr_noise_buffer=1,
                             **common),
        ransac_params=SIM_RANSAC, seed=1)
    dn_sess = SlamSession(
        algorithm="EKF_SLAM_UC",
        ekf_params=EKFParams(update_mode="batched", **common),
        ransac_params=SIM_RANSAC, seed=1)
    tr_carry, tr_outs = tri_sess.run(traj.odom, traj.ranges,
                                     traj.beam_angles)
    dn_carry, dn_outs = dn_sess.run(traj.odom, traj.ranges,
                                    traj.beam_angles)
    assert int(tr_carry.filt.n_active) == int(dn_carry.filt.n_active) >= 1
    S = np.asarray(tr_carry.filt.P)
    assert np.allclose(S, np.tril(S))          # triangular after EVERY tick
    assert np.all(S[:, tri_sess.ekf_params.dim:] == 0)   # buffer reclaimed
    np.testing.assert_allclose(np.asarray(tr_outs.pose),
                               np.asarray(dn_outs.pose),
                               rtol=1e-6, atol=1e-7)


def test_f32_panel_update_stays_psd_and_triangular():
    """The strict-triangular path under the f32 tiny-R stress: the
    re-triangularization goes through the factor Gram (PSD by
    construction), so the triangular factor neither goes indefinite nor
    non-finite where the dense form drifts."""
    p32 = dataclasses.replace(PARAMS, dtype=jnp.float32)
    state, _ = make_pair(4, seed=23)
    state = state._replace(
        x=state.x.astype(jnp.float32),
        P=(state.P * 1e4).astype(jnp.float32),
        sig=state.sig.astype(jnp.float32))
    sr = srekf.factor_from_state(with_buffer(state))

    zs, slots, _, valid = batch_of(state, [0, 1, 2, 3], nudge=0.0)
    Rs = jnp.tile(jnp.asarray(np.diag([1e-6, 1e-6]), jnp.float32),
                  (4, 1, 1))
    zs = zs.astype(jnp.float32)

    @jax.jit
    def ticks(sr):
        def body(s, _):
            return srekf_fast.sr_update_panel(s, zs, slots, Rs, valid,
                                              p32), None
        return jax.lax.scan(body, sr, None, length=40)[0]

    sr = ticks(sr)
    S = np.asarray(sr.P)
    assert np.all(np.isfinite(S))
    assert np.allclose(S, np.tril(S))
    d = 3 + 2 * int(state.n_active)
    P_sr = (S @ S.T)[:d, :d].astype(np.float64)
    eig = np.linalg.eigvalsh(0.5 * (P_sr + P_sr.T)).min()
    assert eig >= -1e-6 * float(np.abs(P_sr).max())


def test_config_rejects_ignored_dense_knobs():
    for kw in (dict(cov_dtype=jnp.bfloat16),
               dict(joseph=True), dict(symmetrize=True),
               dict(masked_writes=True), dict(pht_mode="rows")):
        with pytest.raises(ValueError):
            EKFParams(update_mode="srekf_fast", **kw)
        with pytest.raises(ValueError):
            EKFParams(update_mode="srekf", **kw)
    with pytest.raises(ValueError):
        EKFParams(update_mode="srekf_fast", sr_noise_buffer=0)
    with pytest.raises(ValueError):
        EKFParams(update_mode="srekf", update_chunks=4)
    # the combinations the fast path DOES support construct fine
    EKFParams(update_mode="srekf_fast", update_chunks=4, sr_noise_buffer=2)


def test_f32_psd_by_construction_under_stress():
    """Tiny-R repeated updates at f32: the dense (I−KH)·P covariance drifts
    to an indefinite matrix; the general-factor gram S·Sᵀ cannot (PSD by
    construction) — the conditioning property this mode exists to carry to
    scales the QR path could not reach."""
    p32 = dataclasses.replace(PARAMS, dtype=jnp.float32)
    state, _ = make_pair(4, seed=13)
    state = state._replace(
        x=state.x.astype(jnp.float32),
        P=(state.P * 1e4).astype(jnp.float32),
        sig=state.sig.astype(jnp.float32))
    sr = general_factor(with_buffer(state), seed=14)
    dense = state

    zs, slots, _, valid = batch_of(state, [0, 1, 2, 3], nudge=0.0)
    Rs = jnp.tile(jnp.asarray(np.diag([1e-6, 1e-6]), jnp.float32),
                  (4, 1, 1))
    zs = zs.astype(jnp.float32)

    @jax.jit
    def ticks(sr, dense):
        def body(c, _):
            s, d = c
            s = srekf_fast.sr_update_andrews(s, zs, slots, Rs, valid, p32)
            d = batched.update_batch(d, zs, slots, Rs, valid, p32)
            return (s, d), None
        return jax.lax.scan(body, (sr, dense), None, length=40)[0]

    sr, dense = ticks(sr, dense)
    d = 3 + 2 * int(state.n_active)
    P_sr = np.asarray((sr.P @ sr.P.T))[:d, :d].astype(np.float64)
    P_dn = np.asarray(dense.P)[:d, :d].astype(np.float64)
    eig_sr = np.linalg.eigvalsh(0.5 * (P_sr + P_sr.T)).min()
    # the dense form may degrade all the way to NaN/Inf under this stress —
    # that IS the failure mode; score it as unboundedly indefinite
    eig_dn = (np.linalg.eigvalsh(0.5 * (P_dn + P_dn.T)).min()
              if np.all(np.isfinite(P_dn)) else -np.inf)
    scale = float(np.abs(P_sr).max())
    assert np.all(np.isfinite(P_sr))
    # Gram-matrix PSD: only fp round-off of the product itself below zero
    assert eig_sr >= -1e-6 * scale
    # and the factored form is strictly better conditioned than the drifted
    # dense form on the same stress
    assert eig_sr > eig_dn
