"""Filter-core kernels vs the NumPy oracle (SURVEY.md §4.2: unit tests per
kernel against the dense rank-growing implementation, quirks included).

The jitted path uses sparse-F predict and rank-2 updates; the oracle does the
dense MATLAB-shaped algebra (F·P·Fᵀ, (I−KH)·P).  They must agree to fp
round-off at f64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ekf_slam_tpu.config import EKFParams, ref_compat_uc
from ekf_slam_tpu.models import ekf
from ekf_slam_tpu.ops.observations import obs_from_rows
from ekf_slam_tpu.oracle.np_ekf import NumpyEKFSLAM
from ekf_slam_tpu.state import init_state

PARAMS = ref_compat_uc(capacity=8, dtype=jnp.float64)


def make_pair(n_landmarks=0, seed=0):
    """A (jax_state, oracle) pair with identical random contents."""
    rng = np.random.default_rng(seed)
    state = init_state(PARAMS)
    oracle = NumpyEKFSLAM()
    for k in range(n_landmarks):
        u = rng.uniform(-0.2, 0.2, 2)
        loc = rng.uniform(-3, 3, 2)
        R = np.diag(rng.uniform(0.01, 0.1, 2))
        oracle.predict(u)
        oracle.append(u, R, loc, float(k + 1))
        state = ekf.predict(state, jnp.asarray(u), PARAMS)
        state = ekf.append(state, jnp.asarray(u), jnp.asarray(R),
                           jnp.asarray(loc), float(k + 1), PARAMS)
    return state, oracle


def dense_of(state):
    """Extract the active-dim dense (x, P) from the padded state."""
    n = int(state.n_active)
    d = 3 + 2 * n
    return np.asarray(state.x[:d]), np.asarray(state.P[:d, :d])


def test_predict_matches_oracle():
    state, oracle = make_pair(3)
    u = jnp.array([0.15, 7.0])
    state = ekf.predict(state, u, PARAMS)
    oracle.predict(np.asarray(u))
    x, P = dense_of(state)
    np.testing.assert_allclose(x, oracle.x, atol=1e-12)
    np.testing.assert_allclose(P, oracle.P, atol=1e-12)


def test_predict_inactive_block_untouched():
    state, _ = make_pair(2)
    state = ekf.predict(state, jnp.array([0.1, 3.0]), PARAMS)
    d = 3 + 2 * int(state.n_active)
    assert np.all(np.asarray(state.P[d:, :]) == 0)
    assert np.all(np.asarray(state.P[:, d:]) == 0)
    assert np.all(np.asarray(state.x[d:]) == 0)


def test_append_matches_oracle():
    state, oracle = make_pair(2)
    u = np.array([0.1, 5.0])
    R = np.diag([0.02, 0.3])
    loc = np.array([1.5, -2.0])
    state = ekf.append(state, jnp.asarray(u), jnp.asarray(R),
                       jnp.asarray(loc), 3.0, PARAMS)
    oracle.append(u, R, loc, 3.0)
    x, P = dense_of(state)
    np.testing.assert_allclose(x, oracle.x, atol=1e-12)
    np.testing.assert_allclose(P, oracle.P, atol=1e-12)
    assert int(state.n_active) == 3
    assert float(state.sig[2]) == 3.0


def test_append_at_capacity_is_noop():
    state, _ = make_pair(8)  # capacity = 8
    before = jax.tree_util.tree_map(np.asarray, state)
    state = ekf.append(state, jnp.array([0.1, 1.0]),
                       jnp.eye(2) * 0.01, jnp.array([9.0, 9.0]), 9.0, PARAMS)
    after = jax.tree_util.tree_map(np.asarray, state)
    for a, b in zip(jax.tree_util.tree_leaves(before),
                    jax.tree_util.tree_leaves(after)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("slot", [0, 1, 2])
def test_update_matches_oracle(slot):
    state, oracle = make_pair(3, seed=4)
    z = np.array([2.0, 133.0, float(slot + 1)])
    R = np.diag([z[0] * 0.1, z[1] * 5.0])
    state = ekf.update(state, jnp.asarray(z), slot, jnp.asarray(R), PARAMS)
    oracle.update(z, slot, R)
    x, P = dense_of(state)
    np.testing.assert_allclose(x, oracle.x, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(P, oracle.P, rtol=1e-8, atol=1e-10)


def test_update_unwrapped_innovation_quirk():
    """ref_compat keeps the reference's unwrapped bearing innovation
    (EKF_SLAM_UC.m:145); correct mode wraps it to [-180,180)."""
    state, _ = make_pair(1, seed=7)
    # measurement bearing near 0, predicted near 360 -> huge raw innovation
    z = jnp.array([2.0, 1.0, 1.0])
    R = jnp.diag(jnp.array([0.2, 5.0]))
    ref_x = ekf.update(state, z, 0, R, PARAMS).x
    fixed = PARAMS.__class__(**{**PARAMS.__dict__, "ref_compat": False})
    fix_x = ekf.update(state, z, 0, R, fixed).x
    # they must differ whenever the predicted bearing wrapped past 360
    zhat, _, _ = ekf.innovation(state.x, 0, PARAMS)
    if float(zhat[1]) > 180.0:
        assert not np.allclose(np.asarray(ref_x), np.asarray(fix_x))


def test_joseph_form_stays_symmetric():
    p = EKFParams(capacity=8, dtype=jnp.float64, joseph=True)
    state, _ = make_pair(3, seed=11)
    z = jnp.array([2.0, 45.0, 1.0])
    R = jnp.diag(jnp.array([0.2, 5.0]))
    s2 = ekf.update(state, z, 0, R, p)
    P = np.asarray(s2.P)
    np.testing.assert_allclose(P, P.T, atol=1e-12)


def test_measure_sequence_matches_oracle():
    """Full measurement phase: association + append/update chain
    (EKF_SLAM_UC.m:102-152) against the oracle on a scripted sequence."""
    state, oracle = make_pair(0)
    locs = {1: np.array([2.0, 0.0]), 2: np.array([0.0, 2.0]),
            3: np.array([-2.0, 1.0])}
    u = np.array([0.05, 2.0])
    rng = np.random.default_rng(3)
    for step in range(6):
        seen = [i + 1 for i in range(min(step + 1, 3))]
        rows, row_locs = [], []
        for idx in seen:
            d = locs[idx] - oracle.x[:2] if len(oracle.x) else locs[idx]
            r = np.hypot(*d) + rng.normal(0, 0.01)
            b = np.mod(np.rad2deg(np.arctan2(d[1], d[0])) - oracle.x[2], 360)
            rows.append([r, b, idx])
            row_locs.append(locs[idx])
        state = ekf.predict(state, jnp.asarray(u), PARAMS)
        oracle.predict(u)
        obs = obs_from_rows(rows, row_locs, PARAMS.max_obs, jnp.float64)
        state = ekf.measure(state, obs, jnp.asarray(u), PARAMS)
        oracle.measure(np.array(rows), u, locs)
    x, P = dense_of(state)
    assert int(state.n_active) == oracle.n_landmarks == 3
    np.testing.assert_allclose(x, oracle.x, rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(P, oracle.P, rtol=1e-6, atol=1e-8)


def test_measure_is_jittable_fixed_shape():
    state, _ = make_pair(0)
    u = jnp.array([0.05, 2.0])
    obs = obs_from_rows([[2.0, 10.0, 1]], [[2.0, 0.3]], PARAMS.max_obs,
                        jnp.float64)
    stepped = jax.jit(lambda s, o, u: ekf.measure(s, o, u, PARAMS))
    s2 = stepped(state, obs, u)
    assert int(s2.n_active) == 1
