"""SYRK covariance downdate: the ``EKFParams.correction='syrk'``
batched-update path vs the GEMM default.

The correction P ← P − Kg·HP equals the symmetric downdate W·Wᵀ with
W = PHᵀ·L⁻ᵀ (S = L·Lᵀ), models/batched.syrk_downdate.
"""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest

from ekf_slam_tpu.config import EKFParams
from ekf_slam_tpu.models import batched


def _padded_state_and_obs(n_slots=4, seed=6, pad=128):
    from test_batched import measurement_of
    from test_ekf_core import make_pair

    state, _ = make_pair(n_slots, seed=seed)
    state = state._replace(P=0.5 * (state.P + state.P.T))
    D0 = state.dim
    state = state._replace(
        x=jnp.zeros((pad,), state.x.dtype).at[:D0].set(state.x),
        P=jnp.zeros((pad, pad), state.P.dtype).at[:D0, :D0].set(state.P))
    zs = []
    for i, slot in enumerate([0, 2, 3]):
        z = measurement_of(state, slot)
        z[0] += 0.04 * (i + 1)
        zs.append(z)
    zs = jnp.asarray(np.stack(zs))
    slots = jnp.asarray([0, 2, 3], jnp.int32)
    Rs = jnp.asarray(np.stack([np.diag([z[0] * 0.1, abs(z[1]) * 5.0])
                               for z in np.asarray(zs)]))
    valid = jnp.asarray([True, True, False])
    return state, zs, slots, Rs, valid


@pytest.mark.parametrize("pht", ["dense", "rows"])
def test_update_batch_syrk_matches_gemm(pht):
    """correction='syrk' ≡ the default GEMM correction on a padded state,
    both pht modes, masked slots included (f64)."""
    base = EKFParams(capacity=8, max_obs=4, ref_compat=False,
                     dtype=jnp.float64, pht_mode=pht)
    state, zs, slots, Rs, valid = _padded_state_and_obs()
    want = batched.update_batch(state, zs, slots, Rs, valid, base)
    got = batched.update_batch(
        state, zs, slots, Rs, valid,
        dataclasses.replace(base, correction="syrk"))
    np.testing.assert_allclose(np.asarray(got.x), np.asarray(want.x),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(got.P), np.asarray(want.P),
                               rtol=1e-9, atol=1e-11)
    out = np.asarray(got.P)
    np.testing.assert_array_equal(out, out.T)    # bit-symmetric


def test_update_batch_syrk_unpadded_falls_back():
    """An unpadded (odd-D) state needs no padding: the symmetric form runs
    at any D, emits no warning, and equals the GEMM correction."""
    base = EKFParams(capacity=8, max_obs=4, ref_compat=False,
                     dtype=jnp.float64, correction="syrk")
    from test_batched import measurement_of
    from test_ekf_core import make_pair
    state, _ = make_pair(4, seed=6)
    state = state._replace(P=0.5 * (state.P + state.P.T))
    assert state.dim % 2 == 1
    z = measurement_of(state, 1)
    zs = jnp.asarray(z)[None, :]
    Rs = jnp.asarray(np.diag([z[0] * 0.1, abs(z[1]) * 5.0]))[None]
    slots = jnp.asarray([1], jnp.int32)
    valid = jnp.ones((1,), bool)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = batched.update_batch(state, zs, slots, Rs, valid, base)
    want = batched.update_batch(
        state, zs, slots, Rs, valid,
        dataclasses.replace(base, correction="gemm"))
    assert got.P.shape == state.P.shape
    np.testing.assert_allclose(np.asarray(got.P), np.asarray(want.P),
                               rtol=1e-9, atol=1e-11)


def test_update_chunked_syrk_matches_gemm():
    """Chunked scheduling (the 10k default's shape) through the syrk
    correction — each chunk downdates and the next linearizes against
    the running state."""
    base = EKFParams(capacity=8, max_obs=4, ref_compat=False,
                     dtype=jnp.float64, pht_mode="rows", update_chunks=2)
    state, zs, slots, Rs, valid = _padded_state_and_obs()
    valid = jnp.ones((3,), bool)
    want = batched.update_chunked(state, zs, slots, Rs, valid, base)
    got = batched.update_chunked(
        state, zs, slots, Rs, valid,
        dataclasses.replace(base, correction="syrk"))
    np.testing.assert_allclose(np.asarray(got.x), np.asarray(want.x),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(got.P), np.asarray(want.P),
                               rtol=1e-9, atol=1e-11)


def test_sharded_session_reverts_syrk():
    """ShardedSlamSession under GSPMD cannot run the single-device
    symmetric downdate over a row-sharded P — it reverts to the
    (semantically identical) GEMM correction so utils/schedule.tuned_params
    output composes directly."""
    from ekf_slam_tpu.config import RansacParams
    from ekf_slam_tpu.parallel.mesh import make_mesh
    from ekf_slam_tpu.parallel.sharded import ShardedSlamSession
    from ekf_slam_tpu.utils.schedule import tuned_params

    ep = tuned_params(EKFParams(capacity=2048, max_obs=4, ref_compat=False,
                                update_mode="batched", dtype=jnp.float32))
    assert ep.correction == "syrk"
    sess = ShardedSlamSession(
        mesh=make_mesh(), ekf_params=ep,
        ransac_params=RansacParams(table_capacity=16, ref_compat=False,
                                   dtype=jnp.float32))
    assert sess.ekf_params.correction == "gemm"


def test_correction_validation():
    with pytest.raises(ValueError, match="correction"):
        EKFParams(correction="magic")
    with pytest.raises(ValueError, match="syrk"):
        EKFParams(correction="syrk", joseph=True)
    with pytest.raises(ValueError, match="syrk"):
        EKFParams(correction="syrk", update_mode="srekf_fast")
    EKFParams(correction="syrk")                 # valid alone
