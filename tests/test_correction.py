"""The batched update's covariance correction in plain XLA, against an f64
NumPy joint update built from the oracle's own measurement Jacobians —
both algebras ({gemm, syrk}) at both storage precisions ({f32, bf16 P})
and both P·Hᵀ forms ({dense, rows}) — plus the rows-mode pair gather and
a guard that no accelerator-specific kernel or platform branch returns."""
import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ekf_slam_tpu.config import EKFParams
from ekf_slam_tpu.models import batched
from ekf_slam_tpu.oracle.np_ekf import NumpyEKFSLAM
from ekf_slam_tpu.state import FilterState

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _state(K=12, seed=0, dtype=jnp.float32, cov_dtype=None):
    """All K slots active, a well-conditioned dense P (bench.py's form)."""
    rng = np.random.default_rng(seed)
    D = 3 + 2 * K
    x = np.zeros(D)
    x[:3] = [0.3, -0.2, 20.0]
    x[3:] = rng.uniform(-5, 5, 2 * K)
    A = rng.normal(0, 1, (D, 8)) / np.sqrt(D)
    P = 0.05 * np.eye(D) + 0.02 * (A @ A.T)
    return FilterState(
        x=jnp.asarray(x, dtype),
        P=jnp.asarray(P, dtype).astype(cov_dtype or dtype),
        sig=jnp.arange(1, K + 1, dtype=dtype),
        active=jnp.ones((K,), bool),
        n_active=jnp.asarray(K, jnp.int32))


def _obs(state, slots, seed=1):
    rng = np.random.default_rng(seed)
    x = np.asarray(state.x, np.float64)
    zs, Rs = [], []
    for s in slots:
        d = x[3 + 2 * s:5 + 2 * s] - x[:2]
        r = np.hypot(*d) + rng.normal(0, 0.02)
        b = np.mod(np.rad2deg(np.arctan2(d[1], d[0])) - x[2]
                   + rng.normal(0, 0.5), 360.0)
        zs.append([r, b, s + 1.0])
        Rs.append(np.diag([0.01 + 0.01 * r, 0.5]))
    return np.asarray(zs), np.asarray(Rs)


def _oracle_joint_update(x, P, zs, slots, Rs):
    """The textbook joint update in f64 NumPy: H stacked from the oracle's
    per-landmark Jacobians, K = PHᵀS⁻¹, P ← P − K·H·P."""
    orc = NumpyEKFSLAM()
    orc.x, orc.P = x.copy(), P.copy()
    Hs, nus = [], []
    for z, s in zip(zs, slots):
        zhat, H = orc._innovation(int(s))
        nu = z[:2] - zhat
        nu[1] = (nu[1] + 180.0) % 360.0 - 180.0      # ref_compat=False
        Hs.append(H)
        nus.append(nu)
    H = np.concatenate(Hs)
    R = np.zeros((len(H), len(H)))
    for i, Ri in enumerate(Rs):
        R[2 * i:2 * i + 2, 2 * i:2 * i + 2] = Ri
    S = H @ P @ H.T + R
    Kg = P @ H.T @ np.linalg.inv(S)
    return x + Kg @ np.concatenate(nus), P - Kg @ H @ P


@pytest.mark.parametrize("pht", ["dense", "rows"])
@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("correction", ["gemm", "syrk"])
def test_correction_matches_f64_oracle(correction, storage, pht):
    cov = jnp.bfloat16 if storage == "bf16" else None
    params = EKFParams(capacity=12, max_obs=6, ref_compat=False,
                       dtype=jnp.float32, cov_dtype=cov, pht_mode=pht,
                       correction=correction)
    state = _state(cov_dtype=cov)
    slots = np.asarray([0, 3, 5, 7, 10, 11])
    zs, Rs = _obs(state, slots)
    got = jax.jit(batched.update_batch, static_argnums=5)(
        state, jnp.asarray(zs, jnp.float32), jnp.asarray(slots, jnp.int32),
        jnp.asarray(Rs, jnp.float32), jnp.ones((6,), bool), params)
    assert got.P.dtype == state.P.dtype
    # the oracle starts from the same (possibly bf16-rounded) P
    x_want, P_want = _oracle_joint_update(
        np.asarray(state.x, np.float64), np.asarray(state.P, np.float64),
        zs, slots, Rs)
    tol_p, tol_x = (1e-2, 1e-3) if storage == "bf16" else (1e-4, 1e-4)
    dP = np.abs(np.asarray(got.P, np.float64) - P_want).max()
    assert dP <= tol_p * np.abs(P_want).max(), dP
    np.testing.assert_allclose(np.asarray(got.x, np.float64), x_want,
                               atol=tol_x)


def test_gather_pairs_matches_numpy_odd_d(rng):
    D = 37                                      # 3 + 2·17: odd, untiled
    P = rng.normal(size=(D, D))
    starts = np.asarray([3, 35, 3, 17, 0, 21])  # duplicates, last pair
    got = np.asarray(batched.gather_pairs(jnp.asarray(P),
                                          jnp.asarray(starts)))
    want = P[np.stack([starts, starts + 1], -1).reshape(-1)]
    np.testing.assert_array_equal(got, want)


def test_gather_pairs_bf16_under_jit(rng):
    D = 2 * 50 + 3
    P = jnp.asarray(rng.normal(size=(D, D)), jnp.bfloat16)
    starts = jnp.asarray(3 + 2 * rng.integers(0, 50, 9), jnp.int32)
    got = jax.jit(batched.gather_pairs)(P, starts)
    assert got.shape == (18, D) and got.dtype == jnp.bfloat16
    Pn = np.asarray(P, np.float32)
    s = np.asarray(starts)
    np.testing.assert_array_equal(
        np.asarray(got, np.float32),
        Pn[np.stack([s, s + 1], -1).reshape(-1)])


def test_no_accelerator_specific_kernels_or_platform_branches():
    """No module imports the retired Mosaic backend of Pallas or branches
    on that backend's platform string, and its options are gone."""
    name = "t" + "pu"                       # kept out of this file's text
    backend = re.compile(r"pallas\s*(\.|import)\s*" + name + r"\b")
    branch = re.compile(r"""platform\s*[!=]=\s*['"]""" + name)
    bad = []
    for root, dirs, files in os.walk(REPO):
        dirs[:] = [d for d in dirs if not d.startswith(".")
                   and d not in ("chiprun_out", "build", "__pycache__")]
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path, encoding="utf-8") as fh:
                    text = fh.read()
                if backend.search(text) or branch.search(text):
                    bad.append(os.path.relpath(path, REPO))
    assert not bad, bad
    assert not os.path.exists(os.path.join(REPO, "ekf_slam_tpu", "ops",
                                           "pallas"))
    fields = {f.name for f in dataclasses.fields(EKFParams)}
    assert not fields & {"use_" + "pallas", "rows_" + "gather"}
