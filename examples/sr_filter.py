"""The square-root filter family: conditioning beyond f32's reach.

The reference propagates its covariance with the (I−KH)·P form
(/root/reference/EKF_SLAM_UC.m:146), which loses symmetry and — in
finite precision under tiny measurement noise — drives P indefinite.
This example runs the same aggressive-update stress on four covariance
representations and prints each one's health:

  dense       (I−KH)·P, the reference's form          — degrades
  joseph      Joseph-form dense                       — symmetric, slower drift
  srekf_fast  general factor S (P = S·Sᵀ), Andrews    — PSD by construction
  triangular  srekf_fast with sr_noise_buffer=1       — PSD + a lower-
              (per-tick blocked re-triangularization)   triangular factor
                                                        after every tick

Run:  python examples/sr_filter.py [--ticks 40]
"""
import argparse
import sys

import jax
import jax.numpy as jnp
import numpy as np

from ekf_slam_tpu.config import EKFParams
from ekf_slam_tpu.models import batched, ekf, srekf, srekf_fast
from ekf_slam_tpu.state import init_state


def build_state(params, n_lm, scale=1e4, seed=3):
    rng = np.random.default_rng(seed)
    st = init_state(params)
    u = jnp.asarray([0.05, 2.0], jnp.float32)
    for k in range(n_lm):
        loc = jnp.asarray(rng.uniform(-3, 3, 2), jnp.float32)
        R = jnp.asarray(np.diag(rng.uniform(0.01, 0.1, 2)), jnp.float32)
        st = ekf.predict(st, u, params)
        st = ekf.append(st, u, R, loc, float(k + 1), params)
    # inflate: a long-uncorrected prior (large dynamic range is what
    # breaks the dense form under tiny-R updates)
    return st._replace(P=(st.P * scale).astype(jnp.float32))


def stress_obs(state, params, n_lm):
    zs = []
    x = np.asarray(state.x, np.float64)
    for k in range(n_lm):
        lm = x[3 + 2 * k:5 + 2 * k]
        d = lm - x[:2]
        r = float(np.hypot(*d))
        b = float(np.mod(np.rad2deg(np.arctan2(d[1], d[0])) - x[2], 360.0))
        zs.append([r, b, k + 1])
    zs = jnp.asarray(zs, jnp.float32)
    Rs = jnp.tile(jnp.asarray(np.diag([1e-6, 1e-6]), jnp.float32),
                  (n_lm, 1, 1))
    slots = jnp.arange(n_lm, dtype=jnp.int32)
    valid = jnp.ones((n_lm,), bool)
    return zs, slots, Rs, valid


def health(P):
    P = np.asarray(P, np.float64)
    if not np.isfinite(P).all():
        return "NON-FINITE", float("nan")
    sym = 0.5 * (P + P.T)
    lam = np.linalg.eigvalsh(sym)
    tag = "PSD" if lam.min() >= -1e-6 * max(1.0, abs(lam).max()) \
        else "INDEFINITE"
    return tag, float(lam.min())


def main(argv=None):
    from ekf_slam_tpu.utils.runtime import enable_compile_cache
    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=40)
    ap.add_argument("--landmarks", type=int, default=4)
    args = ap.parse_args(argv)
    n_lm = args.landmarks

    base = EKFParams(capacity=8, max_obs=8, ref_compat=False,
                     dtype=jnp.float32)
    st0 = build_state(base, n_lm)
    zs, slots, Rs, valid = stress_obs(st0, base, n_lm)

    def run_dense(params):
        @jax.jit
        def ticks(st):
            def body(s, _):
                return batched.update_batch(s, zs, slots, Rs, valid,
                                            params), None
            return jax.lax.scan(body, st, None, length=args.ticks)[0]
        return ticks(st0).P

    def run_factor(triangular):
        buf = 1 if triangular else 8
        params = EKFParams(capacity=8, max_obs=8, ref_compat=False,
                           dtype=jnp.float32, update_mode="srekf_fast",
                           sr_noise_buffer=buf)
        D = st0.dim
        x = jnp.zeros((D + buf,), st0.x.dtype).at[:D].set(st0.x)
        P = jnp.zeros((D + buf, D + buf), st0.P.dtype).at[:D, :D].set(st0.P)
        sr = srekf.factor_from_state(st0._replace(x=x, P=P))
        upd = (srekf_fast.sr_update_panel if triangular
               else srekf_fast.sr_update_chunked)

        @jax.jit
        def ticks(sr):
            def body(s, _):
                return upd(s, zs, slots, Rs, valid, params), None
            return jax.lax.scan(body, sr, None, length=args.ticks)[0]
        sr = ticks(sr)
        S = np.asarray(sr.P)
        tri = bool(np.allclose(S, np.tril(S)))
        return sr.P @ sr.P.T, tri

    import dataclasses
    rows = [("dense (I-KH)P   [the reference's form]",
             run_dense(base), None),
            ("joseph-form dense",
             run_dense(dataclasses.replace(base, joseph=True)), None)]
    P_sf, _ = run_factor(False)
    rows.append(("srekf_fast (general factor)", P_sf, None))
    P_tri, tri = run_factor(True)
    rows.append(("strict-triangular (sr_noise_buffer=1)", P_tri, tri))

    print(f"{args.ticks} tiny-R (1e-6) joint updates on an inflated "
          f"(1e4) f32 prior:")
    ok = True
    for name, P, tri_flag in rows:
        tag, lam = health(P)
        extra = ""
        if tri_flag is not None:
            extra = f", factor triangular: {tri_flag}"
        print(f"  {name:44s} {tag:11s} min eig {lam: .3e}{extra}")
        if "factor" in name or "triangular" in name:
            ok = ok and tag == "PSD"
    print("square-root forms PSD:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
