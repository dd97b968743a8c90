"""Capacity sweep: M/G knee + gemm/syrk A/B at 20k and 32k landmarks.

The schedule (utils/schedule.py: M=4096, G=8, syrk, bf16 P) was tuned at
10k; the compute balance shifts by 4-10x in D² between 10k and 32k, so
this sweep measures the knee at the large points: medians of R5S_REPS (5)
per config, with spreads, appended to experiments/results/r5_sched.jsonl.

  K=20000 (two-buffer regime): M in {2048, 4096, 8192} x syrk, plus the
           same-state gemm A/B at the winner's M;
  K=32000 (single-buffer, P built inside the program and updated in
           place): M in {2048, 4096, 8192} syrk.

Run on the card:  python -m experiments.chip_r5_sched
Env:  R5S_STAGE=20k|32k|both (both), R5S_REPS (5).
"""
from __future__ import annotations

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

import bench
from ekf_slam_tpu.config import EKFParams
from ekf_slam_tpu.models.batched import update_chunked
from ekf_slam_tpu.ops.association import gate_batch

RESULTS = os.path.join(os.path.dirname(__file__), "results",
                       "r5_sched.jsonl")
REPS = int(os.environ.get("R5S_REPS", "5"))


def log(rec):
    rec = dict(rec, t=round(time.time(), 1))
    os.makedirs(os.path.dirname(RESULTS), exist_ok=True)
    with open(RESULTS, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print("[r5s]", json.dumps(rec), flush=True)


def _time_reps(run, *args, reps=REPS):
    jax.block_until_ready(run(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run(*args))
        ts.append(time.perf_counter() - t0)
    ts = np.asarray(ts)
    return (float(np.median(ts)),
            float(100.0 * (ts.max() - ts.min()) / np.median(ts)))


def _params(K, M, G, corr):
    return EKFParams(capacity=K, association="ml", s_cost=1e6,
                     s_thresh=1e12, ref_compat=False, dtype=jnp.float32,
                     pht_mode="rows", update_chunks=G, correction=corr,
                     cov_dtype=jnp.bfloat16)


def _chain(params, state, zs_all):
    rc0, rc1 = params.rc

    def one_batch(st, zsb):
        Rs = jax.vmap(lambda z: jnp.diag(
            jnp.stack([z[0] * rc0, z[1] * rc1])))(zsb).astype(
                params.dtype)
        is_new, sl = gate_batch(st, zsb, Rs, params)
        return update_chunked(st, zsb, sl, Rs, ~is_new, params), None

    return jax.jit(lambda st, zb: jax.lax.scan(one_batch, st, zb)[0])


def sweep_20k(K=20000):
    # (M, G, corr); G keeps chunk length 512 (the schedule's large-map
    # chunk) except the chunk-1024 probe
    configs = [(2048, 4, "syrk"), (4096, 8, "syrk"), (8192, 16, "syrk"),
               (4096, 4, "syrk"), (4096, 8, "gemm"), (8192, 16, "gemm")]
    state = None
    for M, G, corr in configs:
        try:
            params = _params(K, M, G, corr)
            if state is None:
                state = bench.make_full_state(params, K)
            n_batches = 4
            zs_all = jnp.asarray(bench.make_measurements(
                state, K, n_batches * M).reshape(n_batches, M, 3),
                params.dtype)
            dt, spread = _time_reps(_chain(params, state, zs_all),
                                    state, zs_all)
            log({"stage": "20k", "K": K, "M": M, "G": G,
                 "correction": corr, "D": state.dim,
                 "updates_per_sec": round(n_batches * M / dt, 1),
                 "spread_pct": round(spread, 1)})
        except Exception as e:
            log({"stage": "20k", "K": K, "M": M, "G": G,
                 "correction": corr, "error": repr(e)[:300]})


def sweep_32k(K=32000):
    """Single-buffer regime: P built in-program (fused iota-select into
    bf16), batches unrolled, P updated in place — swept over M."""
    from ekf_slam_tpu.state import FilterState

    rng = np.random.default_rng(0)
    lm = rng.uniform(-40, 40, (K, 2))
    for M, G in ((2048, 4), (4096, 8), (8192, 16)):
        try:
            params = _params(K, M, G, "syrk")
            Dp = params.dim
            x = np.zeros(Dp, np.float64)
            x[3:3 + 2 * K] = lm.reshape(-1)
            x_j = jnp.asarray(x, params.dtype)
            sig = jnp.arange(1, K + 1, dtype=params.dtype)
            active = jnp.ones((K,), bool)
            host_state = FilterState(x=x_j, P=jnp.zeros((2, 2)), sig=sig,
                                     active=active,
                                     n_active=jnp.asarray(K, jnp.int32))
            rc0, rc1 = params.rc
            n_batches = 4
            zs_all = jnp.asarray(bench.make_measurements(
                host_state, K, n_batches * M).reshape(n_batches, M, 3),
                params.dtype)

            def one_batch(st, zsb):
                Rs = jax.vmap(lambda z: jnp.diag(
                    jnp.stack([z[0] * rc0, z[1] * rc1])))(zsb).astype(
                        params.dtype)
                is_new, sl = gate_batch(st, zsb, Rs, params)
                return update_chunked(st, zsb, sl, Rs, ~is_new,
                                      params), None

            @jax.jit
            def run(zb):
                ii = jax.lax.broadcasted_iota(jnp.int32, (Dp, Dp), 0)
                jj = jax.lax.broadcasted_iota(jnp.int32, (Dp, Dp), 1)
                P = jnp.where(ii == jj, jnp.bfloat16(0.05),
                              jnp.bfloat16(0.0))
                st = FilterState(x=x_j, P=P, sig=sig, active=active,
                                 n_active=jnp.asarray(K, jnp.int32))
                for b in range(n_batches):
                    st, _ = one_batch(st, zb[b])
                return st.x

            dt, spread = _time_reps(run, zs_all, reps=max(3, REPS - 2))
            log({"stage": "32k", "K": K, "M": M, "G": G,
                 "correction": "syrk", "D": Dp,
                 "updates_per_sec": round(n_batches * M / dt, 1),
                 "spread_pct": round(spread, 1)})
        except Exception as e:
            log({"stage": "32k", "K": K, "M": M, "G": G,
                 "error": repr(e)[:300]})


def main():
    stage = os.environ.get("R5S_STAGE", "both")
    from ekf_slam_tpu.utils.runtime import device_report, enable_compile_cache
    enable_compile_cache()
    log({"stage": "start", "device": device_report(), "reps": REPS})
    if stage in ("20k", "both"):
        sweep_20k()
    if stage in ("32k", "both"):
        sweep_32k()
    log({"stage": "done"})


if __name__ == "__main__":
    main()
