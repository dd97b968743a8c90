"""Wire-or-retire: blocked HYPERBOLIC downdate for the strict-triangular
square-root update.

The strict-triangular path (models/srekf_fast.sr_update_panel) keeps the
factor lower-triangular per update by running the Andrews factor update
and then re-factorizing via Gram + blocked Cholesky — a ~D³·4/3 GEMM
premium per batch over srekf_fast.
The roadmap's named alternative: eliminate the downdate columns DIRECTLY
against the triangular factor with hyperbolic (J-orthogonal) block
Householder transforms — P' = L·Lᵀ − W·Wᵀ = L'·L'ᵀ with L' triangular by
construction, no Gram, conditioning κ(L) not κ(P)².

Blocked algorithm implemented here (compact composition, GEMM trailing):
  for each NB-column panel of L:
    * NB sequential hyperbolic Householders: column j's reflector zeroes
      row j of W against L[j,j] (J = diag(1, -I_R) metric), applied to
      the PANEL rows only — O(NB²·R);
    * the composed (1+R)² ... (NB+R)² block transform T accumulates by
      rank-1 updates and is applied to the TRAILING rows' [L_panel | W]
      with ONE GEMM — O(D·(NB+R)²) per panel.
Total: 2·D²·(NB+R)²/NB flops vs the Gram route's ~D³ + D³/3 per batch.

FLOP ledger at the 10k point (D=20480, chunk rank R=1024, NB=1024):
hyperbolic ≈ 8·D²·R per chunk x 8 chunks ≈ 2.7e13 vs Gram+chol ≈ 1.2e13
per batch — the paper analysis already predicts ≥2x WORSE, plus ~D/NB·NB
= D sequential reflector steps no matmul can batch.  This probe turns
that into a measurement (correctness vs direct Cholesky at small D, then
wall-clock on the card at D=20480 beside the Gram+chol recompression it
would replace) so DESIGN.md §5's open claim closes with numbers either
way.

Run on the card: python -m experiments.hyperbolic_probe [--small-only]
"""
import argparse
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def hyperbolic_downdate_blocked(L, W, nb: int):
    """L' lower-triangular with L'·L'ᵀ = L·Lᵀ − W·Wᵀ (requires the
    downdate to keep P positive definite).

    J-orthogonal block elimination (J = diag(I_nb, −I_R) per panel):
    right-multiplying the combined [L_panel | W] by any Q with
    Q·J·Qᵀ = J preserves B·J·Bᵀ = L·Lᵀ − W·Wᵀ.  Each column's
    hyperbolic Householder H = J − β·v·vᵀ (β = 2/(vᵀJv), v = J·u − σ·e)
    zeroes that row's W entries; the composed panel transform applies to
    the trailing rows as one GEMM.  Panels iterate in a
    static Python loop so every trailing GEMM has a static shape."""
    D = L.shape[0]
    R = W.shape[1]
    dt = L.dtype
    n_panels = D // nb
    assert n_panels * nb == D

    for k in range(n_panels):
        j0 = k * nb
        A = jnp.concatenate([L[j0:j0 + nb, j0:j0 + nb], W[j0:j0 + nb]],
                            axis=1)                     # [nb, nb+R]
        T0 = jnp.eye(nb + R, dtype=dt)

        def reflector(c, j):
            A, T = c
            row = A[j]
            ljj = row[j]
            w = row[nb:]
            a2 = ljj * ljj - jnp.sum(w * w)
            lp = jnp.sqrt(jnp.maximum(a2, jnp.asarray(1e-30, dt)))
            # σ = −sign(ljj)·lp avoids the σ≈ljj cancellation in vᵀJv
            sg = jnp.where(ljj >= 0, -1.0, 1.0).astype(dt)
            sigma = sg * lp
            # v = J·u − σ·e_j: v_j = ljj − σ, v_tail = −w
            v = (jnp.zeros((nb + R,), dt)
                 .at[j].set(ljj - sigma).at[nb:].set(-w))
            vJv = (ljj - sigma) ** 2 - jnp.sum(w * w)
            beta = 2.0 / jnp.where(jnp.abs(vJv) < 1e-30, 1e-30, vJv)
            # B ← B·H = B·J − β·(B·v)·vᵀ.  Rows above j have zero
            # panel entry in column j and zero W, so they are fixed
            # points — no masking needed.
            Av = A @ v
            A = (A.at[:, nb:].multiply(-1.0)
                 - beta * Av[:, None] * v[None, :])
            Tv = T @ v
            T = (T.at[:, nb:].multiply(-1.0)
                 - beta * Tv[:, None] * v[None, :])
            return (A, T), None

        (A, T), _ = lax.scan(reflector, (A, T0),
                             jnp.arange(nb, dtype=jnp.int32))
        L = L.at[j0:j0 + nb, j0:j0 + nb].set(A[:, :nb])
        W = W.at[j0:j0 + nb].set(0.0)

        if (k + 1) * nb < D:
            t0 = (k + 1) * nb
            Bt = jnp.concatenate([L[t0:, j0:j0 + nb], W[t0:]], axis=1)
            Bt = Bt @ T                                 # trailing GEMM
            L = L.at[t0:, j0:j0 + nb].set(Bt[:, :nb])
            W = W.at[t0:].set(Bt[:, nb:])
    return L


def correctness(D=256, R=64, nb=64, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(D, D)) / np.sqrt(D)
    P = 4.0 * np.eye(D) + A @ A.T
    L = np.linalg.cholesky(P)
    W = 0.2 * rng.normal(size=(D, R)) / np.sqrt(R)
    Pd = P - W @ W.T
    ref = np.linalg.cholesky(Pd)
    out = np.asarray(hyperbolic_downdate_blocked(
        jnp.asarray(L), jnp.asarray(W), nb))
    # compare the reconstructed covariance (sign conventions may differ
    # per column; P is the invariant)
    err = np.abs(out @ out.T - Pd).max() / np.abs(Pd).max()
    tri = np.abs(np.triu(out, 1)).max()
    print(f"[hyp] correctness D={D} R={R} nb={nb}: "
          f"relerr {err:.2e}, upper-tri residue {tri:.2e}")
    # f32 backends land ~2e-4 (hyperbolic transforms amplify round-off
    # |cosh|>1-style — itself a conditioning data point vs the
    # orthogonal-QR route); f64 reaches 3e-15
    thresh = 1e-8 if out.dtype == np.float64 else 5e-3
    return err < thresh and tri < thresh


def chip_timing(D=20480, R=1024, nb=1024, n_it=8):
    """Wall-clock of one rank-R blocked hyperbolic downdate at the 10k
    chunk shape, beside the Gram+chol recompression of the same factor
    (models/srekf_fast.sr_recompress) timed in the same process."""
    key = jax.random.PRNGKey(0)
    # synthetic well-conditioned factor: diagonal-dominant lower-tri
    Lm = (jnp.tril(jax.random.normal(key, (D, D), jnp.float32)) * 0.02
          + 3.0 * jnp.eye(D, dtype=jnp.float32))
    Wm = jax.random.normal(jax.random.fold_in(key, 1), (D, R),
                           jnp.float32) * 0.01

    from functools import partial

    @partial(jax.jit, static_argnums=2)
    def run(L, W, it):
        def body(c, i):
            L = hyperbolic_downdate_blocked(c, W + 0.0 * i, nb)
            return L, None
        out, _ = lax.scan(body, L, jnp.arange(it, dtype=jnp.float32))
        return out

    t0 = time.time()
    jax.block_until_ready(run(Lm, Wm, 1))
    print(f"[hyp] compile+1: {time.time()-t0:.1f}s", flush=True)
    t0 = time.time()
    jax.block_until_ready(run(Lm, Wm, n_it))
    per = (time.time() - t0) / n_it

    from ekf_slam_tpu.models.srekf_fast import sr_recompress
    from ekf_slam_tpu.state import FilterState
    st = FilterState(x=jnp.zeros((D,), jnp.float32), P=Lm,
                     sig=jnp.zeros(((D - 3) // 2,), jnp.float32),
                     active=jnp.ones(((D - 3) // 2,), bool),
                     n_active=jnp.asarray((D - 3) // 2, jnp.int32))
    rec = jax.jit(sr_recompress)
    jax.block_until_ready(rec(st))
    t0 = time.time()
    jax.block_until_ready(rec(st))
    t_rec = time.time() - t0
    print(f"[hyp] D={D} R={R} nb={nb}: {per*1e3:.1f} ms per rank-{R} "
          f"downdate ({n_it} its).  Per M=4096 batch (8 chunks): "
          f"{8*per*1e3:.0f} ms vs {t_rec*1e3:.0f} ms for one Gram+chol "
          f"recompression", flush=True)
    return per


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small-only", action="store_true")
    ap.add_argument("--nb", type=int, default=1024)
    ap.add_argument("--rank", type=int, default=1024)
    args = ap.parse_args()
    ok = correctness()
    ok &= correctness(D=384, R=96, nb=128, seed=3)
    print(f"[hyp] correctness: {'PASS' if ok else 'FAIL'}")
    if not ok or args.small_only:
        return
    from ekf_slam_tpu.utils.runtime import device_report, enable_compile_cache
    enable_compile_cache()
    print(f"[hyp] device: {device_report()}", flush=True)
    chip_timing(R=args.rank, nb=args.nb)


if __name__ == "__main__":
    main()
