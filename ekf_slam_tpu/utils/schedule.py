"""Update-scheduling heuristics: the fast config for a map size.

The joint batched update's cost splits into an irreducible O(D²·M)
correction GEMM, an O(D·M) row gather (pht_mode='rows'), and quadratic
O(M²)-O(M³) innovation terms (S build, Cholesky+inverse, gain GEMM).
Their balance flips with D:

* small maps (K ≤ 2000): the solve dominates → dense P·Hᵀ, large
  batches, chunk-256 scheduling, f32 storage;
* large maps (K > 2000): the GEMMs dominate → rows-mode P·Hᵀ (symmetry,
  no dense D²·2M GEMM), M=4096 batches, chunk-512 scheduling (quadratic
  terms cut G²× at constant correction flops), bf16 covariance storage
  (halves the bytes of the P passes; every large contraction still
  accumulates in f32, tests/test_mixed_precision.py) and the symmetric
  ``correction='syrk'`` form.

These constants were tuned on the accelerator this engine was first built
for and have not been re-derived on the current card yet (ROADMAP Queue 1
item 4).  ``recommended_schedule`` returns them; bench.py and user code
share it so the tuned configuration is a product feature, not a
benchmark detail.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax.numpy as jnp

from ..config import EKFParams


def recommended_schedule(capacity: int, batch: Optional[int] = None
                         ) -> dict:
    """(batch, update_chunks, pht_mode, cov_dtype, correction) for
    ``capacity``.

    ``batch``: override the observation batch size M; chunks then target
    the chunk length of the schedule (256 small-map / 512 large-map)."""
    if capacity <= 2000:
        m = batch or 8192
        return {"batch": m, "update_chunks": max(1, m // 256),
                "pht_mode": "dense", "cov_dtype": None,
                "correction": "gemm"}
    m = batch or 4096
    return {"batch": m, "update_chunks": max(1, m // 512),
            "pht_mode": "rows", "cov_dtype": jnp.bfloat16,
            "correction": "syrk"}


def tuned_params(params: EKFParams, batch: Optional[int] = None,
                 cov_dtype: Any = "auto") -> EKFParams:
    """``params`` with the scheduling knobs applied.

    ``cov_dtype``: 'auto' applies the schedule's recommended covariance
    storage dtype (bf16 for large maps); pass ``None`` (or a dtype) to
    opt out and pin the storage precision yourself.

    Square-root modes keep their own covariance representation: only the
    chunk scheduling applies to 'srekf_fast', nothing to 'srekf'."""
    s = recommended_schedule(params.capacity, batch)
    if params.update_mode == "srekf":
        return params
    if params.update_mode == "srekf_fast":
        return dataclasses.replace(params,
                                   update_chunks=s["update_chunks"])
    cd = s["cov_dtype"] if cov_dtype == "auto" else cov_dtype
    # the schedule pairs the symmetric correction with bf16 storage; an
    # f32 opt-out also reverts the correction
    corr = s["correction"] if cd == jnp.bfloat16 else "gemm"
    return dataclasses.replace(params, update_chunks=s["update_chunks"],
                               pht_mode=s["pht_mode"], cov_dtype=cd,
                               correction=corr)
