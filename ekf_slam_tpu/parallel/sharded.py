"""Sharded SLAM session: covariance row-tiles over a device mesh.

The joint covariance P is the only state that scales (D² at D = 3+2K; 1.6 GB
at f32 for K = 10k) — everything else is O(K).  The map-scale design
(SURVEY.md §5 "long-context analog", BASELINE.json configs 4-5):

* ``P`` is sharded row-wise over the ``map`` axis — each device owns a
  horizontal strip ``P[rows_d, :]``.
* The rank-2 measurement update is naturally local: ``PHᵀ = G @ Hsᵀ`` needs
  only local rows (columns of P are fully present in each row strip), the
  2×2 innovation solve is replicated, and ``P −= K·(HP)`` is a local
  outer-product per strip.  The only collectives are gathers of the five
  H-relevant rows of P/PHᵀ — O(D) bytes per observation between devices,
  the EKF analog of the Schur-complement cross-tile combine.
* ``predict`` touches rows/cols 0..2 only: one row broadcast + local axpys.

All of this falls out of the single-chip filter functions (models/ekf.py)
under GSPMD: the code is reused verbatim, with shardings pinned on the carry
via ``jax.lax.with_sharding_constraint`` so XLA keeps P distributed instead
of gathering it.  The explicit-collective ``shard_map`` form of the hot
paths lives in parallel/shard_update.py.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import EKFParams, RansacParams
from ..models import ekf
from ..ops.angles import angdiff_deg
from ..ops.ransac import extract, init_table
from ..ops.scan import scan_from_ranges
from ..session import SessionCarry, StepOutput
from ..state import FilterState, init_state


def _constrain(filt: FilterState, mesh: Mesh) -> FilterState:
    """Pin the covariance's row sharding (and replicate the small leaves)."""
    row = NamedSharding(mesh, P("map", None))
    rep = NamedSharding(mesh, P())
    return FilterState(
        x=jax.lax.with_sharding_constraint(filt.x, rep),
        P=jax.lax.with_sharding_constraint(filt.P, row),
        sig=jax.lax.with_sharding_constraint(filt.sig, rep),
        active=jax.lax.with_sharding_constraint(filt.active, rep),
        n_active=filt.n_active,
    )


@dataclasses.dataclass
class ShardedSlamSession:
    """Map-sharded session (BASELINE.json config 4: covariance tiles over
    the devices of one host).  API mirrors session.SlamSession."""

    mesh: Mesh
    ekf_params: EKFParams = None
    ransac_params: Optional[RansacParams] = None
    seed: int = 0
    #: how the distributed joint update is expressed:
    #:   'gspmd'     — single-chip code + sharding constraints; XLA derives
    #:                 the collectives (this module's default);
    #:   'shard_map' — the explicit psum/all_gather Schur combine
    #:                 (parallel/shard_update.py), auditable collective-
    #:                 by-collective and separately benchmarkable.
    #: Both are bit-compared in tests and by experiments/scaling_harness.py.
    update_path: str = "gspmd"
    #: map lifecycle (models/maintenance.py) after each tick's
    #: measurement phase, as in SlamSession.  NOTE the distributed cost:
    #: eviction permutes P's rows AND columns — under a row-sharded P
    #: the column gather is an all-to-all-class data movement
    #: (O(D²/n)/device), so treat maintenance as an occasional op, not a
    #: per-tick default, at large D.
    maintain_merge_radius: float = 0.0
    maintain_max_trace: float = 0.0

    def __post_init__(self):
        if self.ekf_params is None:
            self.ekf_params = EKFParams()
        if self.ransac_params is None:
            self.ransac_params = RansacParams(dtype=self.ekf_params.dtype)
        if self.update_path not in ("gspmd", "shard_map"):
            raise ValueError(f"unknown update_path {self.update_path!r}")
        # Reject configurations this session class cannot honor, instead of
        # silently running something else (the SlamSession construction-time
        # standard; ICP/fused control and map maintenance are likewise not
        # constructor surface here — the sharded step is odometry-driven).
        if self.ekf_params.update_mode == "srekf":
            raise NotImplementedError(
                "ShardedSlamSession does not support the triangular QR "
                "srekf (its pre-array QR is not row-shardable); use "
                "update_mode='srekf_fast' with update_path='shard_map' — "
                "the distributed Andrews update "
                "(parallel/shard_update.sr_update_sharded)")
        if (self.ekf_params.update_mode == "srekf_fast"
                and self.update_path != "shard_map"):
            raise NotImplementedError(
                "sharded srekf_fast runs through the explicit-collective "
                "distributed Andrews update: set update_path='shard_map' "
                "(GSPMD would gather the factor for the row gathers)")
        # correction='syrk' under sharding: the shard_map update carries a
        # distributed form (parallel/shard_update.systolic_syrk_downdate —
        # half flops via the mirror exchange, bit-symmetric P), so it is
        # honored there.  Under GSPMD the single-device form would
        # force a full-P gather, and the corrections are semantically
        # identical (same W·Wᵀ downdate, different schedule) — revert to
        # the distributed GEMM form rather than reject, so
        # utils/schedule.tuned_params output (bf16+syrk for large maps)
        # stays directly usable (same auto-configuration precedent as
        # masked_writes below).
        if (self.ekf_params.correction == "syrk"
                and self.update_path != "shard_map"):
            self.ekf_params = dataclasses.replace(self.ekf_params,
                                                  correction="gemm")
        if self.update_path == "shard_map":
            if self.ekf_params.update_mode not in ("batched", "srekf_fast"):
                raise ValueError(
                    "update_path='shard_map' implements the batched and "
                    "srekf_fast joint updates "
                    f"(got {self.ekf_params.update_mode!r})")
            if self.ekf_params.symmetrize:
                raise ValueError(
                    "symmetrize under update_path='shard_map' would need a "
                    "full O(D²/n) all-to-all transpose every tick "
                    "(parallel/shard_update.py); the batched update "
                    "preserves symmetry algebraically — unset symmetrize")
        # scatter/dynamic-slice writes into a row-sharded P make GSPMD
        # all-gather the whole covariance (3×P bytes/tick measured by
        # experiments/scaling_harness.py); the masked elementwise forms
        # stay local.  (srekf_fast validates masked_writes away — its
        # factor writes are the O(D) predict/append slices.)
        if self.ekf_params.update_mode != "srekf_fast":
            self.ekf_params = dataclasses.replace(self.ekf_params,
                                                  masked_writes=True)
        self.n_map = self.mesh.shape["map"]
        ep, rp = self.ekf_params, self.ransac_params
        mesh = self.mesh

        def step(carry: SessionCarry, odom_pose, ranges, beam_angles
                 ) -> Tuple[SessionCarry, StepOutput]:
            dD = jnp.sqrt((odom_pose[0] - carry.old_odom[0]) ** 2
                          + (odom_pose[1] - carry.old_odom[1]) ** 2)
            dTh = angdiff_deg(carry.old_odom[2], odom_pose[2])
            u = jnp.stack([dD, dTh]).astype(ep.dtype)

            filt = _constrain(carry.filt, mesh)
            sr_tick = carry.sr_tick
            if ep.update_mode == "srekf_fast":
                from ..models.srekf_fast import sr_predict_fast
                col = ep.dim + jnp.mod(carry.sr_tick, ep.sr_noise_buffer)
                filt = _constrain(sr_predict_fast(filt, u, ep, col), mesh)
            else:
                filt = _constrain(ekf.predict(filt, u, ep), mesh)

            key, sub = jax.random.split(carry.key)
            scan = scan_from_ranges(ranges, beam_angles)
            obs, table = extract(carry.table, scan, filt.x, filt.n_active,
                                 sub, rp, ep.max_obs)
            pre_measure = filt
            if ep.update_mode == "srekf_fast":
                from .shard_update import sr_measure_shard_map
                filt = _constrain(
                    sr_measure_shard_map(filt, obs, u, ep, mesh), mesh)
            elif self.update_path == "shard_map":
                from .shard_update import measure_batched_shard_map
                filt = _constrain(
                    measure_batched_shard_map(filt, obs, u, ep, mesh), mesh)
            elif ep.update_mode == "batched":
                from ..models.batched import measure_batched
                filt = _constrain(measure_batched(filt, obs, u, ep), mesh)
            else:
                filt = _constrain(ekf.measure(filt, obs, u, ep), mesh)
            if ep.guard_max_jump is not None:
                # same tick-rollback guard as SlamSession (utils/faults.py);
                # the verdict reduction is O(D) and sharding-agnostic
                from ..utils.faults import guarded
                filt, _ = guarded(
                    pre_measure, filt, ep.guard_max_jump,
                    factored=ep.update_mode == "srekf_fast")
            if (self.maintain_merge_radius > 0
                    or self.maintain_max_trace > 0):
                from ..models.maintenance import maintain
                filt, _ = maintain(
                    filt, ep,
                    merge_radius=self.maintain_merge_radius,
                    max_trace=self.maintain_max_trace,
                    factored=ep.update_mode == "srekf_fast")
                filt = _constrain(filt, mesh)
            if ep.update_mode == "srekf_fast":
                # periodic factor recompression (GSPMD-placed Gram +
                # blocked Cholesky — a distributed GEMM; amortized over
                # the noise-buffer period like the single-chip session)
                from ..models.srekf_fast import sr_recompress
                filt = jax.lax.cond(
                    jnp.mod(carry.sr_tick + 1, ep.sr_noise_buffer) == 0,
                    sr_recompress, lambda s: s, filt)
                filt = _constrain(filt, mesh)
                sr_tick = carry.sr_tick + 1

            out = StepOutput(pose=filt.x[:3], n_active=filt.n_active,
                             n_obs=jnp.sum(obs.valid).astype(jnp.int32),
                             u=u, obs=obs)
            return SessionCarry(filt, table, odom_pose.astype(ep.dtype),
                                key, sr_tick=sr_tick), out

        self._step = jax.jit(step)

        def scan_all(carry, odom_poses, ranges, beam_angles):
            def body(c, inp):
                o, r = inp
                return step(c, o, r, beam_angles)
            return jax.lax.scan(body, carry, (odom_poses, ranges))

        self._run = jax.jit(scan_all)

    # -- construction -------------------------------------------------------
    def init_carry(self, first_odom=None) -> SessionCarry:
        sr_tick = None
        if self.ekf_params.update_mode == "srekf_fast":
            from ..models.srekf import factor_from_state
            filt = init_state(self.ekf_params,
                              pad_to_multiple_of=8 * self.n_map,
                              extra_dims=self.ekf_params.sr_noise_buffer)
            filt = factor_from_state(filt)
            sr_tick = jnp.zeros((), jnp.int32)
        else:
            filt = init_state(self.ekf_params,
                              pad_to_multiple_of=8 * self.n_map)
        filt = jax.device_put(filt, NamedSharding(self.mesh, P()))
        filt = filt._replace(P=jax.device_put(
            filt.P, NamedSharding(self.mesh, P("map", None))))
        old = (jnp.zeros((3,), self.ekf_params.dtype) if first_odom is None
               else jnp.asarray(first_odom, self.ekf_params.dtype))
        return SessionCarry(
            filt=filt,
            table=init_table(self.ransac_params),
            old_odom=old,
            key=jax.random.PRNGKey(self.seed),
            sr_tick=sr_tick,
        )

    # -- public API ---------------------------------------------------------
    def step(self, carry, odom_pose, ranges, beam_angles):
        return self._step(carry, jnp.asarray(odom_pose),
                          jnp.asarray(ranges), jnp.asarray(beam_angles))

    def run(self, odom_poses, ranges, beam_angles, carry=None):
        if carry is None:
            carry = self.init_carry(first_odom=odom_poses[0])
        return self._run(carry, jnp.asarray(odom_poses),
                         jnp.asarray(ranges), jnp.asarray(beam_angles))
