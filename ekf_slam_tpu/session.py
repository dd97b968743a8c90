"""SLAM session orchestrator — the reference's SLAM.m re-imagined.

The reference SLAM class wires algorithm selection (string dispatch,
SLAM.m:26-39), ROS topic receive, odometry→control conversion, and the
predict→measure→plot tick (SLAM.m:70-144).  Here the same roles exist but
the tick is a pure function ``(carry, inputs) → carry`` compiled once with
jit and driven by ``lax.scan`` over a whole sequence — so a full simulated
session runs as ONE device program with zero host round-trips.

Algorithm and extractor selection stay name-keyed registries, mirroring the
reference's string-dispatch pattern (SLAM.m:26, Landmark.m:14-21).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from .config import (EKFParams, RansacParams, ref_compat_known,
                     ref_compat_uc)
from .models import ekf
from .ops.angles import angdiff_deg, cosd, sind
from .ops.observations import ObsBatch
from .ops.ransac import LandmarkTable, extract, init_table
from .ops.scan import scan_from_ranges
from .state import FilterState, init_state

# ---------------------------------------------------------------------------
# Registries (string dispatch, as in SLAM.m:26-39 / Landmark.m:14-21)
# ---------------------------------------------------------------------------

ALGORITHMS: Dict[str, Callable[..., EKFParams]] = {
    # known-correspondence filter (EKF_SLAM.m)
    "EKF_SLAM": ref_compat_known,
    # unknown correspondence via signature gate (EKF_SLAM_UC.m) — the
    # reference's primary path (test_SLAM.m:14)
    "EKF_SLAM_UC": ref_compat_uc,
}

EXTRACTORS = {"RANSAC": (init_table, extract)}


class SessionCarry(NamedTuple):
    """Everything that persists across ticks — one pytree, so the whole
    session state is trivially checkpointable (utils/checkpointing.py)."""
    filt: FilterState
    table: LandmarkTable
    old_odom: jnp.ndarray   # f[3] previous odometry pose (SLAM.m:100-113)
    key: jnp.ndarray        # PRNG key for the extractor's sampling
    # previous scan in the robot frame — only carried when
    # control_source='icp' (scan-to-scan odometry); None otherwise.
    prev_pts: Optional[jnp.ndarray] = None     # f[B,2]
    prev_valid: Optional[jnp.ndarray] = None   # bool[B]
    # previous tick's control — the constant-velocity seed for the next
    # tick's scan match (icp/fused only): an UNSEEDED match loses
    # rotation during fast turns (a 9 deg/tick turn swings far points
    # past the pairing radius; measured as the dominant per-submap
    # heading error in the large-world campaign), while the previous u
    # predicts the swing almost exactly on a smooth platform.
    prev_u: Optional[jnp.ndarray] = None       # f[2]
    # tick counter — only carried for update_mode='srekf_fast', where it
    # schedules the process-noise buffer column and the periodic factor
    # recompression (models/srekf_fast.py); None otherwise.
    sr_tick: Optional[jnp.ndarray] = None      # i32 ()


class StepOutput(NamedTuple):
    pose: jnp.ndarray       # estimated robot pose after the tick
    n_active: jnp.ndarray   # landmark count
    n_obs: jnp.ndarray      # observations processed this tick
    u: jnp.ndarray          # control used
    obs: ObsBatch           # the tick's observation batch (for replay/parity)
    #: per-observation NIS ν'Φ⁻¹ν against the associated slot (NaN for
    #: invalid/new rows) — only populated with SlamSession(collect_nis=
    #: True); the filter-consistency statistic (~chi²(2) when healthy,
    #: utils/metrics.nis)
    nis: Optional[jnp.ndarray] = None


@dataclasses.dataclass
class SlamSession:
    """One live SLAM session: ``SlamSession('EKF_SLAM_UC').run(odom, scans)``.

    Equivalent to the reference's ``s = SLAM('EKF_SLAM_UC'); while(1)
    s.runSlam(); end`` (test_SLAM.m:14-18) with the ROS seam replaced by
    explicit arrays.
    """

    algorithm: str = "EKF_SLAM_UC"
    extractor: str = "RANSAC"
    ekf_params: Optional[EKFParams] = None
    ransac_params: Optional[RansacParams] = None
    seed: int = 0
    #: where the control u=[ΔD,Δθ] comes from: 'odometry' dead-reckons
    #: consecutive odometry poses (SLAM.m:105-107); 'icp' estimates the
    #: relative transform by scan-to-scan ICP (ops/icp.py) — for platforms
    #: without wheel odometry (no reference analog; the reference requires
    #: /odom) — in icp mode the odom_pose argument is ignored; 'fused'
    #: computes both and takes the ICP estimate when its quality gates
    #: pass (icp_min_inliers / icp_max_rmse), falling back to the
    #: dead-reckoned odometry otherwise (e.g. featureless corridors where
    #: the scan match degenerates).
    control_source: str = "odometry"
    icp_iters: int = 15
    icp_max_pair_dist: float = 0.5
    #: sign ΔD by the ICP translation direction in the previous robot
    #: frame (projection onto the chord heading ΔΘ/2), so backward motion
    #: yields a negative ΔD.  The odometry source keeps the reference's
    #: unsigned hypot (SLAM.m:105), which aliases reversing to forward —
    #: ICP can actually observe the sign, so it uses it by default.
    icp_signed: bool = True
    #: fused-mode quality gates: ICP wins only with at least this many
    #: inlier pairs and at most this RMS residual.
    icp_min_inliers: int = 30
    icp_max_rmse: float = 0.25
    #: map lifecycle (models/maintenance.py), run after each tick's
    #: measurement phase when enabled: merge near-duplicate landmarks
    #: within this radius (0 = off) …
    maintain_merge_radius: float = 0.0
    #: … and evict landmarks whose 2×2 covariance trace exceeds this
    #: (0 = off).  Eviction is exact marginalization + slot compaction —
    #: capacity gets reused instead of filling up forever (the reference
    #: map only ever grows).  Costs ~one extra P pass per tick; intended
    #: for bounded-capacity long-running sessions.
    maintain_max_trace: float = 0.0
    #: compute per-observation NIS (normalized innovation squared against
    #: the associated slot) in the step and emit it in StepOutput.nis —
    #: the standard EKF consistency statistic the campaign/metrics
    #: tooling consumes.  Costs one extra gate pass per tick (O(M·K)
    #: elementwise); off by default.
    collect_nis: bool = False
    #: donate the carry to the per-tick step program so the covariance is
    #: updated IN PLACE — without it, XLA holds input and output P
    #: simultaneously, and near the capacity ceiling a second P buffer does
    #: not fit in device memory.  None = auto: on when P ≥ 2 GB (a fixed
    #: size, not yet measured against a card's capacity).
    #: With donation, a carry passed to ``step`` is CONSUMED — keep only
    #: the returned carry.  ``run()``'s fused lax.scan still
    #: double-buffers its carry internally; at the capacity ceiling,
    #: drive the session tick-by-tick via ``step``/io.stream instead.
    donate_carry: Optional[bool] = None

    def __post_init__(self):
        if self.algorithm not in ALGORITHMS:
            raise ValueError(
                f"unknown algorithm {self.algorithm!r}; "
                f"choose from {sorted(ALGORITHMS)}")
        if self.extractor not in EXTRACTORS:
            raise ValueError(
                f"unknown extractor {self.extractor!r}; "
                f"choose from {sorted(EXTRACTORS)}")
        if self.control_source not in ("odometry", "icp", "fused"):
            raise ValueError(
                f"unknown control_source {self.control_source!r}; "
                f"choose from ['fused', 'icp', 'odometry']")
        if self.ekf_params is None:
            self.ekf_params = ALGORITHMS[self.algorithm]()
        if self.ransac_params is None:
            self.ransac_params = RansacParams(dtype=self.ekf_params.dtype)
        self._init_table, self._extract = EXTRACTORS[self.extractor]
        if self.donate_carry is None:
            # auto: in-place stepping once P alone is a 2 GB-class buffer
            d = self.ekf_params.dim
            p_bytes = d * d * jnp.dtype(self.ekf_params.cov_dt).itemsize
            self.donate_carry = p_bytes >= 2 * 1024 ** 3
        step = self._make_step()
        self._step = (jax.jit(step, donate_argnums=(0,))
                      if self.donate_carry else jax.jit(step))

        def scan_all(carry, odom_poses, ranges, beam_angles):
            def body(c, inp):
                o, r = inp
                return step(c, o, r, beam_angles)
            return jax.lax.scan(body, carry, (odom_poses, ranges))

        self._run = jax.jit(scan_all)

    # -- construction -------------------------------------------------------
    def init_carry(self, first_odom=None, n_beams: Optional[int] = None,
                   init_pose=None) -> SessionCarry:
        """Build the initial carry.

        ``init_pose``: start the filter at this [x, y, theta_deg] instead
        of the origin (the reference hardcodes x0 = 0, EKF_SLAM.m:28 —
        fine when the robot powers up at its own frame origin, but a
        session evaluated against a world-frame ground truth, or resumed
        into a known map, needs the filter frame anchored; the extractor's
        landmark feet are measured from the FILTER frame's origin, so the
        anchoring changes landmark identity, not just reporting)."""
        sr_tick = None
        if self.ekf_params.update_mode == "srekf_fast":
            # pad the state with the noise-buffer columns and carry the
            # factor in the P field (models/srekf_fast.py)
            from .models.srekf import factor_from_state
            filt = init_state(self.ekf_params,
                              extra_dims=self.ekf_params.sr_noise_buffer)
            filt = factor_from_state(filt)
            sr_tick = jnp.zeros((), jnp.int32)
        else:
            filt = init_state(self.ekf_params)
            if self.ekf_params.update_mode == "srekf":
                # carry the Cholesky factor in the P field (models/srekf.py)
                from .models.srekf import factor_from_state
                filt = factor_from_state(filt)
        if init_pose is not None:
            filt = filt._replace(x=filt.x.at[:3].set(
                jnp.asarray(init_pose, filt.x.dtype)))
        old = (jnp.zeros((3,), self.ekf_params.dtype)
               if first_odom is None
               else jnp.asarray(first_odom, self.ekf_params.dtype))
        prev_pts = prev_valid = prev_u = None
        if self.control_source in ("icp", "fused"):
            if n_beams is None:
                raise ValueError(
                    f"control_source={self.control_source!r} needs n_beams "
                    "at init_carry (the previous scan is part of the carry)")
            # empty previous scan → first tick's ICP finds no pairs → u=0
            prev_pts = jnp.zeros((n_beams, 2), self.ekf_params.dtype)
            prev_valid = jnp.zeros((n_beams,), bool)
            prev_u = jnp.zeros((2,), self.ekf_params.dtype)
        return SessionCarry(
            filt=filt,
            table=self._init_table(self.ransac_params),
            old_odom=old,
            key=jax.random.PRNGKey(self.seed),
            prev_pts=prev_pts,
            prev_valid=prev_valid,
            sr_tick=sr_tick,
            prev_u=prev_u,
        )

    def _make_step(self):
        ep, rp = self.ekf_params, self.ransac_params

        def step(carry: SessionCarry, odom_pose, ranges, beam_angles
                 ) -> Tuple[SessionCarry, StepOutput]:
            scan = scan_from_ranges(ranges, beam_angles)
            prev_pts = prev_valid = prev_u = None
            if self.control_source in ("icp", "fused"):
                # scan-to-scan odometry: align this scan onto the previous
                # one (robot frame) — the transform IS the robot's motion
                # expressed in the previous robot frame (ops/icp.py).
                from .ops.icp import icp
                from .ops.scan import to_cartesian
                pts = to_cartesian(scan).astype(ep.dtype)
                # constant-velocity seed from the previous tick's control
                # (see SessionCarry.prev_u): chord translation at the
                # half-angle heading + the previous turn rate
                pD, pTh = carry.prev_u[0], carry.prev_u[1]
                seed = jnp.stack([pD * cosd(0.5 * pTh),
                                  pD * sind(0.5 * pTh), pTh])
                with jax.named_scope("icp_control"):
                    res = icp(pts, scan.valid, carry.prev_pts,
                              carry.prev_valid, iters=self.icp_iters,
                              init_pose=seed,
                              max_pair_dist=self.icp_max_pair_dist)
                dTh = res.pose[2]
                mag = jnp.linalg.norm(res.pose[:2])
                if self.icp_signed:
                    # diff-drive chord points along heading ΔΘ/2 in the
                    # previous frame: a negative projection means the
                    # robot moved backward — sign ΔD accordingly (the
                    # reference's unsigned hypot, SLAM.m:105, aliases
                    # reversing to forward).
                    half = dTh * 0.5
                    proj = (res.pose[0] * cosd(half)
                            + res.pose[1] * sind(half))
                    dD = jnp.where(proj < 0, -mag, mag)
                else:
                    dD = mag
                prev_pts, prev_valid = pts, scan.valid
                if self.control_source == "fused":
                    # ICP wins only when the match is trustworthy;
                    # otherwise dead-reckon the odometry (SLAM.m:105-107).
                    dD_o = jnp.sqrt(
                        (odom_pose[0] - carry.old_odom[0]) ** 2
                        + (odom_pose[1] - carry.old_odom[1]) ** 2)
                    dTh_o = angdiff_deg(carry.old_odom[2], odom_pose[2])
                    ok = ((res.n_inliers >= self.icp_min_inliers)
                          & (res.rmse <= self.icp_max_rmse))
                    dD = jnp.where(ok, dD, dD_o)
                    dTh = jnp.where(ok, dTh, dTh_o)
            else:
                # control from consecutive odometry poses (SLAM.m:105-107)
                dD = jnp.sqrt((odom_pose[0] - carry.old_odom[0]) ** 2
                              + (odom_pose[1] - carry.old_odom[1]) ** 2)
                dTh = angdiff_deg(carry.old_odom[2], odom_pose[2])
            u = jnp.stack([dD, dTh]).astype(ep.dtype)
            if self.control_source in ("icp", "fused"):
                prev_u = u

            with jax.named_scope("ekf_predict"):
                if ep.update_mode == "srekf":
                    from .models.srekf import sr_predict
                    filt = sr_predict(carry.filt, u, ep)
                elif ep.update_mode == "srekf_fast":
                    # this tick's fresh zero column of the factor: the
                    # buffer starts right past the last slot dim (3+2K)
                    from .models.srekf_fast import sr_predict_fast
                    col = ep.dim + jnp.mod(carry.sr_tick,
                                           ep.sr_noise_buffer)
                    filt = sr_predict_fast(carry.filt, u, ep, col)
                else:
                    filt = ekf.predict(carry.filt, u, ep)  # SLAM.m:110

            key, sub = jax.random.split(carry.key)
            with jax.named_scope("ransac_extract"):
                obs, table = self._extract(carry.table, scan, filt.x,
                                           filt.n_active, sub, rp,
                                           ep.max_obs, sig=filt.sig)
            nis_rows = None
            if self.collect_nis:
                # one extra gate pass against the SAME pre-measure state
                # the measurement phase associates with — position cost at
                # the winning slot IS the per-observation NIS
                from .ops.association import batch_costs, gate_batch
                zsn = jnp.stack([obs.rng, obs.bearing,
                                 obs.index.astype(ep.dtype)], axis=-1)
                Rsn = ekf.obs_noise_batch(obs, zsn, ep)
                strips = None
                if ep.update_mode in ("srekf", "srekf_fast"):
                    from .models.srekf import sr_strips
                    strips = sr_strips(filt.P, ep.capacity,
                                       triangular=ep.update_mode == "srekf")
                if ep.association == "known":
                    is_new_n = (zsn[:, 2]
                                > filt.n_active.astype(ep.dtype))
                    slots_n = jnp.clip(obs.index - 1, 0, ep.capacity - 1)
                else:
                    is_new_n, slots_n = gate_batch(filt, zsn, Rsn, ep,
                                                   strips=strips)[:2]
                pos_cost, _ = batch_costs(filt, zsn, Rsn, ep,
                                          strips=strips)
                got = obs.valid & ~is_new_n & (filt.n_active > 0)
                nis_rows = jnp.where(
                    got,
                    jnp.take_along_axis(pos_cost, slots_n[:, None],
                                        axis=1)[:, 0],
                    jnp.nan).astype(ep.dtype)
            pre_measure = filt
            with jax.named_scope("ekf_measure"):
                if ep.update_mode == "batched":
                    from .models.batched import measure_batched
                    filt = measure_batched(filt, obs, u, ep)
                elif ep.update_mode == "srekf":
                    from .models.srekf import sr_measure_batched
                    filt = sr_measure_batched(filt, obs, u, ep)
                elif ep.update_mode == "srekf_fast":
                    from .models.srekf_fast import sr_measure_fast
                    filt = sr_measure_fast(filt, obs, u, ep)
                else:
                    filt = ekf.measure(filt, obs, u, ep)   # SLAM.m:116
            if ep.guard_max_jump is not None:
                from .utils.faults import guarded
                filt, _ = guarded(
                    pre_measure, filt, ep.guard_max_jump,
                    factored=ep.update_mode in ("srekf", "srekf_fast"))
            if (self.maintain_merge_radius > 0
                    or self.maintain_max_trace > 0):
                # factored states route through the factor-space evict
                # (row permutation + recompress — maintenance.py)
                from .models.maintenance import maintain
                filt, _ = maintain(
                    filt, ep,
                    merge_radius=self.maintain_merge_radius,
                    max_trace=self.maintain_max_trace,
                    factored=ep.update_mode in ("srekf", "srekf_fast"))

            sr_tick = carry.sr_tick
            if ep.update_mode == "srekf_fast":
                # every sr_noise_buffer ticks the spare columns run out:
                # recompress the general factor back to triangular (one
                # D² GEMM + Cholesky, amortized over the whole buffer)
                from .models.srekf_fast import sr_recompress
                filt = jax.lax.cond(
                    jnp.mod(carry.sr_tick + 1, ep.sr_noise_buffer) == 0,
                    sr_recompress, lambda s: s, filt)
                sr_tick = carry.sr_tick + 1

            out = StepOutput(pose=filt.x[:3],
                             n_active=filt.n_active,
                             n_obs=jnp.sum(obs.valid).astype(jnp.int32),
                             u=u, obs=obs, nis=nis_rows)
            return SessionCarry(filt=filt, table=table,
                                old_odom=odom_pose.astype(ep.dtype),
                                key=key, prev_pts=prev_pts,
                                prev_valid=prev_valid, sr_tick=sr_tick,
                                prev_u=prev_u), out

        return step

    # -- public API ---------------------------------------------------------
    def step(self, carry: SessionCarry, odom_pose, ranges, beam_angles
             ) -> Tuple[SessionCarry, StepOutput]:
        """One runSlam() tick (SLAM.m:70-144 minus plotting)."""
        return self._step(carry, jnp.asarray(odom_pose),
                          jnp.asarray(ranges), jnp.asarray(beam_angles))

    def run(self, odom_poses, ranges, beam_angles,
            carry: Optional[SessionCarry] = None
            ) -> Tuple[SessionCarry, StepOutput]:
        """Run a whole sequence as one fused lax.scan device program.

        odom_poses: f[T,3]; ranges: f[T,B]; beam_angles: f[B].
        Returns the final carry and stacked per-tick outputs.
        """
        if carry is None:
            carry = self.init_carry(
                first_odom=odom_poses[0],
                n_beams=(jnp.asarray(ranges).shape[1]
                         if self.control_source in ("icp", "fused")
                         else None))
        return self._run(carry, jnp.asarray(odom_poses),
                         jnp.asarray(ranges), jnp.asarray(beam_angles))
