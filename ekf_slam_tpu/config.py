"""Typed configuration for the accelerator-native EKF-SLAM engine.

The reference (SamShue/EKF_SLAM) hard-codes all tuning as class properties and
local variables (EKF_SLAM.m:12-16, EKF_SLAM_UC.m:12-16, RANSAC.m:67-90,
SLAM.m:26-39).  Here the same knobs are typed, frozen dataclasses with the
reference values as the ``ref_compat`` presets, so a single config object pins
an entire reproducible run.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax.numpy as jnp

# ---------------------------------------------------------------------------
# Association / algorithm modes
# ---------------------------------------------------------------------------
#: signature-only gating — reproduces the shipped reference behavior
#: (Correspondence.m:75 uses only the signature cost; the Mahalanobis
#: position cost is computed and discarded at Correspondence.m:69-74).
ASSOC_SIGNATURE = "signature"
#: full maximum-likelihood gate: Mahalanobis position cost (+ signature),
#: the math the reference builds but never uses.
ASSOC_ML = "ml"
#: full ML gate + batch-level mutual exclusion: each landmark accepts only
#: its lowest-cost claimant per batch; out-claimed observations are treated
#: as new candidates.  The reference's sequential loop re-gates every
#: observation against the updated state and can still double-associate
#: (Correspondence.m gives no exclusivity); the batched gate's independent
#: argmins can too — this mode closes that hole with two parallel
#: scatter-mins (ops/association.gate_batch).
ASSOC_ML_UNIQUE = "ml_unique"
#: known correspondence — the EKF_SLAM.m path where z carries the landmark id.
ASSOC_KNOWN = "known"


@dataclasses.dataclass(frozen=True)
class EKFParams:
    """Filter-core parameters.

    Reference values: ``C`` EKF_SLAM.m:12, ``rc`` EKF_SLAM_UC.m:13 (UC) /
    EKF_SLAM.m:13 (known-corr) / SLAM_ransac.m:17 (legacy), ``s_cost`` /
    ``s_thresh`` EKF_SLAM_UC.m:16, initial covariance EKF_SLAM.m:30-31.
    """

    #: landmark capacity K — state is padded to 3+2K and masked
    #: (replaces the reference's rank-growing concat at EKF_SLAM.m:79,91).
    capacity: int = 128
    #: max observation slots processed per tick (reference loops over however
    #: many rows RANSAC returned, EKF_SLAM_UC.m:109).
    max_obs: int = 16

    #: process-noise constant C (EKF_SLAM.m:12).
    c_process: float = 0.2
    #: constant per-tick process-noise floor added to the pose block's
    #: diagonal: (var_x m², var_y m², var_theta deg²).  The reference's
    #: Q = C·W·Wᵀ is RANK-1 and scales with the control (EKF_SLAM.m:42-44)
    #: — driving straight (dTheta=0) adds ZERO heading noise, so a filter
    #: fed real (noisy-every-tick) odometry grows overconfident, its gate
    #: rejects honest re-observations, and the map fills with shifted
    #: duplicates (measured: the large-world campaign diverged exactly
    #: this way).  Matching the floor to the actual per-tick odometry
    #: noise keeps the gate honest.  (0,0,0) = reference behavior.
    q_floor: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    #: measurement-noise constants; R = diag(r*rc[0], phi*rc[1])
    #: (EKF_SLAM_UC.m:110 — noise scales with the measured values).
    rc: Tuple[float, float] = (0.1, 5.0)
    #: how rc builds the measurement noise R (models/ekf
    #: .measurement_noise):
    #:   'scaled'   — the reference model R = diag(z_r*rc0, z_phi*rc1)
    #:                (EKF_SLAM_UC.m:110).  Note its quirk: the bearing
    #:                VARIANCE scales with the measured bearing VALUE, so
    #:                an observation at phi~0 deg gets a near-zero-noise
    #:                gate while the same landmark seen at phi~359 gets a
    #:                ~360x sloppier one — an artifact of the wrap
    #:                convention, kept for parity;
    #:   'constant' — R = diag(rc0², rc1²), i.e. rc = (sigma_r meters,
    #:                sigma_phi degrees) as honest constant stds.  The
    #:                sane choice for ML gating at scale (the large-world
    #:                campaign measured the scaled gate mis-associating
    #:                through the phi~0 pathology);
    #:   'fit'      — per-observation R propagated from the extractor's
    #:                line-fit covariance (ObsBatch.R: full 2x2,
    #:                anisotropic — the perpendicular-foot landmark's
    #:                error is ~lever_arm x fit-angle error along the
    #:                wall line vs centimeters across it), PLUS the
    #:                diag(rc0², rc1²) constant floor.  The statistically
    #:                honest model for the reference's foot features at
    #:                large-world scale; requires observations from the
    #:                RANSAC extractor (rows without ObsBatch.R fall
    #:                back to the constant floor).
    noise_model: str = "scaled"
    #: signature cost scale (EKF_SLAM_UC.m:16 → Correspondence.m:71).
    s_cost: float = 1e-11
    #: new-landmark gate threshold (EKF_SLAM_UC.m:16 → Correspondence.m:78).
    s_thresh: float = 1e9
    #: initial pose covariance diagonal (EKF_SLAM.m:30).
    p0_diag: float = 0.1

    #: association mode — see ASSOC_* constants.
    association: str = ASSOC_SIGNATURE

    #: ml_unique only: what happens to a gated observation that LOSES its
    #: slot claim to a lower-cost observation in the same batch.
    #:   'append' — the loser is flagged is_new and APPENDED as a new
    #:              landmark (the historical behavior).  Safe inside a
    #:              session, where the extractor dedupes observations per
    #:              tick; a direct gate_batch/measure_batched user feeding
    #:              two observations of the same landmark in one batch
    #:              gets a duplicate landmark per loser (pair with
    #:              maintain_merge_radius to reabsorb them).
    #:   'drop'   — the loser is treated as invalid for this batch:
    #:              neither updated nor appended (re-observe next tick —
    #:              the reference's sequential loop would simply have
    #:              re-associated it, Correspondence.m:49-87).
    ml_losers: str = "append"

    #: measurement-phase scheduling: 'sequential' replays the reference's
    #: per-observation update chain (EKF_SLAM_UC.m:109-150, bit-parity
    #: path); 'batched' applies one joint rank-2M update per tick
    #: (models/batched.py, the fast path — one pass over P per tick);
    #: 'srekf' propagates the Cholesky factor of P instead of P itself
    #: (models/srekf.py — PSD by construction at any precision; QR
    #: re-triangularization per tick, O(D³) — small-capacity only);
    #: 'srekf_fast' propagates a GENERAL square root with the closed-form
    #: Andrews update (models/srekf_fast.py — same PSD-by-construction
    #: guarantee in O(M·D²) GEMM-only work; THE square-root option at
    #: 10k-landmark scale).
    update_mode: str = "sequential"

    #: srekf_fast only: number of spare state dims reserved as zero factor
    #: columns for exact O(D) rank-1 process-noise absorption — one column
    #: is consumed per predict; when all are used the factor is
    #: recompressed (one D² GEMM + Cholesky, amortized over the buffer).
    sr_noise_buffer: int = 64

    #: batched-mode scheduling: apply the tick's joint update in this many
    #: sequential chunks of M/update_chunks observations each (gating still
    #: happens once against the tick's prior state).  The innovation solve
    #: costs O((2M)^3) while the P passes cost O(D^2) — when D is small the
    #: solve dominates and chunking trades cheap extra P passes for a
    #: quadratically cheaper per-update solve.  1 = single joint update.
    update_chunks: int = 1

    #: how the batched update forms P·Hᵀ:
    #:   'dense' — scatter Hᵀ into a dense [D,2M] operand and run the full
    #:             D²·2M GEMM (round-1 design; no assumption on P);
    #:   'rows'  — exploit P's symmetry: P·Hᵀ = (H·P)ᵀ needs only the 2M+3
    #:             OBSERVED rows of P (pose rows + one contiguous row pair
    #:             per gated landmark), gathered as whole rows.  Halves the
    #:             chain's matmul flops and drops one full pass over P.
    #:             Requires symmetric P, which the batched update
    #:             preserves exactly in algebra (posterior = P − Z·S⁻¹·Zᵀ)
    #:             and to fp round-off in practice; the sequential
    #:             ref-compat path keeps 'dense' semantics.
    pht_mode: str = "dense"

    #: how the batched update applies the rank-2M covariance correction
    #: P ← P − PHᵀ·S⁻¹·(PHᵀ)ᵀ:
    #:   'gemm' — the dense GEMM P − Kg·HP (Kg = PHᵀ·S⁻¹);
    #:   'syrk' — the symmetric form: with S = L·Lᵀ the correction is
    #:            W·Wᵀ (W = PHᵀ·L⁻ᵀ, models/batched.syrk_downdate), a
    #:            product of one operand with its own transpose, and the
    #:            mean update reuses W (no S⁻¹ or Kg is formed).  Any D.
    #:            Incompatible with joseph (its correction is not W·Wᵀ).
    correction: str = "gemm"

    #: failure detection (utils/faults.py): if set, a tick whose measurement
    #: phase moves the pose more than this many meters — or produces
    #: non-finite state / negative covariance — is rolled back and treated
    #: as lost input.  None disables the guard (reference behavior: the
    #: 0/360-seam innovation quirk can throw the pose ~18 m unguarded).
    guard_max_jump: float = None

    #: reproduce the reference's numeric quirks exactly (SURVEY.md §2.3):
    #:  - bearing innovation NOT re-wrapped after subtraction (EKF_SLAM_UC.m:145)
    #:  - motion Jacobian evaluated at theta (pre-increment) and WITHOUT the
    #:    pi/180 factor a degree-valued state requires (EKF_SLAM.m:62-64)
    #:  - append Jacobians jz built from (dD, dTheta) instead of the
    #:    inverse-measurement bearing (EKF_SLAM.m:87-88)
    ref_compat: bool = True

    #: express predict's sparse F·P·Fᵀ row/col updates and append's
    #: covariance block writes as elementwise where-selects over the full
    #: P plane instead of scatter/dynamic-update-slice ops.  Under a
    #: row-sharded P the scatter forms force GSPMD to all-gather the whole
    #: covariance (measured: 2×P per append + 1×P per predict tick at any
    #: capacity, experiments/scaling_harness.py); the masked forms are
    #: purely local.  Costs an O(D²/n) elementwise pass where the scatter
    #: was O(D), so it is enabled automatically by ShardedSlamSession and
    #: off for single-chip runs.
    masked_writes: bool = False

    #: Joseph-form covariance update (symmetric/PSD-preserving) instead of the
    #: reference's (I-KH)P form (EKF_SLAM_UC.m:146) which loses symmetry.
    joseph: bool = False
    #: re-symmetrize P after each update (cheap PSD-drift guard).
    symmetrize: bool = False

    dtype: Any = jnp.float32
    #: storage dtype for the covariance P ONLY (None → same as ``dtype``).
    #: ``jnp.bfloat16`` halves the memory traffic of the P-streaming passes
    #: while all large contractions accumulate in f32 and the mean/solves
    #: stay in ``dtype``
    #: (mixed precision, models/batched.py).  Supported by the batched
    #: update path + gate; the sequential bit-parity path and srekf keep
    #: full-precision storage.
    cov_dtype: Any = None

    def __post_init__(self):
        if self.pht_mode not in ("dense", "rows"):
            raise ValueError(f"unknown pht_mode {self.pht_mode!r}")
        if self.update_mode not in ("sequential", "batched", "srekf",
                                    "srekf_fast"):
            raise ValueError(f"unknown update_mode {self.update_mode!r}")
        # Square-root modes carry their own covariance representation; the
        # dense-path knobs below would be silently ignored — reject the
        # combination at construction instead (the failure mode this
        # validation exists for: no silently-dead flags).
        if self.update_mode in ("srekf", "srekf_fast"):
            ignored = [
                ("cov_dtype", self.cov_dtype is not None),
                ("joseph", self.joseph),
                ("symmetrize", self.symmetrize),
                ("masked_writes", self.masked_writes),
                ("pht_mode='rows'", self.pht_mode == "rows"),
                # the factor predicts absorb process noise as rank-1
                # column deposits (srekf_fast) / pre-array blocks (srekf)
                # built from the reference's C·w·wᵀ only
                ("q_floor", any(q > 0 for q in self.q_floor)),
            ]
            bad = [name for name, hit in ignored if hit]
            if bad:
                raise ValueError(
                    f"update_mode={self.update_mode!r} ignores dense-path "
                    f"options {bad}; unset them (square-root filters keep "
                    "full-precision factor storage and have the row-gather "
                    "built in)")
        if self.association not in (ASSOC_SIGNATURE, ASSOC_ML,
                                    ASSOC_ML_UNIQUE, ASSOC_KNOWN):
            raise ValueError(f"unknown association {self.association!r}")
        if self.noise_model not in ("scaled", "constant", "fit"):
            raise ValueError(f"unknown noise_model {self.noise_model!r}; "
                             "use 'scaled' (reference), 'constant' or "
                             "'fit'")
        if self.noise_model != "scaled" and self.ref_compat:
            raise ValueError(
                f"noise_model={self.noise_model!r} departs from the "
                "reference's value-scaled R (EKF_SLAM_UC.m:110) — unset "
                "ref_compat")
        if self.ml_losers not in ("append", "drop"):
            raise ValueError(f"unknown ml_losers {self.ml_losers!r}; "
                             "use 'append' or 'drop'")
        if self.ml_losers == "drop" and self.association != ASSOC_ML_UNIQUE:
            raise ValueError(
                "ml_losers='drop' only applies to association='ml_unique' "
                "(no other mode produces batch-level losers)")
        if self.correction not in ("gemm", "syrk"):
            raise ValueError(f"unknown correction {self.correction!r}")
        if self.correction == "syrk" and self.joseph:
            raise ValueError(
                "correction='syrk' computes the plain symmetric downdate "
                "W·Wᵀ; the Joseph form's correction is not of that shape — "
                "unset joseph (syrk already preserves symmetry exactly)")
        if self.correction == "syrk" and self.update_mode in (
                "srekf", "srekf_fast"):
            raise ValueError(
                "correction='syrk' applies to the dense batched update "
                "only; square-root modes never form the dense correction")
        if self.update_mode == "srekf" and self.update_chunks > 1:
            raise ValueError(
                "update_chunks is not supported by the QR srekf path "
                "(one pre-array per tick); use update_mode='srekf_fast'")
        if self.update_mode == "srekf_fast" and self.sr_noise_buffer < 1:
            raise ValueError(
                "update_mode='srekf_fast' needs sr_noise_buffer >= 1 "
                "(spare zero columns for O(D) process-noise absorption)")

    @property
    def cov_dt(self):
        """Effective covariance storage dtype."""
        return self.dtype if self.cov_dtype is None else self.cov_dtype

    @property
    def dim(self) -> int:
        """Padded joint state dimension D = 3 + 2K."""
        return 3 + 2 * self.capacity


@dataclasses.dataclass(frozen=True)
class RansacParams:
    """Landmark-extraction parameters (reference constants RANSAC.m:67-90)."""

    #: inlier count needed for a line to count as a wall (RANSAC.m:67).
    line_consensus: int = 300
    #: max wall searches per scan (RANSAC.m:70).
    wall_search_timeout: int = 3
    #: points sampled to seed the trial line (RANSAC.m:73).
    sample_points: int = 20
    #: full width of the bearing window around the seed point (RANSAC.m:75).
    bearing_window_deg: float = 5.0
    #: max point-line distance for inliers (RANSAC.m:79).
    inlier_dist: float = 0.25
    #: candidate-to-candidate association radius (RANSAC.m:83).
    assoc_dist: float = 0.50
    #: sightings needed before promotion to an official landmark (RANSAC.m:87;
    #: the check is strictly-greater after increment, RANSAC.m:261, so
    #: promotion happens on sighting promote_count+1).
    promote_count: int = 10
    #: ticks an unpromoted candidate survives without decay reset (RANSAC.m:90;
    #: decremented every tick at RANSAC.m:321-331 — it is a lifetime, not an
    #: inactivity timer).
    freshness: int = 50

    #: candidate-table capacity (reference list grows unbounded, RANSAC.m:297).
    table_capacity: int = 256
    #: how a candidate foot associates to the table:
    #:   'all'     — EVERY entry within assoc_dist matches (the
    #:               reference's broken break at RANSAC.m:289: all of
    #:               them increment, snap, and emit an observation row);
    #:               with duplicate promoted entries this emits the SAME
    #:               measured foot as several "independent" observations
    #:               per tick — the joint update then applies it
    #:               multiply, collapsing covariance and yanking the
    #:               pose (measured campaign divergence driver);
    #:   'nearest' — only the nearest entry within assoc_dist matches:
    #:               one observation row per physical measurement.
    match_mode: str = "all"
    #: extra tightened refit passes after a wall is accepted: each pass
    #: re-selects inliers within ``refine_frac`` x the previous distance
    #: threshold and refits.  0 = reference behavior (single refit over
    #: everything within inlier_dist, RANSAC.m:206-209).  Why it exists:
    #: in large multi-wall worlds the refit band sweeps up points of
    #: NEIGHBORING near-collinear walls near their intersection, biasing
    #: the fitted angle by ~1 deg — and the landmark (the perpendicular
    #: foot from the WORLD ORIGIN, RANSAC.m:220) amplifies angle error by
    #: the origin lever arm, scattering repeat observations of one wall
    #: by ~0.5 m (measured: extractor-only probe, 3x3-room floorplan) —
    #: past the association radius, so every wall spawns duplicate
    #: candidates.  Two tightened passes cut the contamination band ~4x.
    refine_passes: int = 0
    #: per-pass inlier-band shrink factor for refine_passes.
    refine_frac: float = 0.5
    #: if >0 (degrees), split accepted walls at the KINK between two
    #: almost-collinear physical walls that meet without a gap (e.g. the
    #: per-cell boundary walls of a floorplan): fit the left and right
    #: halves of the inlier chord; when their angles disagree by more
    #: than this, cut at the half-lines' intersection, keep the side
    #: with more points, and refit.  Complements split_gap (which needs
    #: a spatial gap to trigger).  0 = reference behavior.
    split_kink_deg: float = 0.0
    #: if >0, reject accepted walls whose final inlier RMS perpendicular
    #: residual exceeds this (meters).  Merged or contaminated fits —
    #: the source of the heavy outlier tail in the perpendicular-foot
    #: landmarks — carry visibly higher residuals than a clean
    #: single-wall fit (~ the scan noise), so an RMS gate of a few times
    #: the range noise drops exactly the fits whose feet would otherwise
    #: pass the filter's gate with ~1 m errors.  0 = reference behavior
    #: (no quality gate).
    max_fit_rms: float = 0.0
    #: if >0, split accepted walls at the largest internal gap of the
    #: inlier chord when that gap exceeds this length (meters), keeping
    #: the side with more points (re-fit), and leaving the other side in
    #: the pool for its own hypothesis.  0 = reference behavior.  Why:
    #: two near-collinear walls from NEIGHBORING rooms (a door-split or
    #: across-room pair) can jointly out-score either single wall, and
    #: the merged fit's foot lands between the two true lines — measured
    #: as the dominant foot-error mode at scale (span>6 m fits carried
    #: p90 ~1.2 m foot error vs ~0.05 m for single-wall fits; the gap in
    #: the merged chord is exactly the doorway).  1.2 m (smaller than a
    #: door) is a good default when enabled.
    split_gap: float = 0.0
    #: >0: use the batched-hypothesis wall search (NH seed lines scored in
    #: one fused pass, ops/ransac.find_walls_batched) instead of the
    #: reference's one-seed-per-round loop.  0 = ref-style sequential.
    n_hypotheses: int = 0
    #: two-quadrant atand(y/x) bearing window (RANSAC.m:160-166 quirk) instead
    #: of four-quadrant atan2d.
    ref_compat: bool = True
    #: write-back of filter estimates into the extractor table: the reference
    #: loop `for ii=(len-3)/2` iterates a single value so only the LAST state
    #: landmark is written back (RANSAC.m:355).  False → write back all.
    writeback_last_only: bool = True
    #: how write-back maps table entries to filter slots:
    #:   'ref' — positional: table index i ↦ filter slot i-1 (the
    #:           reference's assumption, RANSAC.m:336-373 — valid only
    #:           while landmarks are appended in exact promotion order);
    #:   'sig' — match by SIGNATURE: the filter stores each landmark's
    #:           table index as its signature, so the slot is found by
    #:           sig equality — correct under ML association, duplicate
    #:           appends, and maintenance compaction/eviction (which
    #:           permute slots and silently break the positional map:
    #:           measured as a campaign-scale divergence driver — wrong
    #:           positions written into the table corrupt candidate
    #:           association and twist the filter heading);
    #:   'off' — no write-back (table locs stay at the latest measured
    #:           feet).
    writeback_mode: str = "ref"

    dtype: Any = jnp.float32

    def __post_init__(self):
        if self.writeback_mode not in ("ref", "sig", "off"):
            raise ValueError(
                f"unknown writeback_mode {self.writeback_mode!r}; "
                "use 'ref', 'sig' or 'off'")
        if self.match_mode not in ("all", "nearest"):
            raise ValueError(f"unknown match_mode {self.match_mode!r}; "
                             "use 'all' (reference) or 'nearest'")


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Deterministic simulator replacing the ROS seam (SLAM.m:73-74,118)."""

    n_beams: int = 1024
    fov_deg: float = 360.0
    max_range: float = 8.0
    range_noise_std: float = 0.01
    #: odometry noise injected on the dead-reckoned pose deltas
    odom_xy_noise_std: float = 0.002
    odom_theta_noise_std: float = 0.05
    dtype: Any = jnp.float32


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for the sharded filter (no reference analog —
    the reference is single-threaded MATLAB, SURVEY.md §2)."""

    #: devices along the map/landmark-tile axis.
    map_axis: int = 1
    axis_name: str = "map"


def ref_compat_uc(capacity: int = 128, **kw) -> EKFParams:
    """EKF_SLAM_UC preset (EKF_SLAM_UC.m:12-16)."""
    kw.setdefault("rc", (0.1, 5.0))
    kw.setdefault("association", ASSOC_SIGNATURE)
    kw.setdefault("ref_compat", True)
    return EKFParams(capacity=capacity, **kw)


def ref_compat_known(capacity: int = 128, **kw) -> EKFParams:
    """EKF_SLAM preset, known correspondence (EKF_SLAM.m:12-16)."""
    kw.setdefault("rc", (0.01, 5.0))
    kw.setdefault("association", ASSOC_KNOWN)
    kw.setdefault("ref_compat", True)
    return EKFParams(capacity=capacity, **kw)


def ref_compat_legacy(capacity: int = 128, **kw) -> EKFParams:
    """Legacy script-pipeline preset (SLAM_ransac.m:17: Rc = [10, 1]).

    The reference's inlined functional pipeline used different measurement
    noise than either filter class; it also relied on free functions
    (append.m) rather than the classes — the analog here is driving
    models/ekf.py's pure functions directly (examples/legacy_pipeline.py).
    """
    kw.setdefault("rc", (10.0, 1.0))
    kw.setdefault("association", ASSOC_KNOWN)
    kw.setdefault("ref_compat", True)
    return EKFParams(capacity=capacity, **kw)


def sim_ransac(n_beams: int = 1024, **kw) -> RansacParams:
    """RANSAC preset scaled to the simulator's beam density.

    The reference constants assume a dense Kinect scan (~640+ returns per
    wall); with ``n_beams`` over 360 deg each wall subtends far fewer beams,
    so the consensus scales proportionally.
    """
    consensus = max(20, int(300 * n_beams / 640 / 8))
    return RansacParams(line_consensus=consensus, bearing_window_deg=20.0,
                        **kw)
