"""RANSAC wall/landmark extraction — JAX-native, fixed-shape.

Re-design of the reference extractor (RANSAC.m:14-152):

* the sequential ``while`` hypothesis loop (RANSAC.m:114-128) becomes a
  ``lax.scan`` over a fixed number of rounds, each fully vectorized over all
  beams (mask instead of deletion);
* the Symbolic-Toolbox 2×2 solve for the perpendicular foot (RANSAC.m:223-227)
  becomes the closed form (−mb, b)/(1+m²);
* the growing landmark struct array (RANSAC.m:238-300) becomes a
  fixed-capacity masked table with the same observe-count / promotion /
  freshness semantics.

The candidate-table semantics intentionally reproduce reference quirks
(SURVEY.md §2.3): the two-quadrant atand bearing window (RANSAC.m:160-166),
increment-of-all-matches-within-radius (the ``jj=size(...)`` non-break at
RANSAC.m:289), promotion strictly after promote_count sightings
(RANSAC.m:261), empty-table ticks seeding only the first candidate
(RANSAC.m:236-241), decay running only on ticks with ≥1 candidate
(RANSAC.m:133-148), and landmark = perpendicular foot from the WORLD ORIGIN
(RANSAC.m:220).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..config import RansacParams
from .angles import atan2d, atand, wrap_to_360
from .observations import ObsBatch
from .scan import Scan, scan_to_world


class LandmarkTable(NamedTuple):
    """Fixed-capacity candidate table (reference struct array
    ``{loc, observe, index, fresh}``, RANSAC.m:238-241)."""

    loc: jnp.ndarray      # f[C,2]  world position (promoted: snapped to latest)
    observe: jnp.ndarray  # i32[C]  sighting count
    index: jnp.ndarray    # i32[C]  0 = unpromoted candidate
    fresh: jnp.ndarray    # i32[C]  remaining lifetime while unpromoted
    used: jnp.ndarray     # bool[C] slot occupied


def init_table(params: RansacParams) -> LandmarkTable:
    C = params.table_capacity
    return LandmarkTable(
        loc=jnp.zeros((C, 2), params.dtype),
        observe=jnp.zeros((C,), jnp.int32),
        index=jnp.zeros((C,), jnp.int32),
        fresh=jnp.zeros((C,), jnp.int32),
        used=jnp.zeros((C,), bool),
    )


# ---------------------------------------------------------------------------
# Line fitting (replaces polyfit/polyval + point-line distance loops,
# RANSAC.m:184-215)
# ---------------------------------------------------------------------------

def fit_line(points: jnp.ndarray, w: jnp.ndarray
             ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Weighted least-squares y = m·x + b over masked points.

    Returns (m, b, ok); ok is False for degenerate (vertical/empty) sets."""
    w = w.astype(points.dtype)
    n = jnp.sum(w)
    n_safe = jnp.maximum(n, 1.0)
    sx = jnp.sum(w * points[:, 0])
    sy = jnp.sum(w * points[:, 1])
    sxx = jnp.sum(w * points[:, 0] * points[:, 0])
    sxy = jnp.sum(w * points[:, 0] * points[:, 1])
    denom = sxx - sx * sx / n_safe
    ok = (n >= 2) & (jnp.abs(denom) > 1e-12)
    denom_safe = jnp.where(ok, denom, 1.0)
    m = (sxy - sx * sy / n_safe) / denom_safe
    b = (sy - m * sx) / n_safe
    return m, b, ok


def point_line_dist(points: jnp.ndarray, m, b) -> jnp.ndarray:
    """Distance of each point to y = m·x + b (the cross-product form the
    reference evaluates per point at RANSAC.m:190-198)."""
    return jnp.abs(m * points[:, 0] - points[:, 1] + b) / jnp.sqrt(m * m + 1.0)


def score_lines(points: jnp.ndarray, valid: jnp.ndarray,
                lines: jnp.ndarray, thresh) -> jnp.ndarray:
    """Inlier counts i32[NH] of the valid points within ``thresh`` of each
    line y = m·x + b (``lines`` [NH,2]) — the per-point, per-line loop of
    RANSAC.m:190-198 as one [NH,B] compare and row sum, which XLA fuses
    into a single reduction."""
    m, b = lines[:, 0:1], lines[:, 1:2]                       # [NH,1]
    x, y = points[None, :, 0], points[None, :, 1]             # [1,B]
    d = jnp.abs(m * x - y + b) / jnp.sqrt(m * m + 1.0)
    inl = (d < thresh) & valid[None, :]
    return jnp.sum(inl, axis=1, dtype=jnp.int32)


def perpendicular_foot(m, b) -> jnp.ndarray:
    """Foot of the perpendicular from the world origin to y = m·x + b —
    closed form for the symbolic solve at RANSAC.m:217-232."""
    d = 1.0 + m * m
    return jnp.stack([-m * b / d, b / d])


def split_on_gap(points: jnp.ndarray, inl: jnp.ndarray, m, b,
                 params: RansacParams):
    """Split a fitted wall at the largest internal gap of its inlier
    chord (config.RansacParams.split_gap): when two near-collinear walls
    from different rooms merge into one fit, the merged chord contains a
    door/room-boundary gap — keep the side with more points and refit,
    so the foot snaps to ONE physical wall (the dropped side stays in
    the pool for its own hypothesis).  Runs twice so a three-way merge
    resolves too.  No-op when params.split_gap == 0."""
    if params.split_gap <= 0:
        return m, b, inl
    B = points.shape[0]
    for _ in range(2):
        # position of each inlier along the line direction (1, m)/|.|
        t = (points[:, 0] + m * points[:, 1]) / jnp.sqrt(1.0 + m * m)
        big = jnp.asarray(jnp.inf, t.dtype)
        ts = jnp.sort(jnp.where(inl, t, big))
        n = jnp.sum(inl)
        gaps = ts[1:] - ts[:-1]
        internal = jnp.arange(B - 1) < n - 1
        gaps = jnp.where(internal, gaps, -jnp.inf)
        gi = jnp.argmax(gaps)
        has_gap = gaps[gi] > params.split_gap
        cut = 0.5 * (ts[gi] + ts[gi + 1])
        left = inl & (t < cut)
        keep = jnp.where(jnp.sum(left) * 2 >= n, left, inl & (t >= cut))
        inl = jnp.where(has_gap, keep, inl)
        m2, b2, ok2 = fit_line(points, inl)
        m = jnp.where(has_gap & ok2, m2, m)
        b = jnp.where(has_gap & ok2, b2, b)
    return m, b, inl


def split_on_kink(points: jnp.ndarray, inl: jnp.ndarray, m, b,
                  params: RansacParams):
    """Split a fitted wall at the KINK between two near-collinear walls
    meeting WITHOUT a gap (config.RansacParams.split_kink_deg): fit the
    left/right halves of the inlier chord; if their angles disagree by
    more than the threshold, cut at the half-lines' intersection, keep
    the side with more points, refit.  Two passes resolve 3-cell chains.
    No-op when params.split_kink_deg == 0."""
    if params.split_kink_deg <= 0:
        return m, b, inl
    thresh = jnp.deg2rad(params.split_kink_deg)
    B = points.shape[0]
    for _ in range(2):
        t = (points[:, 0] + m * points[:, 1]) / jnp.sqrt(1.0 + m * m)
        big = jnp.asarray(jnp.inf, t.dtype)
        ts = jnp.sort(jnp.where(inl, t, big))
        n = jnp.sum(inl)
        med = ts[jnp.clip(n // 2, 0, B - 1)]
        left = inl & (t < med)
        right = inl & (t >= med)
        ml, bl, okl = fit_line(points, left)
        mr, br, okr = fit_line(points, right)
        kink = jnp.abs(jnp.arctan(ml) - jnp.arctan(mr))
        split = okl & okr & (kink > thresh)
        # intersection of the two half-lines along the chord direction
        dm = jnp.where(jnp.abs(ml - mr) < 1e-9, 1.0, ml - mr)
        xi = (br - bl) / dm
        yi = ml * xi + bl
        ti = (xi + m * yi) / jnp.sqrt(1.0 + m * m)
        cut_l = inl & (t < ti)
        cut_r = inl & (t >= ti)
        keep = jnp.where(jnp.sum(cut_l) >= jnp.sum(cut_r), cut_l, cut_r)
        inl = jnp.where(split, keep, inl)
        m2, b2, ok2 = fit_line(points, inl)
        m = jnp.where(split & ok2, m2, m)
        b = jnp.where(split & ok2, b2, b)
    return m, b, inl


def fit_rms(points: jnp.ndarray, inl: jnp.ndarray, m, b) -> jnp.ndarray:
    """RMS perpendicular residual of the masked inliers to y = m·x + b."""
    d = point_line_dist(points, m, b)
    w = inl.astype(points.dtype)
    n = jnp.maximum(jnp.sum(w), 1.0)
    return jnp.sqrt(jnp.sum(w * d * d) / n)


def refine_fit(points: jnp.ndarray, avail: jnp.ndarray, m, b, ok,
               params: RansacParams):
    """``params.refine_passes`` tightened refits of an accepted line:
    each pass keeps only points within refine_frac^p x inlier_dist and
    refits — shedding the neighboring-wall contamination that biases the
    fitted angle (see config.RansacParams.refine_passes).  A pass that
    would degenerate (too few points / vertical) keeps the previous fit.
    """
    thr = params.inlier_dist
    for _ in range(params.refine_passes):
        thr = thr * params.refine_frac
        sel = avail & (point_line_dist(points, m, b) < thr)
        m2, b2, ok2 = fit_line(points, sel)
        m = jnp.where(ok2, m2, m)
        b = jnp.where(ok2, b2, b)
    return m, b, ok


# ---------------------------------------------------------------------------
# Wall search (RANSAC.m:109-128: up to `wall_search_timeout` rounds)
# ---------------------------------------------------------------------------

def _finalize_wall(points, avail, inl, m, b, refit_ok,
                   params: RansacParams):
    """Shared accepted-wall post-processing: gap/kink splits, tightened
    refits, the RMS quality gate, and the fit statistics that
    noise_model='fit' propagates into the measurement covariance.

    Returns (m, b, inl, ok_quality, stats) with stats =
    [sigma_theta^2 (rad^2 of the fitted angle), sigma_c^2 (m^2 offset at
    the chord centroid), t_centroid (m along the line direction)] — the
    OLS fit covariance in chord coordinates: sigma_theta^2 =
    rms^2/(n*var_t), sigma_c^2 = rms^2/n."""
    m, b, inl = split_on_gap(points, inl, m, b, params)
    m, b, inl = split_on_kink(points, inl, m, b, params)
    m, b, _ = refine_fit(points, avail, m, b, refit_ok, params)
    rms = fit_rms(points, inl, m, b)
    ok_q = (rms < params.max_fit_rms) if params.max_fit_rms > 0 else (
        jnp.asarray(True))
    dt = points.dtype
    w = inl.astype(dt)
    n = jnp.maximum(jnp.sum(w), 2.0)
    t = (points[:, 0] + m * points[:, 1]) / jnp.sqrt(1.0 + m * m)
    tbar = jnp.sum(w * t) / n
    vart = jnp.maximum(jnp.sum(w * (t - tbar) ** 2) / n, 1e-6)
    # floor the residual at ~1 cm so a lucky tiny-rms fit cannot claim
    # zero angle uncertainty
    r2 = jnp.maximum(rms, 0.01) ** 2
    stats = jnp.stack([r2 / (n * vart), r2 / n, tbar])
    return m, b, inl, ok_q, stats


def find_walls(points: jnp.ndarray, valid: jnp.ndarray, key: jnp.ndarray,
               params: RansacParams
               ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray,
                          jnp.ndarray]:
    """Extract up to T=wall_search_timeout wall lines from world points.

    Returns (lines [T,2] as (m,b), line_ok [T], remaining_valid mask,
    fit stats [T,3] — see _finalize_wall)."""
    B = points.shape[0]
    T = params.wall_search_timeout
    bearing = (atand(points[:, 1] / jnp.where(points[:, 0] == 0, 1e-12,
                                              points[:, 0]))
               if params.ref_compat else atan2d(points[:, 1], points[:, 0]))
    half_win = params.bearing_window_deg / 2.0

    def round_fn(carry, rkey):
        avail = carry
        k_pick, k_sample = jax.random.split(rkey)
        navail = jnp.sum(avail)
        run = navail > params.line_consensus       # RANSAC.m:114 loop guard

        # -- sample a random available point (datasample, RANSAC.m:157)
        u = jax.random.uniform(k_pick, (B,))
        seed_i = jnp.argmax(jnp.where(avail, u, -1.0))
        cb = bearing[seed_i]

        # -- bearing window around it (RANSAC.m:160-171)
        in_win = avail & (bearing <= cb + half_win) & (bearing >= cb - half_win)
        n_win = jnp.sum(in_win)
        enough = n_win > params.sample_points      # RANSAC.m:176 strict >

        # -- sample_points random window points for the seed fit
        s = jax.random.uniform(k_sample, (B,))
        s = jnp.where(in_win, s, -jnp.inf)
        _, top_idx = lax.top_k(s, params.sample_points)
        sel = jnp.zeros((B,), bool).at[top_idx].set(True) & in_win

        # -- seed line + inliers over ALL remaining points (RANSAC.m:185-198)
        m0, b0, fit_ok = fit_line(points, sel)
        d = point_line_dist(points, m0, b0)
        inl = avail & (d < params.inlier_dist)
        n_inl = jnp.sum(inl)
        wall = (run & enough & fit_ok
                & (n_inl > params.line_consensus))  # RANSAC.m:203 strict >

        # -- refit on the inliers, remove them from the pool (RANSAC.m:206-209)
        m1, b1, refit_ok = fit_line(points, inl)
        wall = wall & refit_ok
        m1, b1, inl, ok_q, stats = _finalize_wall(points, avail, inl,
                                                  m1, b1, refit_ok, params)
        wall = wall & ok_q
        avail = jnp.where(wall, avail & ~inl, avail)
        line = jnp.stack([m1, b1])
        return avail, (line, wall, stats)

    keys = jax.random.split(key, T)
    remaining, (lines, ok, stats) = lax.scan(round_fn, valid, keys)
    return lines, ok, remaining, stats


def find_walls_batched(points: jnp.ndarray, valid: jnp.ndarray,
                       key: jnp.ndarray, params: RansacParams,
                       n_hypotheses: int = 64
                       ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray,
                                  jnp.ndarray]:
    """Batched-hypothesis wall search: NH seed lines scored at once.

    Instead of the reference's one-seed-per-round sequential search
    (RANSAC.m:114-128), sample NH seed points simultaneously, fit NH trial
    lines from their bearing windows, score ALL of them in one fused pass
    (score_lines), then greedily accept up to
    ``wall_search_timeout`` winners whose inlier sets don't overlap.  Same
    output contract as find_walls; more hypotheses → better walls per scan
    AND fewer sequential steps.
    """
    B = points.shape[0]
    T = params.wall_search_timeout
    NH = n_hypotheses
    bearing = (atand(points[:, 1] / jnp.where(points[:, 0] == 0, 1e-12,
                                              points[:, 0]))
               if params.ref_compat else atan2d(points[:, 1], points[:, 0]))
    half_win = params.bearing_window_deg / 2.0

    k_pick, k_sample = jax.random.split(key)
    u = jax.random.uniform(k_pick, (NH, B))
    seed_idx = jnp.argmax(jnp.where(valid[None, :], u, -1.0), axis=1)  # [NH]
    cb = bearing[seed_idx]                                             # [NH]

    in_win = (valid[None, :]
              & (bearing[None, :] <= cb[:, None] + half_win)
              & (bearing[None, :] >= cb[:, None] - half_win))          # [NH,B]
    n_win = jnp.sum(in_win, axis=1)
    enough = n_win > params.sample_points

    s = jax.random.uniform(k_sample, (NH, B))
    s = jnp.where(in_win, s, -jnp.inf)
    _, top_idx = lax.top_k(s, params.sample_points)                    # [NH,S]
    sel = jnp.zeros((NH, B), bool)
    sel = sel.at[jnp.arange(NH)[:, None], top_idx].set(True) & in_win

    m0, b0, fit_ok = jax.vmap(fit_line, in_axes=(None, 0))(points, sel)
    trial = jnp.stack([m0, b0], axis=-1)                               # [NH,2]
    counts = score_lines(points, valid, trial, params.inlier_dist)
    counts = jnp.where(enough & fit_ok, counts, 0)

    # greedy selection of up to T non-overlapping winners
    def pick(carry, _):
        avail, cnts = carry
        best = jnp.argmax(cnts)
        ok = cnts[best] > params.line_consensus
        d = point_line_dist(points, trial[best, 0], trial[best, 1])
        inl = avail & (d < params.inlier_dist)
        m1, b1, refit_ok = fit_line(points, inl)
        ok = ok & refit_ok
        m1, b1, inl, ok_q, stats = _finalize_wall(points, avail, inl,
                                                  m1, b1, refit_ok, params)
        ok = ok & ok_q
        avail = jnp.where(ok, avail & ~inl, avail)
        # re-score remaining hypotheses against the reduced point pool
        cnts = jnp.where(ok, score_lines(points, avail, trial,
                                         params.inlier_dist), cnts)
        cnts = cnts.at[best].set(0)
        return (avail, cnts), (jnp.stack([m1, b1]), ok, stats)

    (remaining, _), (lines, ok, stats) = lax.scan(pick, (valid, counts),
                                                  None, length=T)
    return lines, ok, remaining, stats


def foot_covariance(lines: jnp.ndarray, stats: jnp.ndarray) -> jnp.ndarray:
    """World-frame covariance [T,2,2] of each perpendicular-foot landmark,
    propagated from the line-fit statistics (_finalize_wall).

    Line parametrized by angle θ_l and origin distance ρ: the foot is
    ρ·n̂(θ_l), so δfoot = δρ·n̂ + ρ·δθ_l·t̂.  The offset error at the
    foot extrapolates from the observed chord: σ_ρ² = σ_c² + ℓ²·σ_θ²
    with ℓ the chord-centroid-to-foot distance — the LEVER ARM that
    makes distant-line feet noisy along exactly these axes while a
    constant R cannot say so."""
    m, b = lines[:, 0], lines[:, 1]
    s_th2, s_c2, tbar = stats[:, 0], stats[:, 1], stats[:, 2]
    inv = 1.0 / jnp.sqrt(1.0 + m * m)
    that = jnp.stack([inv, m * inv], -1)                    # line dir [T,2]
    nhat = jnp.stack([-m * inv, inv], -1)                   # normal  [T,2]
    foot = jax.vmap(lambda mm, bb: perpendicular_foot(mm, bb))(m, b)
    rho2 = jnp.sum(foot * foot, -1)
    t_foot = jnp.sum(foot * that, -1)
    ell2 = (tbar - t_foot) ** 2
    s_n2 = s_c2 + ell2 * s_th2                              # across line
    s_t2 = rho2 * s_th2                                     # along line
    return (s_n2[:, None, None] * nhat[:, :, None] * nhat[:, None, :]
            + s_t2[:, None, None] * that[:, :, None] * that[:, None, :])


# ---------------------------------------------------------------------------
# Candidate-table update (RANSAC.m:234-334)
# ---------------------------------------------------------------------------

class _ObsScratch(NamedTuple):
    """Per-table-entry record of this tick's first observation."""
    flag: jnp.ndarray   # bool[C] entry observed (indexed) this tick
    dist: jnp.ndarray   # f[C]
    ang: jnp.ndarray    # f[C]
    loc: jnp.ndarray    # f[C,2] snapped location at record time
    stamp: jnp.ndarray  # i32[C] record order (for output ordering)
    R: jnp.ndarray      # f[C,2,2] propagated (r, phi_deg) covariance


def update_table(table: LandmarkTable, cands: jnp.ndarray,
                 cand_ok: jnp.ndarray, pose: jnp.ndarray,
                 params: RansacParams, max_obs: int,
                 cand_cov: jnp.ndarray = None
                 ) -> Tuple[ObsBatch, LandmarkTable]:
    """Associate candidates to the table; promote / snap / record / decay.

    Vectorized form of getOutputLandmarkListAndObservedLandmarkList
    (RANSAC.m:234-334) processing candidates sequentially (their order
    matters for promotion indices and output ordering) but each candidate's
    table pass in parallel.

    ``cand_cov`` [Tc,2,2]: optional world-frame covariance per candidate
    foot (ops/ransac.foot_covariance); when given, each emitted
    observation row carries its propagated (range, bearing) covariance in
    ``ObsBatch.R`` for EKFParams.noise_model='fit'."""
    C = params.table_capacity
    dt = params.dtype
    # normalize input precision: candidates/pose may arrive f64 (e.g. x64
    # test runs feeding an f32-config table)
    cands = cands.astype(dt)
    pose = pose.astype(dt)
    if cand_cov is not None:
        cand_cov = cand_cov.astype(dt)
    any_cand = jnp.any(cand_ok)
    table_empty = ~jnp.any(table.used)

    def seed_first(tbl: LandmarkTable) -> LandmarkTable:
        # Empty table: seed with the FIRST candidate only (RANSAC.m:236-241;
        # the remaining candidates are dropped this tick — reference quirk).
        first = jnp.argmax(cand_ok)
        return LandmarkTable(
            loc=tbl.loc.at[0].set(cands[first].astype(dt)),
            observe=tbl.observe.at[0].set(1),
            index=tbl.index.at[0].set(0),
            fresh=tbl.fresh.at[0].set(params.freshness),
            used=tbl.used.at[0].set(True),
        )

    def _empty_scratch():
        return _ObsScratch(
            flag=jnp.zeros((C,), bool),
            dist=jnp.zeros((C,), dt),
            ang=jnp.zeros((C,), dt),
            loc=jnp.zeros((C, 2), dt),
            stamp=jnp.full((C,), jnp.iinfo(jnp.int32).max, jnp.int32),
            R=jnp.zeros((C, 2, 2), dt),
        )

    def associate(tbl: LandmarkTable) -> Tuple[LandmarkTable, _ObsScratch]:
        scratch = _empty_scratch()

        def per_cand(carry, ci):
            tbl, scr = carry
            cand = cands[ci]
            ok = cand_ok[ci]
            d = jnp.linalg.norm(tbl.loc - cand[None, :], axis=-1)
            match = tbl.used & (d < params.assoc_dist) & ok
            if params.match_mode == "nearest":
                # one entry per candidate (config.RansacParams.match_mode
                # — the 'all' form emits duplicate observation rows)
                near = jnp.argmin(jnp.where(match, d, jnp.inf))
                match = match & (jnp.arange(C) == near)
            any_match = jnp.any(match)

            # increment every match (the reference's broken break at
            # RANSAC.m:289 means ALL entries within radius increment)
            observe = tbl.observe + match.astype(jnp.int32)

            # promotion: observe > consensus, not yet indexed (RANSAC.m:261);
            # simultaneous promotions get sequential indices in slot order.
            newly = match & (observe > params.promote_count) & (tbl.index == 0)
            max_idx = jnp.max(tbl.index)
            order = jnp.cumsum(newly.astype(jnp.int32))
            index = jnp.where(newly, max_idx + order, tbl.index)

            # indexed matches snap loc to the measurement (RANSAC.m:267-268)
            indexed_match = match & (index != 0)
            loc = jnp.where(indexed_match[:, None], cand[None, :], tbl.loc)

            # record observation rows at first touch (dedupe by entry —
            # the reference dedupes by index, RANSAC.m:279-284)
            delta = cand - pose[:2]
            dist = jnp.linalg.norm(delta)
            ang = wrap_to_360(atan2d(delta[1], delta[0]) - pose[2])
            if cand_cov is None:
                Rrec = jnp.zeros((2, 2), dt)
            else:
                # propagate the world-frame foot covariance into the
                # (range m, bearing deg) measurement frame: dr = δ̂·df,
                # dφ = (180/π)·(δ̂⊥·df)/r
                r_safe = jnp.maximum(dist, 1e-6)
                rhat = delta / r_safe
                phat = (jnp.asarray(180.0 / jnp.pi, dt)
                        * jnp.stack([-rhat[1], rhat[0]]) / r_safe)
                J = jnp.stack([rhat, phat])                    # [2,2]
                Rrec = J @ cand_cov[ci] @ J.T
            first_touch = indexed_match & ~scr.flag
            scr = _ObsScratch(
                flag=scr.flag | indexed_match,
                dist=jnp.where(first_touch, dist.astype(dt), scr.dist),
                ang=jnp.where(first_touch, ang.astype(dt), scr.ang),
                loc=jnp.where(first_touch[:, None], cand[None, :], scr.loc),
                stamp=jnp.where(first_touch,
                                ci * C + jnp.arange(C, dtype=jnp.int32),
                                scr.stamp),
                R=jnp.where(first_touch[:, None, None], Rrec[None],
                            scr.R),
            )

            # unmatched candidate → new entry at first free slot
            # (RANSAC.m:295-302); dropped when the table is full.
            free = ~tbl.used
            slot = jnp.argmax(free)
            add = ok & ~any_match & jnp.any(free)
            tbl = LandmarkTable(
                loc=jnp.where(add, loc.at[slot].set(cand.astype(dt)), loc),
                observe=jnp.where(add, observe.at[slot].set(1), observe),
                index=jnp.where(add, index.at[slot].set(0), index),
                fresh=jnp.where(add,
                                tbl.fresh.at[slot].set(params.freshness),
                                tbl.fresh),
                used=jnp.where(add, tbl.used.at[slot].set(True), tbl.used),
            )
            return (tbl, scr), None

        (tbl, scratch), _ = lax.scan(per_cand, (tbl, scratch),
                                     jnp.arange(cands.shape[0],
                                                dtype=jnp.int32))
        return tbl, scratch

    def no_op(tbl: LandmarkTable):
        return tbl, _empty_scratch()

    table, scratch = lax.cond(
        any_cand & table_empty,
        lambda t: (seed_first(t), no_op(t)[1]),
        lambda t: lax.cond(any_cand, associate, no_op, t),
        table,
    )

    # freshness decay — runs only on ticks with ≥1 candidate (the reference
    # skips the whole table function otherwise, RANSAC.m:133-148), and only
    # for unpromoted entries (RANSAC.m:321-331).
    def decay(tbl: LandmarkTable) -> LandmarkTable:
        dec = tbl.used & (tbl.index == 0)
        fresh = tbl.fresh - dec.astype(jnp.int32)
        dead = dec & (fresh == 0)
        return tbl._replace(fresh=fresh, used=tbl.used & ~dead)

    table = lax.cond(any_cand, decay, lambda t: t, table)

    # -- compact observation rows into the fixed ObsBatch, ordered by stamp
    neg = scratch.flag
    order = jnp.argsort(jnp.where(neg, scratch.stamp,
                                  jnp.iinfo(jnp.int32).max))
    take = order[:max_obs]
    valid_rows = neg[take]
    obs = ObsBatch(
        rng=jnp.where(valid_rows, scratch.dist[take], 0.0).astype(dt),
        bearing=jnp.where(valid_rows, scratch.ang[take], 0.0).astype(dt),
        index=jnp.where(valid_rows, table.index[take], 0),
        loc=jnp.where(valid_rows[:, None], scratch.loc[take], 0.0).astype(dt),
        valid=valid_rows,
        R=(None if cand_cov is None else
           jnp.where(valid_rows[:, None, None], scratch.R[take],
                     0.0).astype(dt)),
    )
    return obs, table


# ---------------------------------------------------------------------------
# Filter-state write-back (RANSAC.m:336-373)
# ---------------------------------------------------------------------------

def writeback(table: LandmarkTable, x: jnp.ndarray, n_active: jnp.ndarray,
              params: RansacParams, sig: jnp.ndarray = None
              ) -> LandmarkTable:
    """Copy filter-estimated landmark positions into the table.

    ``params.writeback_mode``:
    * 'ref' — positional map (table index i ↦ filter slot i-1), with the
      reference quirk that ``for ii=(length(state_vector)-3)/2`` iterates
      a single value so only the LAST state landmark is written back
      (RANSAC.m:355); ``writeback_last_only=False`` writes back all (the
      evident intent).  Valid only while appends happen in promotion
      order — ML association/duplicates/maintenance break it.
    * 'sig' — match table entries to filter slots by SIGNATURE (the
      filter stores the table index as the landmark signature), correct
      under any slot permutation; needs ``sig`` (state.sig).
    * 'off' — no write-back.
    """
    if params.writeback_mode == "off":
        return table
    K = (x.shape[0] - 3) // 2   # floor: x may carry mesh-padding rows
    lm = x[3:3 + 2 * K].reshape(K, 2)
    idx = table.index                      # 1-based state landmark number
    if params.writeback_mode == "sig" and sig is not None:
        slot_active = jnp.arange(sig.shape[0]) < n_active
        eq = (sig[None, :] == idx[:, None].astype(sig.dtype)
              ) & slot_active[None, :]                         # [C,K]
        has = jnp.any(eq, axis=1)
        slot = jnp.argmax(eq, axis=1)
        target = has & table.used & (idx > 0) & (n_active > 0)
        src = lm[jnp.clip(slot, 0, K - 1)]
        return table._replace(loc=jnp.where(
            target[:, None], src.astype(table.loc.dtype), table.loc))
    if params.writeback_last_only:
        target = idx == n_active
    else:
        target = (idx >= 1) & (idx <= n_active)
    target = target & table.used & (n_active > 0)
    src = lm[jnp.clip(idx - 1, 0, K - 1)]
    return table._replace(
        loc=jnp.where(target[:, None], src.astype(table.loc.dtype), table.loc))


# ---------------------------------------------------------------------------
# Full extraction tick (RANSAC.getLandmark, RANSAC.m:14-152)
# ---------------------------------------------------------------------------

def extract(table: LandmarkTable, scan: Scan, x: jnp.ndarray,
            n_active: jnp.ndarray, key: jnp.ndarray, params: RansacParams,
            max_obs: int, sig: jnp.ndarray = None
            ) -> Tuple[ObsBatch, LandmarkTable]:
    """One extraction tick: write-back → world points → wall search →
    perpendicular-foot landmarks → table update.  ``sig`` (state.sig) is
    only needed for writeback_mode='sig'."""
    table = writeback(table, x, n_active, params, sig=sig)
    pose = x[:3]
    pts = scan_to_world(scan, pose)
    if params.n_hypotheses > 0:
        lines, line_ok, _, stats = find_walls_batched(
            pts, scan.valid, key, params, params.n_hypotheses)
    else:
        lines, line_ok, _, stats = find_walls(pts, scan.valid, key, params)
    feet = jax.vmap(lambda l: perpendicular_foot(l[0], l[1]))(lines)
    return update_table(table, feet, line_ok, pose, params, max_obs,
                        cand_cov=foot_covariance(lines, stats))
