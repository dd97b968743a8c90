"""Large-world campaign: generator, extractor-at-scale, end-to-end CI run.

Scaled-down CI versions of the building-scale campaign
(experiments/chip_r5_world.py, chip_smoke.py's pipeline phase): the
reference's only demonstrated scale is one 4x3 m room (test_SLAM.m), so
the multi-room floorplan + full-pipeline run is capability the engine
adds — these tests pin that it actually maps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ekf_slam_tpu.config import RansacParams, SimConfig
from ekf_slam_tpu.sim import world as W

jnp_dt = jnp.float64


# ---------------------------------------------------------------------------
# World generator
# ---------------------------------------------------------------------------

def test_floorplan_world_structure():
    w = W.floorplan_world(3, 2, seed=0, room=8.0)
    segs = np.asarray(w.segments)
    # horizontal: 2 boundary rows x 3 + 1 interior row x 3 cells x 2
    # (door split) = 12; vertical: 2 x 2 + 2 x 2 x 2 = 12; boxes 6 x 4
    assert segs.shape == (48, 4)
    # every segment has nonzero length
    L = np.hypot(segs[:, 2] - segs[:, 0], segs[:, 3] - segs[:, 1])
    assert (L > 0.5).all()
    # jitter makes wall lines distinct: effective GT well above the
    # collinear-collapsed count (unjittered: all grid rows share lines)
    feet = W.true_feet(w)
    reps = W.cluster_feet(feet, 0.5)
    assert len(reps) >= 0.55 * len(feet)
    # base rotation keeps every wall away from vertical (y=mx+b fit)
    ang = np.degrees(np.arctan2(segs[:, 3] - segs[:, 1],
                                segs[:, 2] - segs[:, 0]))
    assert (np.abs(np.abs((ang + 90) % 180) - 90) > 10).all()


def test_coverage_route_traverses_doors():
    w = W.floorplan_world(3, 2, seed=0, room=8.0)
    wp = W.serpentine_waypoints(3, 2, 8.0)
    ctrl, start = W.waypoint_controls(wp, step=0.25)
    cfg = SimConfig(n_beams=256, max_range=10.0, range_noise_std=0.0,
                    odom_xy_noise_std=0.0, odom_theta_noise_std=0.0,
                    dtype=jnp_dt)
    traj = W.simulate(w, jnp.asarray(ctrl, jnp_dt), cfg,
                      jax.random.PRNGKey(0), start_pose=tuple(start))
    truth = np.asarray(traj.truth)
    # reaches the last waypoint
    assert np.hypot(*(truth[-1, :2] - wp[-1])) < 1.0
    # never crosses a wall (the route uses the doors)
    segs = np.asarray(w.segments)
    a, e = segs[:, :2], segs[:, 2:] - segs[:, :2]
    p = truth[:, :2]
    t = np.clip(((p[:, None] - a[None]) * e[None]).sum(-1)
                / (e * e).sum(-1)[None], 0, 1)
    proj = a[None] + t[..., None] * e[None]
    d = np.hypot(p[:, None, 0] - proj[..., 0],
                 p[:, None, 1] - proj[..., 1]).min(1)
    assert d.min() > 0.05


def test_map_accuracy_matching():
    gt = np.array([[0.0, 0.0], [5.0, 0.0], [0.0, 5.0]])
    est = np.array([[0.1, 0.0], [5.0, 0.2], [9.0, 9.0]])
    acc = W.map_accuracy(est, gt, tol=0.5)
    assert acc["n_matched"] == 2 and acc["n_spurious"] == 1
    assert 0.05 < acc["mean_err"] < 0.3


# ---------------------------------------------------------------------------
# Extractor options (split/refine/rms/match-mode)
# ---------------------------------------------------------------------------

def _chord(m, b, t0, t1, n, key, noise=0.01):
    x = np.linspace(t0, t1, n)
    y = m * x + b
    rng = np.random.default_rng(key)
    return np.stack([x, y + rng.normal(0, noise, n)], -1)


def test_split_on_gap_keeps_one_side():
    from ekf_slam_tpu.ops.ransac import fit_line, split_on_gap
    p = RansacParams(split_gap=1.0, dtype=jnp_dt)
    # two near-collinear chords with a 3 m gap; joint fit is between them
    pts = np.concatenate([_chord(1.0, 0.0, 0.0, 4.0, 120, 1),
                          _chord(1.08, -0.5, 7.0, 10.0, 60, 2)])
    pts = jnp.asarray(pts)
    inl = jnp.ones((pts.shape[0],), bool)
    m0, b0, _ = fit_line(pts, inl)
    m1, b1, inl1 = split_on_gap(pts, inl, m0, b0, p)
    # the larger (left) side survives and the fit snaps to its line
    assert int(jnp.sum(inl1)) == 120
    assert abs(float(m1) - 1.0) < 0.02 and abs(float(b1)) < 0.05


def test_split_on_kink_cuts_at_intersection():
    from ekf_slam_tpu.ops.ransac import fit_line, split_on_kink
    p = RansacParams(split_kink_deg=3.0, dtype=jnp_dt)
    # two walls meeting at x=5 with a 8 deg kink, NO gap
    pts = np.concatenate([_chord(1.0, 0.0, 0.0, 5.0, 150, 3),
                          _chord(1.15, -0.75, 5.0, 9.0, 100, 4)])
    pts = jnp.asarray(pts)
    inl = jnp.ones((pts.shape[0],), bool)
    m0, b0, _ = fit_line(pts, inl)
    m1, b1, inl1 = split_on_kink(pts, inl, m0, b0, p)
    assert int(jnp.sum(inl1)) <= 160          # one side kept
    assert abs(float(m1) - 1.0) < 0.03        # snapped to the bigger wall


def test_fit_rms_flags_contaminated_fits():
    from ekf_slam_tpu.ops.ransac import fit_line, fit_rms
    clean = jnp.asarray(_chord(1.0, 0.0, 0.0, 6.0, 200, 5, noise=0.01))
    mixed = jnp.asarray(np.concatenate(
        [_chord(1.0, 0.0, 0.0, 6.0, 200, 5, noise=0.01),
         _chord(1.15, -0.75, 5.0, 9.0, 80, 6, noise=0.01)]))
    inl_c = jnp.ones((clean.shape[0],), bool)
    inl_m = jnp.ones((mixed.shape[0],), bool)
    mc, bc, _ = fit_line(clean, inl_c)
    mm, bm, _ = fit_line(mixed, inl_m)
    assert float(fit_rms(clean, inl_c, mc, bc)) < 0.02
    assert float(fit_rms(mixed, inl_m, mm, bm)) > 0.04


def test_match_mode_nearest_single_observation_row():
    """Duplicate promoted entries within assoc_dist: 'all' emits one obs
    row per entry for ONE measured foot (reference quirk, RANSAC.m:289);
    'nearest' emits exactly one."""
    import dataclasses

    from ekf_slam_tpu.ops.ransac import LandmarkTable, update_table

    def table_with_dupes(params):
        C = params.table_capacity
        loc = np.zeros((C, 2))
        loc[0] = [2.0, 2.0]
        loc[1] = [2.2, 2.0]
        loc[2] = [2.0, 2.3]
        t = LandmarkTable(
            loc=jnp.asarray(loc, params.dtype),
            observe=jnp.zeros((C,), jnp.int32).at[:3].set(20),
            index=jnp.zeros((C,), jnp.int32).at[:3].set(
                jnp.asarray([1, 2, 3], jnp.int32)),
            fresh=jnp.zeros((C,), jnp.int32).at[:3].set(50),
            used=jnp.zeros((C,), bool).at[:3].set(True),
        )
        return t

    pose = jnp.zeros((3,), jnp_dt)
    cands = jnp.asarray([[2.05, 2.05]], jnp_dt)
    ok = jnp.ones((1,), bool)

    p_all = RansacParams(table_capacity=8, assoc_dist=0.5,
                         match_mode="all", dtype=jnp_dt)
    obs, _ = update_table(table_with_dupes(p_all), cands, ok, pose,
                          p_all, max_obs=4)
    assert int(jnp.sum(obs.valid)) == 3       # one row per matched entry

    p_near = dataclasses.replace(p_all, match_mode="nearest")
    obs, _ = update_table(table_with_dupes(p_near), cands, ok, pose,
                          p_near, max_obs=4)
    assert int(jnp.sum(obs.valid)) == 1


def test_writeback_sig_mode_survives_slot_permutation():
    """'ref' maps table index i -> slot i-1 (breaks under permutation);
    'sig' matches by signature and stays correct."""
    import dataclasses

    from ekf_slam_tpu.ops.ransac import LandmarkTable, writeback

    C = 4
    table = LandmarkTable(
        loc=jnp.zeros((C, 2), jnp_dt),
        observe=jnp.full((C,), 20, jnp.int32),
        index=jnp.asarray([2, 1, 0, 0], jnp.int32),   # entries for idx 2,1
        fresh=jnp.full((C,), 50, jnp.int32),
        used=jnp.asarray([True, True, False, False]),
    )
    # filter state: slot 0 carries sig 2, slot 1 carries sig 1 (appended
    # out of promotion order)
    x = jnp.asarray([0, 0, 0, 10.0, 11.0, 20.0, 21.0], jnp_dt)
    sig = jnp.asarray([2.0, 1.0], jnp_dt)
    n_active = jnp.asarray(2, jnp.int32)

    p_sig = RansacParams(writeback_mode="sig", writeback_last_only=False,
                         dtype=jnp_dt)
    t2 = writeback(table, x, n_active, p_sig, sig=sig)
    np.testing.assert_allclose(np.asarray(t2.loc[0]), [10.0, 11.0])
    np.testing.assert_allclose(np.asarray(t2.loc[1]), [20.0, 21.0])

    p_ref = dataclasses.replace(p_sig, writeback_mode="ref")
    t3 = writeback(table, x, n_active, p_ref, sig=sig)
    # positional map writes the WRONG landmarks under this permutation
    np.testing.assert_allclose(np.asarray(t3.loc[0]), [20.0, 21.0])


# ---------------------------------------------------------------------------
# End-to-end CI campaign (scaled-down chip run)
# ---------------------------------------------------------------------------

def test_large_world_campaign_ci():
    import runpy
    import os
    import sys
    mod = runpy.run_path(os.path.join(os.path.dirname(__file__), "..",
                                      "examples", "large_world_slam.py"))
    m, carry, _ = mod["run_campaign"](
        rooms=3, ticks=500, capacity=256, control="odometry", seed=0,
        n_beams=1024, odo_theta_std=0.3, dtype=jnp.float32)
    # reference CPU-f32 run (calibration, this config): ate 0.86 /
    # aligned 0.32 vs odom 0.41; 42/54 matched, 7 spurious, err 0.34,
    # NIS mean 1.35 — thresholds leave headroom for backend jitter
    acc = m["map_aligned"]
    # the pipeline genuinely maps the world ...
    assert acc["n_matched"] >= 0.55 * acc["n_gt"], m
    # ... without drowning it in duplicates ...
    assert acc["n_spurious"] <= acc["n_matched"], m
    assert acc["mean_err"] < 0.45, m
    # ... and the pose stays bounded (no divergence)
    assert m["ate_slam"] < 1.5, m
    assert m["ate_slam_aligned"] < 0.8, m
    # consistency: gated NIS in the chi^2(2) ballpark, not exploding
    assert m["nis_mean"] < 6.0, m
    assert m["nis_mean"] > 0.0, m           # f32 gate stays PSD-stable
