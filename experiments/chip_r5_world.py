"""Building-scale campaign: large-world end-to-end SLAM on the card.

Runs the FULL pipeline (RANSAC extraction with gap/kink splits +
fit-propagated noise, ML gating, the tuned rows+bf16+syrk batched update,
maintenance) in a real session over a 16x16-room floorplan (~2k wall
segments) until thousands of landmarks are genuinely mapped, and records
ATE / NIS / map-accuracy / ticks-per-second, plus the extractor's cost per
tick at campaign table capacity.

Run on the card:  python -m experiments.chip_r5_world
Env:  R5W_ROOMS (16), R5W_TICKS (route length), R5W_CAP (2560),
      R5W_REPS (3 timing reps of a 512-tick window).
Writes experiments/results/r5_world.json.
"""
import json
import os
import runpy
import time

import jax
import jax.numpy as jnp
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
RESULTS = os.path.join(HERE, "results")

_ex = runpy.run_path(os.path.join(ROOT, "examples", "large_world_slam.py"))
campaign_params = _ex["campaign_params"]

ROOMS = int(os.environ.get("R5W_ROOMS", "16"))
CAP = int(os.environ.get("R5W_CAP", "2560"))
REPS = int(os.environ.get("R5W_REPS", "3"))


def main():
    from ekf_slam_tpu.config import SimConfig
    from ekf_slam_tpu.session import SlamSession
    from ekf_slam_tpu.sim import world as W
    from ekf_slam_tpu.utils.runtime import device_report, enable_compile_cache
    from ekf_slam_tpu.utils.schedule import tuned_params

    enable_compile_cache()
    t_all = time.time()
    dt = jnp.float32
    control = os.environ.get("R5W_CTRL", "icp")
    world = W.floorplan_world(ROOMS, ROOMS, seed=0)
    gt = W.cluster_feet(W.true_feet(world), 0.5)
    wp = W.serpentine_waypoints(ROOMS, ROOMS)
    ctrl, start = W.waypoint_controls(wp, step=float(os.environ.get('R5W_STEP', '0.25')))
    T = int(os.environ.get("R5W_TICKS", str(ctrl.shape[0])))
    ctrl = ctrl[:T]
    print(f"[r5w] world: {world.segments.shape[0]} segments, "
          f"{len(gt)} effective GT landmarks; route {T} ticks",
          flush=True)

    cfg = SimConfig(n_beams=1024, max_range=10.0, range_noise_std=0.01,
                    odom_xy_noise_std=0.004, odom_theta_noise_std=0.5,
                    dtype=dt)
    t0 = time.time()
    traj = W.simulate(world, jnp.asarray(ctrl, dt), cfg,
                      jax.random.PRNGKey(0), start_pose=tuple(start))
    jax.block_until_ready(traj.ranges)
    print(f"[r5w] sim generated in {time.time()-t0:.1f}s", flush=True)

    ekf, ransac = campaign_params(CAP, dt, control, 0.5)
    # the tuned large-map schedule: rows-mode P·Hᵀ, bf16 P storage, the
    # symmetric correction (utils/schedule.py)
    ekf = tuned_params(ekf, batch=ekf.max_obs)
    sess = SlamSession(ekf_params=ekf, ransac_params=ransac, seed=1,
                       control_source=control, collect_nis=True,
                       icp_max_pair_dist=0.4, icp_min_inliers=200,
                       icp_max_rmse=0.08,
                       maintain_merge_radius=float(
                           os.environ.get('R5W_MERGE', '0.0')),
                       maintain_max_trace=float(
                           os.environ.get('R5W_MAXTR', '0.0')))
    carry = sess.init_carry(
        first_odom=traj.odom[0], init_pose=start,
        n_beams=1024 if control in ("icp", "fused") else None)

    # -- full mapping run (one fused scan), then timing reps on a window
    t0 = time.time()
    fcarry, outs = sess.run(traj.odom, traj.ranges, traj.beam_angles,
                            carry=carry)
    jax.block_until_ready(outs.pose[-1])
    t_run = time.time() - t0
    print(f"[r5w] full {T}-tick mapping run: {t_run:.1f}s "
          f"({T/t_run:.1f} ticks/s incl. compile)", flush=True)

    # timed windows (compiled): medians of REPS over a 512-tick replay
    WIN = min(512, T)
    odom_w = traj.odom[:WIN]
    rng_w = traj.ranges[:WIN]
    ts = []
    for _ in range(REPS + 1):
        t0 = time.time()
        c2, o2 = sess.run(odom_w, rng_w, traj.beam_angles)
        jax.block_until_ready(o2.pose[-1])
        ts.append(time.time() - t0)
    ts = np.asarray(ts[1:])
    tps = WIN / float(np.median(ts))
    spread = float(100 * (ts.max() - ts.min()) / np.median(ts))
    print(f"[r5w] session ticks/s (cap {CAP}, tuned schedule): "
          f"{tps:.1f} (median of {REPS}, spread {spread:.1f}%)",
          flush=True)

    # -- extractor-at-scale cost: extraction-only scan
    from ekf_slam_tpu.ops.ransac import extract, init_table
    from ekf_slam_tpu.ops.scan import scan_from_ranges

    def extract_scan(table, key, ranges, poses):
        def body(c, inp):
            tbl, k = c
            r, p = inp
            k, sub = jax.random.split(k)
            scan = scan_from_ranges(r, traj.beam_angles)
            x = jnp.zeros((5,), dt).at[:3].set(p)
            obs, tbl = extract(tbl, scan, x, jnp.asarray(0, jnp.int32),
                               sub, ransac, ekf.max_obs)
            return (tbl, k), obs.valid.sum()
        return jax.lax.scan(body, (table, key), (ranges, poses))

    ex_jit = jax.jit(extract_scan)
    tbl0 = init_table(ransac)
    key0 = jax.random.PRNGKey(9)
    jax.block_until_ready(ex_jit(tbl0, key0, rng_w, traj.truth[:WIN])[1])
    ts_e = []
    for _ in range(REPS):
        t0 = time.time()
        jax.block_until_ready(ex_jit(tbl0, key0, rng_w, traj.truth[:WIN])[1])
        ts_e.append(time.time() - t0)
    ex_ms = float(np.median(ts_e)) / WIN * 1e3
    print(f"[r5w] extractor-only cost at table_capacity="
          f"{ransac.table_capacity}, NH={ransac.n_hypotheses}: "
          f"{ex_ms:.3f} ms/tick", flush=True)

    # -- campaign metrics
    est = np.asarray(outs.pose, np.float64)
    truth = np.asarray(traj.truth, np.float64)
    K = int(fcarry.filt.n_active)
    lm = np.asarray(fcarry.filt.x, np.float64)[3:3 + 2 * K].reshape(K, 2)
    nis = np.asarray(outs.nis, np.float64)
    fin = np.isfinite(nis)
    Rg, tg = W.align_se2(est[:, :2], truth[:, :2])
    est_al = est[:, :2] @ Rg.T + tg
    rec = {
        "rooms": ROOMS, "segments": int(world.segments.shape[0]),
        "n_gt": int(len(gt)), "ticks": T, "capacity": CAP,
        "control": control,
        "schedule": {"pht_mode": ekf.pht_mode,
                     "cov_dtype": str(ekf.cov_dt),
                     "correction": ekf.correction},
        "ate_slam": float(W.ate_rmse(jnp.asarray(est[:, :2]),
                                     traj.truth[:, :2])),
        "ate_slam_aligned": float(np.sqrt(np.mean(
            np.sum((est_al - truth[:, :2]) ** 2, -1)))),
        "ate_odom": float(W.ate_rmse(traj.odom[:, :2],
                                     traj.truth[:, :2])),
        "landmarks": K,
        "map": W.map_accuracy(lm, gt, tol=0.6),
        "map_aligned": W.map_accuracy(lm @ Rg.T + tg, gt, tol=0.6),
        "nis_mean": float(nis[fin].mean()),
        "nis_median": float(np.median(nis[fin])),
        "n_gated_obs": int(fin.sum()),
        "ticks_per_sec": round(tps, 1),
        "ticks_per_sec_spread_pct": round(spread, 1),
        "extractor_ms_per_tick": round(ex_ms, 3),
        "full_run_seconds": round(t_run, 1),
        "n_active_trace": np.asarray(outs.n_active)[::max(1, T // 32)].astype(int).tolist(),
        "device": device_report(),
    }
    # -- submap + pose-graph pipeline (the scale answer: the monolithic
    # joint filter accumulates gauge drift over ~10k ticks, submap-local
    # frames also shrink the foot lever arms; loop closures re-align)
    if os.environ.get("R5W_SUBMAPS", "1") == "1":
        import dataclasses

        from ekf_slam_tpu.parallel.submaps import SubmapSlam

        ekf_s, ransac_s = campaign_params(192, dt, control, 0.5)
        ransac_s = dataclasses.replace(ransac_s, table_capacity=512)
        sm = SubmapSlam(
            ekf_params=ekf_s, ransac_params=ransac_s, seed=1,
            ticks_per_submap=int(os.environ.get("R5W_TPS", "400")),
            kf_every=40,
            session_kwargs=dict(
                control_source=control, icp_max_pair_dist=0.4,
                icp_min_inliers=200, icp_max_rmse=0.08,
                maintain_merge_radius=0.4),
            start_pose=start)
        t0 = time.time()
        poses_pre = sm.run(np.asarray(traj.odom), np.asarray(traj.ranges),
                           traj.beam_angles)
        t_sub = time.time() - t0
        print(f"[r5w] submap run: {t_sub:.1f}s, {len(sm.submaps)} "
              f"submaps", flush=True)
        t0 = time.time()
        n_lc = sm.detect_loop_closures_traj(
            np.asarray(traj.ranges), traj.beam_angles, radius=10.0,
            min_separation=1, icp_max_rmse=0.16, icp_min_inliers=120,
            max_per_pair=2, max_corr_xy=3.0, max_corr_deg=5.0)
        opt_ok = sm.optimize(iters=30)
        poses_post = sm.global_poses()
        print(f"[r5w] {n_lc} loop closures + optimize (ok={opt_ok}): "
              f"{time.time()-t0:.1f}s", flush=True)
        lmg = sm.global_landmarks()
        lm_c = W.cluster_feet(lmg, 0.5) if len(lmg) else lmg
        ate_pre = float(np.sqrt(np.mean(np.sum(
            (poses_pre[:, :2] - truth[:, :2]) ** 2, -1))))
        ate_post = float(np.sqrt(np.mean(np.sum(
            (poses_post[:, :2] - truth[:, :2]) ** 2, -1))))
        rec["submaps"] = {
            "n_submaps": len(sm.submaps),
            "ticks_per_submap": sm.ticks_per_submap,
            "loop_closures": n_lc,
            "optimize_ok": bool(opt_ok),
            "ate_pre": round(ate_pre, 3),
            "ate_post": round(ate_post, 3),
            "landmarks": int(len(lmg)),
            "landmarks_clustered": int(len(lm_c)),
            # frame-agnostic metric: submap feet live on the right wall
            # LINES but not at the world-origin feet (sim.world
            # .map_accuracy_lines)
            "map_lines": W.map_accuracy_lines(lm_c, world, tol=0.5),
            "run_seconds": round(t_sub, 1),
        }
        # the monolithic map scored the same way, for comparison
        rec["map_lines_monolithic"] = W.map_accuracy_lines(
            lm, world, tol=0.5)

    os.makedirs(RESULTS, exist_ok=True)
    rec["merge_radius"] = float(os.environ.get("R5W_MERGE", "0.0"))
    tag = os.environ.get("R5W_TAG", "")
    with open(os.path.join(RESULTS, f"r5_world{tag}.json"), "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    print("[r5w] " + json.dumps(rec), flush=True)
    print(f"[r5w] total {time.time()-t_all:.1f}s", flush=True)


if __name__ == "__main__":
    main()
