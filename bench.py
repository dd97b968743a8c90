"""Benchmark: EKF measurement-update throughput per device — full metric set.

One invocation (run with NO env vars) measures every BASELINE.json
headline and prints ONE JSON line whose primary metric is the north star
— updates/sec at 10k landmarks — with the rest of the set in ``extra``:

  * ``ekf_updates_per_sec_chip_10000_landmarks`` (primary): ML gate over
    all K landmarks (Correspondence.m:49-87 equivalent) + joint Kalman
    update of the (3+2K)-dim covariance (EKF_SLAM_UC.m:125-146
    equivalent) at the schedule of utils/schedule.recommended_schedule
    (M=4096, chunk-512, rows-mode P·Hᵀ, bf16 P storage, syrk correction);
  * ``updates_per_sec_1k``: same at 1k landmarks (the solve-bound
    regime: dense P·Hᵀ, chunk-256);
  * ``frames_per_sec``: full session pipeline (odometry → predict →
    RANSAC → gate → update), 1024-beam scans, fused lax.scan;
  * ``stream_ticks_per_sec``: the reference's actual operating mode — a
    live per-tick feed (test_SLAM.m:16-18) through the micro-batched
    async streaming driver (io/stream.py), reusing the frames run's
    session;
  * ``vs_baseline``: updates/sec over the NumPy oracle's — the oracle
    performs the reference's dense per-landmark-loop algebra with
    optimized BLAS (generous to the reference: interpreted MATLAB is
    slower; the reference itself publishes no numbers, SURVEY.md §6).
    Measured directly at 1k; at 10k the baseline is the MEASURED oracle
    artifact experiments/results/oracle_10k.json (one real update takes
    ~2e13 FLOPs ≈ tens of minutes on a host CPU — measured once offline
    by experiments/oracle_10k.py), with the asymptotic extrapolation
    from 1k printed to stderr as a cross-check (and used as fallback if
    the artifact is absent).

Every timed quantity iterates inside one jitted lax.scan with
data-dependent loop bodies (so XLA cannot fold the work away), ends in
``jax.block_until_ready``, and is the MEDIAN of ``BENCH_REPS`` (default
5) in-invocation repetitions with the spread (max−min)/median reported
alongside in ``extra``.  At 10k a same-invocation gemm-vs-syrk A/B runs
on the same state.  ``extra`` names the device (platform, kind, count).

Env overrides: BENCH_K=1000|10000 restricts to one config; BENCH_BATCH /
BENCH_CHUNKS / BENCH_COV_DTYPE=bf16|f32 / BENCH_CORR=gemm|syrk tune it
(default: utils/schedule.py, bf16 P at 10k); BENCH_FRAMES=0 /
BENCH_STREAM=0 / BENCH_SEQ=1 toggle the frames, streaming and sequential
runs; BENCH_REPS=N sets the rep count; BENCH_AB=0 skips the 10k
correction A/B; BENCH_SR=0 skips the 10k square-root rows (srekf_fast +
strict-triangular panel).
"""
from __future__ import annotations

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from ekf_slam_tpu.config import EKFParams
from ekf_slam_tpu.models import batched, ekf
from ekf_slam_tpu.ops.association import gate
from ekf_slam_tpu.oracle.np_ekf import NumpyEKFSLAM
from ekf_slam_tpu.state import FilterState, init_state

ONLY_K = int(os.environ["BENCH_K"]) if "BENCH_K" in os.environ else None
N_SEQ = 256       # sequential updates per timed run (amortizes the floor)
N_ORACLE = 5      # oracle updates to time (median taken; seconds each)
N_REPS = int(os.environ.get("BENCH_REPS", "5"))  # timed reps per metric
ORACLE_10K_ARTIFACT = os.path.join(os.path.dirname(__file__),
                                   "experiments", "results",
                                   "oracle_10k.json")


def _defaults(K: int):
    """(batch, chunks, n_batches, pht_mode, cov_dtype, correction) per
    landmark count — the schedule of ekf_slam_tpu/utils/schedule.py.
    Long scans at 1k amortize the per-program dispatch; short at 10k,
    where each batch is already a large amount of work."""
    from ekf_slam_tpu.utils.schedule import recommended_schedule
    s = recommended_schedule(K)
    n_batches = 256 if K <= 2000 else 8
    batch = int(os.environ.get("BENCH_BATCH", s["batch"]))
    chunks = int(os.environ.get("BENCH_CHUNKS", s["update_chunks"]))
    pht = os.environ.get("BENCH_PHT", s["pht_mode"])
    env_cd = os.environ.get("BENCH_COV_DTYPE")
    if env_cd not in (None, "bf16", "f32", "none"):
        raise SystemExit(f"BENCH_COV_DTYPE={env_cd!r}: use bf16|f32")
    cov = (jnp.bfloat16 if env_cd == "bf16"
           else None if env_cd in ("f32", "none")
           else s["cov_dtype"])
    # mirror utils/schedule.tuned_params: an f32 cov override also
    # reverts the correction unless BENCH_CORR pins it explicitly
    default_corr = (s["correction"] if cov == jnp.bfloat16 else "gemm")
    corr = os.environ.get("BENCH_CORR", default_corr)
    if corr not in ("gemm", "syrk"):
        raise SystemExit(f"BENCH_CORR={corr!r}: use gemm|syrk")
    return batch, chunks, n_batches, pht, cov, corr


def make_full_state(params: EKFParams, K: int, seed=0) -> FilterState:
    """State with all K slots active and a well-conditioned dense P.

    Built on-device (P is 1.6 GB at 10k landmarks — too big to stage as a
    host f64 array)."""
    rng = np.random.default_rng(seed)
    st = init_state(params)
    D = st.dim
    lm = rng.uniform(-40, 40, (K, 2))
    x = np.zeros(D, np.float64)
    x[3:3 + 2 * K] = lm.reshape(-1)

    @jax.jit
    def build_P(key):
        A = jax.random.normal(key, (D, 8), params.dtype) / jnp.sqrt(
            jnp.asarray(D, params.dtype))
        return (0.05 * jnp.eye(D, dtype=params.dtype)
                + 0.02 * (A @ A.T)).astype(params.cov_dt)

    return FilterState(
        x=jnp.asarray(x, params.dtype),
        P=build_P(jax.random.PRNGKey(seed)),
        sig=jnp.arange(1, K + 1, dtype=params.dtype),
        active=jnp.ones((K,), bool),
        n_active=jnp.asarray(K, jnp.int32),
    )


def make_measurements(state: FilterState, K: int, n: int, seed=1):
    """n observations, each the exact predicted measurement of a random
    landmark (so the ML gate associates and the update path runs)."""
    rng = np.random.default_rng(seed)
    x = np.asarray(state.x, np.float64)
    idx = rng.integers(0, K, n)
    lm = x[3:3 + 2 * K].reshape(K, 2)[idx]
    delta = lm - x[:2]
    r = np.hypot(delta[:, 0], delta[:, 1])
    b = np.mod(np.rad2deg(np.arctan2(delta[:, 1], delta[:, 0])) - x[2], 360.0)
    return np.stack([r, b, (idx + 1).astype(np.float64)], axis=-1)


def _time_reps(run, *args, n=None):
    """Timed repetitions after a compile/warm pass: returns the per-rep
    seconds as an array (each rep ends in block_until_ready)."""
    n = N_REPS if n is None else n
    jax.block_until_ready(run(*args))     # compile + warm
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(run(*args))
        ts.append(time.perf_counter() - t0)
    return np.asarray(ts)


def _time(run, *args):
    """Median of N_REPS timed repetitions (see _time_reps)."""
    return float(np.median(_time_reps(run, *args)))


def _spread_pct(ts) -> float:
    """(max−min)/median of per-rep times, in percent — the error bar
    every headline claim must exceed."""
    return float(100.0 * (ts.max() - ts.min()) / np.median(ts))


def _params(K: int, chunks: int, cov_dtype=None) -> EKFParams:
    return EKFParams(capacity=K, association="ml", s_cost=1e6,
                     s_thresh=1e12, ref_compat=False, dtype=jnp.float32,
                     cov_dtype=cov_dtype, update_chunks=chunks)


def sequential_updates_per_sec(K: int) -> float:
    params = _params(K, 1)
    state = make_full_state(params, K)
    zs = jnp.asarray(make_measurements(state, K, N_SEQ), params.dtype)
    rc0, rc1 = params.rc

    def one_update(st, z):
        R2 = jnp.diag(jnp.stack([z[0] * rc0, z[1] * rc1])).astype(
            params.dtype)
        is_new, slot, _ = gate(st, z, R2, params)
        return ekf.update(st, z, slot, R2, params), None

    run = jax.jit(lambda st, zs: jax.lax.scan(one_update, st, zs)[0])
    return N_SEQ / _time(run, state, zs)


def _batched_chain(params, state, zs_all):
    """The jitted gate→update chain over all batches (one scan program)."""
    rc0, rc1 = params.rc
    from ekf_slam_tpu.ops.association import gate_batch

    def one_batch(st, zs):
        Rs = jax.vmap(lambda z: jnp.diag(
            jnp.stack([z[0] * rc0, z[1] * rc1])))(zs).astype(params.dtype)
        is_new, slots = gate_batch(st, zs, Rs, params)
        valid = ~is_new
        return batched.update_chunked(st, zs, slots, Rs, valid,
                                      params), None

    return jax.jit(lambda st, zb: jax.lax.scan(one_batch, st, zb)[0])


def batched_updates_per_sec(K: int):
    """Measured-schedule throughput at K landmarks: (updates/s median,
    spread%, A/B dict or None).

    At 10k with correction='syrk', a same-invocation gemm-vs-syrk A/B
    runs on the SAME state and measurements (BENCH_AB=0 skips)."""
    import dataclasses
    batch, chunks, n_batches, pht, cov, corr = _defaults(K)
    params = dataclasses.replace(_params(K, chunks, cov), pht_mode=pht,
                                 correction=corr)
    state = make_full_state(params, K)
    zs_all = jnp.asarray(
        make_measurements(state, K, n_batches * batch).reshape(
            n_batches, batch, 3), params.dtype)

    n_upd = n_batches * batch
    cd = "bf16" if cov == jnp.bfloat16 else "f32"

    ts = _time_reps(_batched_chain(params, state, zs_all), state, zs_all)
    ups = n_upd / float(np.median(ts))
    spread = _spread_pct(ts)
    print(f"[bench] batched (M={batch}, G={chunks}, pht={pht}, P={cd}, "
          f"corr={corr}): {ups:.1f} updates/s @ {K} landmarks "
          f"(median of {len(ts)}, spread {spread:.1f}%)", file=sys.stderr)

    ab = None
    if corr == "syrk" and os.environ.get("BENCH_AB", "1") == "1":
        alt = dataclasses.replace(params, correction="gemm")
        ts_g = _time_reps(_batched_chain(alt, state, zs_all),
                          state, zs_all)
        ups_g = n_upd / float(np.median(ts_g))
        margin = 100.0 * (ups / ups_g - 1.0)
        ab = {"gemm_updates_per_sec": round(ups_g, 1),
              "gemm_spread_pct": round(_spread_pct(ts_g), 1),
              "syrk_margin_pct": round(margin, 1)}
        print(f"[bench] A/B same-state gemm: {ups_g:.1f} updates/s "
              f"(spread {ab['gemm_spread_pct']}%) -> syrk margin "
              f"{margin:+.1f}%", file=sys.stderr)
    return ups, spread, ab


def srekf_updates_per_sec(K: int) -> dict:
    """Square-root filter throughput at K landmarks (BENCH_SR=0 skips):
    the general-factor srekf_fast chain and the strict-TRIANGULAR panel
    chain (per-batch re-triangularization) — gate from factor strips +
    chunked Andrews update."""
    import dataclasses

    from ekf_slam_tpu.models.srekf import factor_from_state, sr_strips
    from ekf_slam_tpu.models.srekf_fast import (sr_update_chunked,
                                                sr_update_panel)
    from ekf_slam_tpu.ops.association import gate_batch

    batch, chunks = 4096, 8
    params0 = dataclasses.replace(
        _params(K, chunks), update_mode="srekf_fast")
    base = make_full_state(params0, K)
    # the factor carries sr_noise_buffer spare (zero) columns
    D = base.dim
    Dt = D + params0.sr_noise_buffer
    state = factor_from_state(base._replace(
        x=jnp.zeros((Dt,), base.x.dtype).at[:D].set(base.x),
        P=jnp.zeros((Dt, Dt), base.P.dtype).at[:D, :D].set(base.P)))
    rc0, rc1 = params0.rc
    out = {}
    for key, upd, n_batches in (
            ("updates_per_sec_srekf_fast", sr_update_chunked, 4),
            ("updates_per_sec_sr_triangular", sr_update_panel, 2)):
        zs_all = jnp.asarray(
            make_measurements(state, K, n_batches * batch).reshape(
                n_batches, batch, 3), params0.dtype)

        def one_batch(st, zs):
            Rs = jax.vmap(lambda z: jnp.diag(
                jnp.stack([z[0] * rc0, z[1] * rc1])))(zs).astype(
                    params0.dtype)
            strips = sr_strips(st.P, K, triangular=False)
            is_new, slots = gate_batch(st, zs, Rs, params0, strips=strips)
            return upd(st, zs, slots, Rs, ~is_new, params0), None

        run = jax.jit(lambda st, zb: jax.lax.scan(one_batch, st, zb)[0])
        ts = _time_reps(run, state, zs_all, n=3)
        out[key] = round(n_batches * batch / float(np.median(ts)), 1)
        print(f"[bench] {key} (M={batch}, G={chunks}): {out[key]} "
              f"updates/s @ {K} landmarks (spread "
              f"{_spread_pct(ts):.1f}%)", file=sys.stderr)
    return out


def oracle_10k_measured() -> float:
    """Measured 10k oracle throughput from the one-time offline artifact
    (experiments/oracle_10k.py — a real update at K=10k costs ~2e13 f64
    FLOPs, tens of minutes on this host, so it is measured once and
    pinned, not re-run inside every bench invocation).  Returns 0.0 when
    the artifact is absent (fallback: asymptotic extrapolation)."""
    try:
        with open(ORACLE_10K_ARTIFACT) as f:
            rec = json.load(f)
        ups = float(rec["updates_per_sec"])
        print(f"[bench] oracle @10k MEASURED: {ups:.2e} updates/s "
              f"({rec['median_seconds_per_update']:.0f} s/update, "
              f"n={rec['n_updates']}, {ORACLE_10K_ARTIFACT})",
              file=sys.stderr)
        return ups
    except (OSError, KeyError, ValueError):
        return 0.0


def _oracle_at(k: int) -> float:
    rng = np.random.default_rng(0)
    oracle = NumpyEKFSLAM(association="ml", s_cost=1e6, s_thresh=1e12)
    lm = rng.uniform(-40, 40, (k, 2))
    oracle.x = np.zeros(3 + 2 * k)
    oracle.x[3:] = lm.reshape(-1)
    D = len(oracle.x)
    A = rng.normal(0, 1, (D, 8)) / np.sqrt(D)
    oracle.P = 0.05 * np.eye(D) + 0.02 * (A @ A.T)
    oracle.s = np.arange(1, k + 1, dtype=float)

    idx = rng.integers(0, k, N_ORACLE)
    delta = lm[idx] - oracle.x[:2]
    r = np.hypot(delta[:, 0], delta[:, 1])
    b = np.mod(np.rad2deg(np.arctan2(delta[:, 1], delta[:, 0]))
               - oracle.x[2], 360.0)
    zs = np.stack([r, b, (idx + 1).astype(float)], axis=-1)

    times = []
    for z in zs:
        R = np.diag([z[0] * 0.1, z[1] * 5.0])
        t0 = time.perf_counter()
        is_new, kk = oracle.correspond(z, R)
        oracle.update(z, kk if not is_new else int(z[2]) - 1, R)
        times.append(time.perf_counter() - t0)
    # median per-update time: robust to BLAS warm-up and host-load spikes
    return 1.0 / float(np.median(times))


def _session_and_traj(T: int = 128, n_beams: int = 1024):
    """ONE flagship pipeline config shared by the frames and streaming
    metrics, so the streaming run reuses the frames run's compiled
    sub-computations (only the short window-scan program is new)."""
    from ekf_slam_tpu.config import RansacParams, SimConfig
    from ekf_slam_tpu.session import SlamSession
    from ekf_slam_tpu.sim import world as W

    cfg = SimConfig(n_beams=n_beams, max_range=12.0)
    room = W.rectangle_room(4.0, 3.0)
    traj = W.simulate(room, W.circle_controls(T, 0.05, 3.0), cfg,
                      jax.random.PRNGKey(0))
    sess = SlamSession(
        ekf_params=EKFParams(capacity=128, max_obs=8, ref_compat=False,
                             update_mode="batched", dtype=jnp.float32),
        ransac_params=RansacParams(
            line_consensus=60, bearing_window_deg=15.0,
            wall_search_timeout=4, table_capacity=64, promote_count=5,
            ref_compat=False, n_hypotheses=64, dtype=jnp.float32),
        seed=1)
    return sess, traj, T


def frames_per_sec(sess, traj, T):
    """Full-pipeline session throughput: odometry → predict → RANSAC →
    gate → update, T ticks fused in one lax.scan (the runSlam tick,
    SLAM.m:70-144).  Returns (fps, spread%, median seconds per run)."""
    odom = jnp.asarray(traj.odom, jnp.float32)
    rng = jnp.asarray(traj.ranges, jnp.float32)
    beams = jnp.asarray(traj.beam_angles, jnp.float32)
    carry = sess.init_carry(first_odom=odom[0])
    ts = _time_reps(lambda: sess._run(carry, odom, rng, beams))
    t_med = float(np.median(ts))
    fps = T / t_med
    print(f"[bench] session frames/s (full pipeline, 1024 beams, cap 128): "
          f"{fps:.1f} (median of {len(ts)}, spread {_spread_pct(ts):.1f}%)",
          file=sys.stderr)
    return fps, _spread_pct(ts), t_med


def dispatch_floor_ms() -> float:
    """Measured per-program-call dispatch floor: a trivial jitted op,
    median of 15 calls, each ended by a host fetch of its result.  One
    of the two quantities the streaming decomposition is built from."""
    f = jax.jit(lambda x: x + 1.0)
    v = jnp.zeros((8,), jnp.float32)
    np.asarray(f(v))
    ts = []
    for _ in range(15):
        t0 = time.perf_counter()
        np.asarray(f(v))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts) * 1e3)


def stream_ticks_per_sec(sess, traj, T, floor_ms, frames_t_med) -> dict:
    """Live streaming throughput: ticks pushed one at a time through
    window-16 micro-batches with async dispatch (io/stream.py) — the
    reference's operating mode (test_SLAM.m:16-18).
    Same session/pipeline as frames_per_sec (see _session_and_traj).

    The measured run cycles the trajectory BENCH_STREAM_CYCLES (4) times
    so that dispatch jitter averages over 32 programs, and the
    decomposition into two stable quantities is reported alongside:
    device compute per tick (from the fused frames run, which pays the
    dispatch once) and programs x the measured dispatch floor.
    ``stream_model_ticks_per_sec`` is that model's prediction."""
    from ekf_slam_tpu.io.stream import StreamingSlamSession

    WIN = 16
    CYCLES = int(os.environ.get("BENCH_STREAM_CYCLES", "4"))
    Ts = CYCLES * T
    n_prog = -(-Ts // WIN)
    odom = np.asarray(traj.odom)
    rng = np.asarray(traj.ranges)

    def run_once():
        stream = StreamingSlamSession(sess, n_beams=rng.shape[1],
                                      beam_angles=traj.beam_angles,
                                      window=WIN, first_odom=odom[0])
        for t in range(Ts):
            stream.push(odom[t % T], rng[t % T])
        stream.flush()
        return stream.stats.summary()

    run_once()                     # compile off the clock
    reps = [run_once() for _ in range(max(3, N_REPS))]
    tps = np.asarray([s["ticks_per_sec"] for s in reps])
    p99 = float(np.median([s["latency_p99_ms"] for s in reps]))
    spread = float(100.0 * (tps.max() - tps.min()) / np.median(tps))

    # floor-model decomposition from two stable medians
    compute_ms = max(0.0, frames_t_med * 1e3 - floor_ms) / T
    model_tps = Ts / ((n_prog * floor_ms + Ts * compute_ms) / 1e3)
    print(f"[bench] streaming (window {WIN}, {Ts} ticks / {n_prog} "
          f"programs): {float(np.median(tps)):.1f} ticks/s (median of "
          f"{len(reps)}, spread {spread:.1f}%, reps "
          f"{np.round(tps, 1).tolist()}), p99 {p99:.0f} ms; model "
          f"{model_tps:.1f} ticks/s = {Ts} / ({n_prog} x {floor_ms:.1f} "
          f"ms floor + {Ts} x {compute_ms:.2f} ms compute)",
          file=sys.stderr)
    return {
        "stream_ticks_per_sec": round(float(np.median(tps)), 1),
        "stream_spread_pct": round(spread, 1),
        "stream_model_ticks_per_sec": round(model_tps, 1),
        "stream_device_ms_per_tick": round(compute_ms, 3),
        "stream_programs": n_prog,
        "dispatch_floor_ms": round(floor_ms, 2),
    }


def main():
    from ekf_slam_tpu.utils.runtime import device_report, enable_compile_cache
    enable_compile_cache()
    dev = device_report()
    print(f"[bench] device: {dev}", file=sys.stderr)
    extra = {"platform": dev["platform"], "device_kind": dev["kind"],
             "device_count": dev["count"]}

    run_1k = ONLY_K in (None, 1000)
    run_10k = ONLY_K in (None, 10000)
    run_frames = os.environ.get("BENCH_FRAMES", "1") == "1" and run_1k

    if run_frames:
        sess, traj, T = _session_and_traj()
        fps, fps_spread, frames_t_med = frames_per_sec(sess, traj, T)
        extra["frames_per_sec"] = round(fps, 1)
        extra["frames_spread_pct"] = round(fps_spread, 1)
        # streaming is the reference's actual operating mode
        # (test_SLAM.m:16-18): on by default, riding the frames run's
        # compiled pipeline (BENCH_STREAM=0 to skip)
        if os.environ.get("BENCH_STREAM", "1") == "1":
            floor = dispatch_floor_ms()
            extra.update(stream_ticks_per_sec(sess, traj, T, floor,
                                              frames_t_med))

    orc_1k = _oracle_at(1000)
    print(f"[bench] numpy oracle @1k: {orc_1k:.3f} updates/s",
          file=sys.stderr)

    if run_1k:
        ups_1k, spread_1k, _ = batched_updates_per_sec(1000)
        extra["updates_per_sec_1k"] = round(ups_1k, 1)
        extra["spread_pct_1k"] = round(spread_1k, 1)
        extra["vs_baseline_1k"] = round(ups_1k / orc_1k, 1)
        if os.environ.get("BENCH_SEQ") == "1":
            extra["sequential_updates_per_sec_1k"] = round(
                sequential_updates_per_sec(1000), 1)

    if run_10k:
        ups_10k, spread_10k, ab_10k = batched_updates_per_sec(10000)
        extra["spread_pct_10k"] = round(spread_10k, 1)
        if ab_10k is not None:
            extra["corr_ab_10k"] = ab_10k
        if os.environ.get("BENCH_SR", "1") == "1":
            # the square-root options at the north-star scale
            extra.update(srekf_updates_per_sec(10000))
        scale = ((10000 * 20003 ** 2 + 20003 ** 3)
                 / (1000 * 2003 ** 2 + 2003 ** 3))
        extrap = orc_1k / scale
        print(f"[bench] oracle @10k extrapolation cross-check "
              f"(1k / {scale:.0f}): {extrap:.2e} updates/s",
              file=sys.stderr)
        orc_10k = oracle_10k_measured() or extrap
        primary = {
            "metric": "ekf_updates_per_sec_chip_10000_landmarks",
            "value": round(ups_10k, 2),
            "unit": "updates/s",
            "vs_baseline": round(ups_10k / orc_10k, 2),
        }
    else:
        primary = {
            "metric": "ekf_updates_per_sec_chip_1000_landmarks",
            "value": extra.pop("updates_per_sec_1k"),
            "unit": "updates/s",
            "vs_baseline": extra.pop("vs_baseline_1k"),
        }
    primary["extra"] = extra
    print(json.dumps(primary))


if __name__ == "__main__":
    main()
