"""Smoke test of the SLAM engine on an NVIDIA GPU, at the sizes users run.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --four     # four cards: the multi-card paths only

One process drives the card(s).  Each phase prints one line with its wall
seconds and its check values; a phase whose check fails prints its
traceback and the script exits non-zero after the remaining phases.  Only
when every phase passed is the last line of standard output

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

Without a GPU the script stops at the device phase, non-zero, and prints
no result.  Phases (one card):

  device     jax.devices(), the device kind, and nvidia-smi's name and
             power limit of the card;
  pipeline   the building-scale campaign (16x16-room floorplan, capacity
             2560, ICP control, 1024 beams) through SlamSession.run, and
             the 128-capacity flagship pipeline that bench.py times,
             against its f64 run;
  update_10k the batched gate+update chain of bench.py at 10k landmarks
             (bf16 P with correction='syrk', and f32 P with 'gemm' at the
             default and at "highest" matmul precision), each against an
             f64 run of the same chain; prints the step's memory_analysis();
  sqrt_10k   sr_update_chunked and sr_update_panel at 10k landmarks against
             the dense f32 chain at "highest" precision;
  stream     StreamingSlamSession (window 16) against the fused run;
  parity     the ref_compat session against the NumPy oracle in f64.

--four runs ShardedSlamSession on a 4-card map mesh at 10k capacity
(update_path gspmd, shard_map, shard_map + correction='syrk', sharded
srekf_fast) and FleetSlamSession with 4 robots on the data axis, each
against the same configuration on one card.

The persistent compile cache follows JAX_COMPILATION_CACHE_DIR, or else
<checkout>/.jax_cache (ekf_slam_tpu/utils/runtime.py).
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import runpy
import subprocess
import sys
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np

import bench
from ekf_slam_tpu.config import EKFParams, RansacParams, SimConfig
from ekf_slam_tpu.models import batched
from ekf_slam_tpu.utils import runtime


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Problem sizes of every phase; the defaults are the card's."""
    rooms: int = 16                   # campaign floorplan is rooms x rooms
    campaign_capacity: int = 2560     # P is 5123² f32
    campaign_ticks: int = 2048
    beams: int = 1024
    flagship_ticks: int = 128         # bench.py's frames/streaming cell
    update_k: int = 10000             # landmarks of the update chains
    update_batch: int = 4096          # observations per batch (M)
    update_chunks: int = 8            # G: chunks of 512
    update_batches: int = 2
    stream_window: int = 16
    parity_ticks: int = 80
    parity_beams: int = 720
    four_capacity: int = 10000
    four_ticks: int = 6
    four_sr_buffer: int = 4           # recompress fires inside four_ticks


#: CPU-sized version of every phase (tests/test_chip_smoke.py)
TINY = Sizes(rooms=2, campaign_capacity=96, campaign_ticks=160, beams=360,
             flagship_ticks=32, update_k=48, update_batch=32,
             update_chunks=2, update_batches=2, stream_window=8,
             parity_ticks=40, parity_beams=360, four_capacity=24,
             four_ticks=6, four_sr_buffer=4)


class SmokeFailure(AssertionError):
    """A phase's check did not hold."""


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def _max_abs(a) -> float:
    return float(jnp.max(jnp.abs(a)))


# ---------------------------------------------------------------------------
# device
# ---------------------------------------------------------------------------

def nvidia_smi() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def phase_device(n_cards: int) -> dict:
    report = runtime.require_gpu()
    check(report["count"] >= n_cards,
          f"need {n_cards} GPU(s), JAX found {report['count']}")
    print(f"[smoke] jax.devices(): {jax.devices()}", flush=True)
    print(f"[smoke] nvidia-smi name, power.limit: {nvidia_smi()}",
          flush=True)
    return report


def result_line(report: dict) -> str:
    """The last line of a passing run: exactly the contract's keys."""
    return json.dumps({"ok": True, "device": {
        "platform": report["platform"], "kind": report["kind"],
        "count": int(report["count"])}})


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------

def phase_campaign(sz: Sizes) -> dict:
    """The building-scale campaign through SlamSession.run."""
    run_campaign = runpy.run_path(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "examples",
        "large_world_slam.py"))["run_campaign"]
    t0 = time.perf_counter()
    m, carry, outs = run_campaign(
        rooms=sz.rooms, ticks=sz.campaign_ticks,
        capacity=sz.campaign_capacity, control="icp", seed=0,
        n_beams=sz.beams)
    jax.block_until_ready(carry)
    secs = time.perf_counter() - t0
    finite = all(bool(jnp.all(jnp.isfinite(leaf)))
                 for leaf in (carry.filt.x, carry.filt.P, outs.pose))
    out = {"ticks": m["ticks"], "wall_s_incl_compile": round(secs, 2),
           "ticks_per_s_incl_compile": round(m["ticks"] / secs, 1),
           "landmarks": m["landmarks"], "capacity": sz.campaign_capacity,
           "ate_slam_aligned_m": round(m["ate_slam_aligned"], 4),
           "ate_odom_m": round(m["ate_odom"], 4),
           "map_matched": m["map_aligned"]["n_matched"],
           "map_gt": m["map_aligned"]["n_gt"],
           "map_spurious": m["map_aligned"]["n_spurious"],
           "nis_mean": round(m["nis_mean"], 3), "finite": finite}
    check(finite, f"campaign state or poses not finite: {out}")
    check(0 < m["landmarks"] <= sz.campaign_capacity,
          f"landmarks outside (0, capacity]: {out}")
    check(m["ate_slam_aligned"] < m["ate_odom"],
          f"aligned SLAM ATE not below dead reckoning's: {out}")
    return out


@functools.lru_cache(maxsize=None)
def _flagship(sz: Sizes):
    """bench.py's flagship session and trajectory, at sz's size (shared by
    the pipeline and stream phases, so the stream reuses its programs)."""
    sess, traj, _ = bench._session_and_traj(sz.flagship_ticks, sz.beams)
    odom = jnp.asarray(traj.odom, jnp.float32)
    rng = jnp.asarray(traj.ranges, jnp.float32)
    beams = jnp.asarray(traj.beam_angles, jnp.float32)
    return sess, traj, odom, rng, beams


def phase_flagship(sz: Sizes) -> dict:
    """The 128-capacity full pipeline bench.py times (frames cell),
    checked against the same session in f64 on the same trajectory.

    Tolerance: the same landmark count, poses within 1e-2 m of the f64
    run and ATE within 1e-2 m of its ATE.  Reason: on the CPU the f32 and
    f64 runs of bench.py's trajectory differ by 3.5e-3 m at most (f32
    rounding carried through 128 ticks of the filter); a biased rotation
    or a lost update moves the poses by more than the room's wall noise."""
    from ekf_slam_tpu.session import SlamSession
    from ekf_slam_tpu.sim import world as W
    sess, traj, odom, rng, beams = _flagship(sz)
    t0 = time.perf_counter()
    carry, outs = jax.block_until_ready(sess.run(odom, rng, beams))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    carry, outs = jax.block_until_ready(sess.run(odom, rng, beams))
    steady = time.perf_counter() - t0
    pose = np.asarray(outs.pose, np.float64)
    ate = float(W.ate_rmse(pose[:, :2], traj.truth[:, :2]))
    ate_odo = float(W.ate_rmse(traj.odom[:, :2], traj.truth[:, :2]))
    n = int(carry.filt.n_active)
    finite = bool(jnp.all(jnp.isfinite(carry.filt.P)))
    with jax.enable_x64(True):
        s64 = SlamSession(
            ekf_params=dataclasses.replace(sess.ekf_params,
                                           dtype=jnp.float64),
            ransac_params=dataclasses.replace(sess.ransac_params,
                                              dtype=jnp.float64),
            seed=sess.seed)
        c64, o64 = s64.run(*(jnp.asarray(a, jnp.float64) for a in (
            traj.odom, traj.ranges, traj.beam_angles)))
        pose64 = np.asarray(o64.pose)
        n64 = int(c64.filt.n_active)
    ate64 = float(W.ate_rmse(pose64[:, :2], traj.truth[:, :2]))
    dpose = float(np.max(np.abs(pose[:, :2] - pose64[:, :2])))
    out = {"ticks": sz.flagship_ticks, "first_run_s": round(first, 2),
           "steady_run_s": round(steady, 4),
           "ticks_per_s_wall": round(sz.flagship_ticks / steady, 1),
           "landmarks": n, "landmarks_f64": n64, "ate_slam_m": round(ate, 4),
           "ate_slam_f64_m": round(ate64, 4),
           "max_dpose_vs_f64_m": float(f"{dpose:.3e}"),
           "ate_odom_m": round(ate_odo, 4), "finite": finite}
    check(finite, f"flagship P not finite: {out}")
    check(0 < n <= sess.ekf_params.capacity, f"landmarks: {out}")
    check(n == n64, f"landmark count differs from the f64 run: {out}")
    check(dpose <= 1e-2 and abs(ate - ate64) <= 1e-2,
          f"flagship poses or ATE differ from the f64 run: {out}")
    return out


# ---------------------------------------------------------------------------
# update_10k
# ---------------------------------------------------------------------------

def _chain(params: EKFParams):
    """bench._batched_chain, also returning each batch's slots."""
    rc0, rc1 = params.rc
    from ekf_slam_tpu.ops.association import gate_batch

    def one_batch(st, zs):
        Rs = jax.vmap(lambda z: jnp.diag(
            jnp.stack([z[0] * rc0, z[1] * rc1])))(zs).astype(params.dtype)
        is_new, slots = gate_batch(st, zs, Rs, params)
        return batched.update_chunked(st, zs, slots, Rs, ~is_new,
                                      params), slots

    return one_batch, jax.jit(
        lambda st, zb: jax.lax.scan(one_batch, st, zb))


def _memory_line(compiled) -> dict:
    ma = compiled.memory_analysis()
    return {k: int(getattr(ma, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "alias_size_in_bytes", "temp_size_in_bytes",
        "generated_code_size_in_bytes")}


def phase_update(sz: Sizes) -> dict:
    """The 10k gate+update chain as bench.py builds it, checked against
    an f64 run of the same chain.

    Tolerances (measurements are exact predictions, bench
    .make_measurements, so association is unambiguous): slots identical;
    f32 P: max|ΔP| ≤ 1e-3·max|P| and max|Δx| ≤ 1e-3 m; bf16 P:
    max|ΔP| ≤ 1e-2·max|P| (bf16 keeps 8 mantissa bits, a relative
    rounding of 2^-9 per stored entry) and max|Δx| ≤ 1e-2 m."""
    K = sz.update_k
    batch, chunks = sz.update_batch, sz.update_chunks
    nb = sz.update_batches
    _, _, _, pht, _, _ = bench._defaults(K)
    base = dataclasses.replace(bench._params(K, chunks), pht_mode=pht)
    p_bf16 = dataclasses.replace(base, cov_dtype=jnp.bfloat16,
                                 correction="syrk")
    p_f32 = dataclasses.replace(base, correction="gemm")
    st32 = bench.make_full_state(p_f32, K)
    st16 = st32._replace(P=st32.P.astype(jnp.bfloat16))
    zs = jnp.asarray(bench.make_measurements(st32, K, nb * batch).reshape(
        nb, batch, 3), jnp.float32)
    out = {"K": K, "D": st32.dim, "M": batch, "G": chunks, "batches": nb,
           "pht_mode": pht}

    one16, run16 = _chain(p_bf16)
    mem = _memory_line(jax.jit(one16).lower(st16, zs[0]).compile())
    print(f"[smoke] update_10k memory_analysis (one bf16 syrk batch step, "
          f"D={st32.dim}): {json.dumps(mem)}", flush=True)
    out["step_temp_bytes"] = mem["temp_size_in_bytes"]

    runs = {}
    t0 = time.perf_counter()
    runs["bf16_syrk"] = jax.block_until_ready(run16(st16, zs))
    out["bf16_syrk_s_incl_compile"] = round(time.perf_counter() - t0, 2)
    _, run32 = _chain(p_f32)
    t0 = time.perf_counter()
    runs["f32_gemm_default"] = jax.block_until_ready(run32(st32, zs))
    out["f32_gemm_default_s_incl_compile"] = round(
        time.perf_counter() - t0, 2)
    with jax.default_matmul_precision("highest"):
        _, run32h = _chain(p_f32)
        t0 = time.perf_counter()
        runs["f32_gemm_highest"] = jax.block_until_ready(run32h(st32, zs))
        out["f32_gemm_highest_s_incl_compile"] = round(
            time.perf_counter() - t0, 2)

    failures = []
    with jax.enable_x64(True):
        p64 = dataclasses.replace(p_f32, dtype=jnp.float64)
        _, run64 = _chain(p64)
        refs = {}
        for name, st in (("from_f32", st32), ("from_bf16", st16)):
            st64 = jax.tree_util.tree_map(
                lambda a: a.astype(jnp.float64)
                if jnp.issubdtype(a.dtype, jnp.floating) else a, st)
            refs[name] = jax.block_until_ready(
                run64(st64, zs.astype(jnp.float64)))
        for name, (st, slots) in runs.items():
            ref_st, ref_slots = refs["from_bf16" if name.startswith("bf16")
                                     else "from_f32"]
            p_scale = _max_abs(ref_st.P)
            dP = _max_abs(st.P.astype(jnp.float64) - ref_st.P) / p_scale
            dx = _max_abs(st.x.astype(jnp.float64) - ref_st.x)
            same = bool(jnp.array_equal(slots, ref_slots))
            tol_p, tol_x = ((1e-2, 1e-2) if name.startswith("bf16")
                            else (1e-3, 1e-3))
            out[name] = {"rel_max_dP": float(f"{dP:.3e}"),
                         "max_dx_m": float(f"{dx:.3e}"),
                         "slots_identical": same,
                         "finite": bool(jnp.all(jnp.isfinite(st.P)))}
            if not (same and dP <= tol_p and dx <= tol_x
                    and out[name]["finite"]):
                failures.append(f"{name}: {out[name]} vs tolerance "
                                f"dP≤{tol_p}·max|P|, dx≤{tol_x} m")
    check(not failures, "; ".join(failures))
    return out


# ---------------------------------------------------------------------------
# sqrt_10k
# ---------------------------------------------------------------------------

def phase_sqrt(sz: Sizes) -> dict:
    """sr_update_chunked / sr_update_panel at 10k, as bench.py runs them,
    against the dense f32 chain at "highest" precision on the same input.

    Tolerance: max|S·Sᵀ − P_dense| ≤ 2e-3·max|P|.  Reason: the factor
    path runs its GEMMs at the default f32 matmul precision (on this card
    that may be TF32, a 10-bit mantissa: ~5e-4 relative per product, a few
    products deep), while the reference runs every product at "highest"."""
    from ekf_slam_tpu.models.srekf import factor_from_state, sr_strips
    from ekf_slam_tpu.models.srekf_fast import (sr_update_chunked,
                                                sr_update_panel)
    from ekf_slam_tpu.ops.association import gate_batch

    K, batch, chunks = sz.update_k, sz.update_batch, sz.update_chunks
    p_sr = dataclasses.replace(bench._params(K, chunks),
                               update_mode="srekf_fast")
    p_dense = bench._params(K, chunks)
    base = bench.make_full_state(p_dense, K)
    D = base.dim
    Dt = D + p_sr.sr_noise_buffer
    fac = factor_from_state(base._replace(
        x=jnp.zeros((Dt,), base.x.dtype).at[:D].set(base.x),
        P=jnp.zeros((Dt, Dt), base.P.dtype).at[:D, :D].set(base.P)))
    zs = jnp.asarray(bench.make_measurements(base, K, batch), jnp.float32)
    rc0, rc1 = p_sr.rc
    Rs = jax.vmap(lambda z: jnp.diag(
        jnp.stack([z[0] * rc0, z[1] * rc1])))(zs).astype(jnp.float32)

    @jax.jit
    def sr_gate(st):
        strips = sr_strips(st.P, K, triangular=False)
        return gate_batch(st, zs, Rs, p_sr, strips=strips)

    with jax.default_matmul_precision("highest"):
        @jax.jit
        def dense_ref(st):
            is_new, slots = gate_batch(st, zs, Rs, p_dense)
            return batched.update_chunked(st, zs, slots, Rs, ~is_new,
                                          p_dense), slots

        ref, ref_slots = jax.block_until_ready(dense_ref(base))

        @jax.jit
        def gram(S):
            return (S @ S.T)[:D, :D]

    is_new, slots = sr_gate(fac)
    out = {"K": K, "D": D, "M": batch, "G": chunks,
           "slots_identical": bool(jnp.array_equal(slots, ref_slots))}
    p_scale = _max_abs(ref.P)
    failures = [] if out["slots_identical"] else ["slots differ"]
    for name, fn in (("sr_update_chunked", sr_update_chunked),
                     ("sr_update_panel", sr_update_panel)):
        run = jax.jit(lambda st, fn=fn: fn(st, zs, slots, Rs, ~is_new,
                                           p_sr))
        t0 = time.perf_counter()
        st = jax.block_until_ready(run(fac))
        secs = time.perf_counter() - t0
        with jax.default_matmul_precision("highest"):
            P_sr = gram(st.P)
        rel = _max_abs(P_sr - ref.P) / p_scale
        finite = bool(jnp.all(jnp.isfinite(st.P)))
        dx = _max_abs(st.x[:D] - ref.x)
        out[name] = {"s_incl_compile": round(secs, 2), "finite": finite,
                     "rel_max_dP": float(f"{rel:.3e}"),
                     "max_dx_m": float(f"{dx:.3e}")}
        if not (finite and rel <= 2e-3 and dx <= 1e-3):
            failures.append(f"{name}: {out[name]}")
    check(not failures, "; ".join(failures))
    return out


# ---------------------------------------------------------------------------
# stream
# ---------------------------------------------------------------------------

def phase_stream(sz: Sizes) -> dict:
    """StreamingSlamSession over the flagship trajectory vs the fused
    run: every pushed tick comes back, poses within 1e-5 m."""
    from ekf_slam_tpu.io.stream import StreamingSlamSession
    sess, traj, odom, rng, beams = _flagship(sz)
    _, fused = sess.run(odom, rng, beams)
    fused_pose = np.asarray(fused.pose, np.float64)
    odom_np, rng_np = np.asarray(odom), np.asarray(rng)
    stream = StreamingSlamSession(sess, n_beams=rng_np.shape[1],
                                  beam_angles=beams,
                                  window=sz.stream_window,
                                  first_odom=odom_np[0])
    t0 = time.perf_counter()
    got = []
    for t in range(sz.flagship_ticks):
        got.extend(stream.push(odom_np[t], rng_np[t]))
    got.extend(stream.flush())
    secs = time.perf_counter() - t0
    s = stream.stats.summary()
    poses = np.stack([np.asarray(o.pose, np.float64) for o in got])
    dpose = float(np.max(np.abs(poses[:, :2] - fused_pose[:len(got), :2])))
    out = {"pushed": sz.flagship_ticks, "returned": len(got),
           "window": sz.stream_window, "wall_s_incl_compile": round(secs, 2),
           "max_dpose_m": float(f"{dpose:.3e}"),
           "latency_p50_ms": round(s["latency_p50_ms"], 2),
           "latency_p99_ms": round(s["latency_p99_ms"], 2)}
    check(len(got) == sz.flagship_ticks, f"ticks lost by the stream: {out}")
    check(dpose <= 1e-5, f"stream poses differ from the fused run: {out}")
    return out


# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------

def phase_parity(sz: Sizes) -> dict:
    """The ref_compat session against the NumPy oracle in f64, at the
    configuration of tests/test_sim_session.py's oracle-parity test.

    Tolerance: x within rtol 1e-6 / atol 1e-8, P within rtol 1e-4 /
    atol 1e-7 — ten times the CPU test's, because the card's f64 sin,
    cos and atan2 are not NumPy's (a few ulp apart) and the ref-compat
    chain carries each tick's rounding into the next for the whole run."""
    from ekf_slam_tpu.oracle.np_ekf import NumpyEKFSLAM
    from ekf_slam_tpu.session import SlamSession
    from ekf_slam_tpu.sim import world as W
    with jax.enable_x64(True):
        cfg = SimConfig(n_beams=sz.parity_beams, max_range=12.0,
                        range_noise_std=0.01, odom_xy_noise_std=0.0005,
                        odom_theta_noise_std=0.02)
        traj = W.simulate(W.rectangle_room(4.0, 3.0),
                          W.circle_controls(sz.parity_ticks, dD=0.05,
                                            dTh=3.0),
                          cfg, jax.random.PRNGKey(0),
                          start_pose=(0.0, 0.0, 0.0))
        rp = RansacParams(line_consensus=60, bearing_window_deg=15.0,
                          wall_search_timeout=4, table_capacity=32,
                          promote_count=5, ref_compat=False,
                          dtype=jnp.float64)
        ep = EKFParams(capacity=16, max_obs=8, dtype=jnp.float64)
        sess = SlamSession(algorithm="EKF_SLAM_UC", ekf_params=ep,
                           ransac_params=rp, seed=1)
        carry, outs = sess.run(traj.odom, traj.ranges, traj.beam_angles)
        x_dev = np.asarray(carry.filt.x)
        P_dev = np.asarray(carry.filt.P)
        n_dev = int(carry.filt.n_active)
        u_all = np.asarray(outs.u)
        valid = np.asarray(outs.obs.valid)
        rows_all = np.stack([np.asarray(outs.obs.rng),
                             np.asarray(outs.obs.bearing),
                             np.asarray(outs.obs.index).astype(float)], -1)
        locs_all = np.asarray(outs.obs.loc)
    oracle = NumpyEKFSLAM(rc=ep.rc, s_cost=ep.s_cost, s_thresh=ep.s_thresh)
    for t in range(sz.parity_ticks):
        oracle.predict(u_all[t])
        m = valid[t]
        if m.any():
            rows = rows_all[t][m]
            locs = {int(r[2]): locs_all[t][m][i] for i, r in enumerate(rows)}
            oracle.measure(rows, u_all[t], locs)
    d = 3 + 2 * oracle.n_landmarks
    out = {"ticks": sz.parity_ticks, "landmarks_device": n_dev,
           "landmarks_oracle": oracle.n_landmarks}
    check(n_dev == oracle.n_landmarks, f"landmark counts differ: {out}")
    dx = np.abs(x_dev[:d] - oracle.x)
    dP = np.abs(P_dev[:d, :d] - oracle.P)
    out["max_dx"] = float(f"{dx.max():.3e}")
    out["max_dP"] = float(f"{dP.max():.3e}")
    check(bool(np.all(dx <= 1e-8 + 1e-6 * np.abs(oracle.x))),
          f"x differs from the oracle: {out}")
    check(bool(np.all(dP <= 1e-7 + 1e-4 * np.abs(oracle.P))),
          f"P differs from the oracle: {out}")
    return out


# ---------------------------------------------------------------------------
# --four
# ---------------------------------------------------------------------------

def phase_four(sz: Sizes, n: int = 4) -> dict:
    """Row-sharded sessions on an n-card map mesh and a fleet on the data
    axis, each against the same configuration on one card.

    Tolerance: poses within 1e-4 m and the active block of P within
    1e-3·max|P| — f32 sums run in another order once rows are split over
    cards and combined by collectives."""
    from ekf_slam_tpu.parallel.mesh import make_mesh
    from ekf_slam_tpu.parallel.multi import FleetSlamSession
    from ekf_slam_tpu.parallel.sharded import ShardedSlamSession
    from ekf_slam_tpu.sim import world as W

    T = sz.four_ticks
    cfg = SimConfig(n_beams=1024, max_range=12.0)
    traj = W.simulate(W.rectangle_room(4.0, 3.0),
                      W.circle_controls(T, 0.05, 3.0), cfg,
                      jax.random.PRNGKey(0))
    odom = jnp.asarray(traj.odom, jnp.float32)
    rng = jnp.asarray(traj.ranges, jnp.float32)
    beams = jnp.asarray(traj.beam_angles, jnp.float32)
    rp = RansacParams(line_consensus=60, bearing_window_deg=15.0,
                      wall_search_timeout=4, table_capacity=64,
                      promote_count=2, ref_compat=False, n_hypotheses=64,
                      dtype=jnp.float32)
    ep = EKFParams(capacity=sz.four_capacity, max_obs=8, ref_compat=False,
                   update_mode="batched", dtype=jnp.float32)
    cases = {
        "gspmd": (ep, "gspmd"),
        "shard_map": (ep, "shard_map"),
        "shard_map_syrk": (dataclasses.replace(ep, correction="syrk"),
                           "shard_map"),
        "srekf_fast": (dataclasses.replace(
            ep, update_mode="srekf_fast",
            sr_noise_buffer=sz.four_sr_buffer), "shard_map"),
    }
    out = {"cards": n, "capacity": sz.four_capacity, "ticks": T}
    failures = []
    fleet_ep = EKFParams(capacity=128, max_obs=8, ref_compat=False,
                         update_mode="batched", dtype=jnp.float32)
    odoms = jnp.tile(odom[:, None], (1, n, 1))
    rngs = jnp.tile(rng[:, None], (1, n, 1))
    fres = {}
    for mesh in (make_mesh(n_map=1, n_data=n), None):
        fleet = FleetSlamSession(n_sessions=n, ekf_params=fleet_ep,
                                 ransac_params=rp, mesh=mesh, seed=1)
        carry, outs = jax.block_until_ready(fleet.run(odoms, rngs, beams))
        fres[mesh is None] = (np.asarray(outs.pose, np.float64),
                              np.asarray(carry.filt.n_active),
                              len(carry.filt.P.addressable_shards))
    (pm, km, shm), (p1, k1, _) = fres[False], fres[True]
    dpose = float(np.max(np.abs(pm - p1)))
    out["fleet"] = {"robots": n, "landmarks": km.tolist(), "shards": shm,
                    "max_dpose_m": float(f"{dpose:.3e}")}
    if not (np.array_equal(km, k1) and shm == n and dpose <= 1e-4):
        failures.append(f"fleet: {out['fleet']}")
    print(f"[smoke] four/fleet: {json.dumps(out['fleet'])}", flush=True)
    for name, (params, path) in cases.items():
        res = {}
        for cards in (n, 1):
            sess = ShardedSlamSession(mesh=make_mesh(n_map=cards),
                                      ekf_params=params, ransac_params=rp,
                                      seed=0, update_path=path)
            check(sess.ekf_params.correction == params.correction,
                  f"{name}: correction changed")
            t0 = time.perf_counter()
            carry, outs = jax.block_until_ready(sess.run(odom, rng, beams))
            secs = time.perf_counter() - t0
            P = carry.filt.P
            if params.update_mode == "srekf_fast":
                with jax.default_matmul_precision("highest"):
                    P = P @ P.T
            k = int(carry.filt.n_active)
            res[cards] = (np.asarray(outs.pose, np.float64), k,
                          np.asarray(P[:3 + 2 * k, :3 + 2 * k], np.float64),
                          secs, len(carry.filt.P.addressable_shards))
        (pn, kn, Pn, sn, shn), (p1, k1, P1, s1, _) = res[n], res[1]
        dpose = float(np.max(np.abs(pn[:, :2] - p1[:, :2])))
        dP = (float(np.max(np.abs(Pn - P1)) / np.max(np.abs(P1)))
              if kn == k1 else float("inf"))
        out[name] = {"landmarks": [kn, k1], "shards": shn,
                     "max_dpose_m": float(f"{dpose:.3e}"),
                     "rel_max_dP": float(f"{dP:.3e}"),
                     f"s_incl_compile_{n}card": round(sn, 2),
                     "s_incl_compile_1card": round(s1, 2)}
        print(f"[smoke] four/{name}: {json.dumps(out[name])}", flush=True)
        if not (kn == k1 > 0 and shn == n and dpose <= 1e-4
                and dP <= 1e-3):
            failures.append(f"{name}: {out[name]}")

    check(not failures, "; ".join(failures))
    return out


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def run_phases(phases) -> bool:
    """Run (name, fn) pairs in order, one line each; True iff all passed.
    A failing phase prints its traceback and the next phase still runs."""
    ok = True
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            vals = fn()
        except Exception:                      # reported, never swallowed
            ok = False
            traceback.print_exc()
            print(f"[smoke] {name}: FAILED after "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            continue
        print(f"[smoke] {name}: {time.perf_counter() - t0:.1f} s "
              f"{json.dumps(vals)}", flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths")
    args = ap.parse_args(argv)
    sz = Sizes()
    n_cards = 4 if args.four else 1

    t0 = time.perf_counter()
    try:
        report = phase_device(n_cards)
    except Exception as e:
        print(f"[smoke] device: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(f"[smoke] device: {time.perf_counter() - t0:.1f} s "
          f"{json.dumps(report)}", flush=True)
    # only once a GPU is found: the cache is process-wide configuration
    print(f"[smoke] compile cache: {runtime.enable_compile_cache()}",
          flush=True)

    if args.four:
        phases = [("four", lambda: phase_four(sz, n_cards))]
    else:
        phases = [("pipeline_campaign", lambda: phase_campaign(sz)),
                  ("pipeline_flagship", lambda: phase_flagship(sz)),
                  ("update_10k", lambda: phase_update(sz)),
                  ("sqrt_10k", lambda: phase_sqrt(sz)),
                  ("stream", lambda: phase_stream(sz)),
                  ("parity", lambda: phase_parity(sz))]
    if not run_phases(phases):
        return 1
    print(result_line(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
