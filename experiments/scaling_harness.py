"""Scaling evidence for the distributed covariance update (SCALING.md).

For the map-axis sharded session, on 2/4/8 virtual devices and for BOTH
distributed-update expressions (GSPMD-derived collectives vs the explicit
shard_map psum/all_gather Schur combine), this harness extracts from the
COMPILED programs:

  * collective traffic per tick — every all-gather / all-reduce /
    all-to-all / collective-permute in the optimized HLO, with its shape
    → bytes (the quantity that crosses the links between devices);
  * total FLOPs and per-device P-resident bytes (work balance);
  * wall-clock per tick on the virtual mesh (relative comparison only —
    CPU collectives are memcpys; card numbers come from chip_smoke.py
    --four and bench.py).

Output: a JSON document (stdout) consumed to write SCALING.md.

Run:  python -m experiments.scaling_harness [--capacity 256] [--ticks 8]
"""
from __future__ import annotations

import argparse
import json
import re
import sys
import time

import numpy as np


_COLL_RE = re.compile(
    r"\b(all-gather|all-reduce|all-to-all|collective-permute)\(")
_SHAPE_RE = re.compile(r"\b(f32|f64|bf16|s32|u32|pred|s8|u8)\[([0-9,]*)\]")
_BYTES = {"f32": 4, "f64": 8, "bf16": 2, "s32": 4, "u32": 4, "pred": 1,
          "s8": 1, "u8": 1}


def collective_bytes(hlo_text: str):
    """Sum output bytes of collective ops in optimized HLO, by op kind.

    Counts each instruction's OUTPUT shape(s) (the line's lhs), which for
    all-gather/all-reduce is the full gathered/reduced payload."""
    per_kind = {}
    counts = {}
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m or "=" not in line:
            continue
        kind = m.group(1)
        # `%name = f32[528,16]{1,0} all-gather(...)` — the instruction's
        # output shape(s) sit between '=' and the op call
        seg = line.split("=", 1)[1].split(kind + "(", 1)[0]
        nbytes = 0
        for dt, dims in _SHAPE_RE.findall(seg):
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            nbytes += n * _BYTES[dt]
        per_kind[kind] = per_kind.get(kind, 0) + nbytes
        counts[kind] = counts.get(kind, 0) + 1
    return per_kind, counts


def analyze(n_dev: int, update_path: str, capacity: int, ticks: int):
    import jax
    import jax.numpy as jnp
    from ekf_slam_tpu.config import EKFParams
    from ekf_slam_tpu.parallel.mesh import make_mesh
    from ekf_slam_tpu.parallel.sharded import ShardedSlamSession
    from ekf_slam_tpu.sim import world as W
    from ekf_slam_tpu.config import SimConfig

    from ekf_slam_tpu.config import RansacParams
    ep = EKFParams(capacity=capacity, max_obs=8, ref_compat=False,
                   update_mode="batched", dtype=jnp.float32)
    rp = RansacParams(line_consensus=60, bearing_window_deg=15.0,
                      wall_search_timeout=4, table_capacity=32,
                      promote_count=5, ref_compat=False, dtype=jnp.float32)

    cfg = SimConfig(n_beams=720, max_range=12.0)
    room = W.rectangle_room(4.0, 3.0)
    traj = W.simulate(room, W.circle_controls(ticks + 1, 0.05, 3.0), cfg,
                      jax.random.PRNGKey(0))

    mesh = make_mesh(n_map=n_dev, n_data=1)
    sess = ShardedSlamSession(mesh=mesh, ekf_params=ep, ransac_params=rp,
                              seed=3, update_path=update_path)
    carry = sess.init_carry(first_odom=traj.odom[0])
    D = carry.filt.P.shape[0]

    odom = jnp.asarray(traj.odom[1], jnp.float32)
    rng = jnp.asarray(traj.ranges[1], jnp.float32)
    beams = jnp.asarray(traj.beam_angles, jnp.float32)

    lowered = sess._step.lower(carry, odom, rng, beams)
    compiled = lowered.compile()
    hlo = compiled.as_text()
    coll, counts = collective_bytes(hlo)
    ca = compiled.cost_analysis()
    if isinstance(ca, list):       # older jax returns [dict]
        ca = ca[0]
    flops = float(ca.get("flops", -1.0)) if ca else -1.0

    # wall-clock per tick (virtual mesh: relative numbers only)
    carry2, _ = sess.step(carry, odom, rng, beams)
    jax.block_until_ready(carry2.filt.P)
    t0 = time.perf_counter()
    reps = max(2, ticks)
    c = carry
    for i in range(reps):
        c, _ = sess.step(c, odom, rng, beams)
    jax.block_until_ready(c.filt.P)
    dt = (time.perf_counter() - t0) / reps

    return {
        "n_devices": n_dev,
        "update_path": update_path,
        "D_padded": int(D),
        "p_bytes_per_device": int(D * D * 4 / n_dev),
        "flops_per_tick": flops,
        "collective_bytes_per_tick": coll,
        "collective_counts": counts,
        "collective_total_bytes": int(sum(coll.values())),
        "wall_ms_per_tick_virtual": round(dt * 1e3, 3),
    }


def analyze_update_batch(n_dev: int, K: int, M: int):
    """Collective audit of the BIG-BATCH joint update alone (the bench
    path): explicit shard_map vs GSPMD-derived, same row-sharded P."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ekf_slam_tpu.config import EKFParams
    from ekf_slam_tpu.models.batched import update_batch
    from ekf_slam_tpu.parallel.mesh import make_mesh
    from ekf_slam_tpu.parallel.shard_update import sharded_update_batch
    from ekf_slam_tpu.state import init_state

    params = EKFParams(capacity=K, association="ml", s_cost=1e6,
                       s_thresh=1e12, ref_compat=False, dtype=jnp.float32,
                       masked_writes=True)
    mesh = make_mesh(n_map=n_dev, n_data=1)
    st = init_state(params, pad_to_multiple_of=8 * n_dev)
    D = st.dim
    rng = np.random.default_rng(0)
    x = np.zeros(D, np.float32)
    x[3:3 + 2 * K] = rng.uniform(-40, 40, 2 * K)
    st = st._replace(
        x=jnp.asarray(x),
        P=jax.device_put(jnp.asarray(0.05 * np.eye(D, dtype=np.float32)),
                         NamedSharding(mesh, P("map", None))),
        sig=jnp.arange(1, K + 1, dtype=jnp.float32),
        active=jnp.ones(K, bool),
        n_active=jnp.asarray(K, jnp.int32))
    idx = rng.integers(0, K, M)
    zs = jnp.asarray(np.stack([rng.uniform(1, 5, M),
                               rng.uniform(0, 360, M),
                               (idx + 1).astype(np.float32)], -1))
    Rs = jnp.asarray(np.tile(np.diag([0.3, 2.0]).astype(np.float32),
                             (M, 1, 1)))
    slots = jnp.asarray(idx, jnp.int32)
    valid = jnp.ones(M, bool)

    out = {"n_devices": n_dev, "K": K, "M": M, "D_padded": int(D),
           "PHt_bytes": int(D * 2 * M * 4)}
    f1 = jax.jit(lambda s: sharded_update_batch(s, zs, slots, Rs, valid,
                                                params, mesh))
    b1, c1 = collective_bytes(f1.lower(st).compile().as_text())

    # round 4: the distributed SYRK correction — one W all-gather (same
    # O(D·M) as PHt's) plus the systolic mirror-exchange ppermutes
    # (O(D²/2n) per device); the audit prices that trade explicitly
    import dataclasses
    p_syrk = dataclasses.replace(params, correction="syrk")
    f3 = jax.jit(lambda s: sharded_update_batch(s, zs, slots, Rs, valid,
                                                p_syrk, mesh))
    b3, c3 = collective_bytes(f3.lower(st).compile().as_text())
    out["shard_map_syrk"] = {"bytes": b3, "counts": c3,
                             "total": int(sum(b3.values()))}

    def g(s):
        o = update_batch(s, zs, slots, Rs, valid, params)
        return o._replace(P=jax.lax.with_sharding_constraint(
            o.P, NamedSharding(mesh, P("map", None))))
    b2, c2 = collective_bytes(jax.jit(g).lower(st).compile().as_text())
    out["shard_map"] = {"bytes": b1, "counts": c1,
                        "total": int(sum(b1.values()))}
    out["gspmd"] = {"bytes": b2, "counts": c2,
                    "total": int(sum(b2.values()))}

    # round 4: the sharded square-root (Andrews) update — psum-only
    from ekf_slam_tpu.models.srekf import factor_from_state
    from ekf_slam_tpu.parallel.shard_update import sr_update_sharded
    p_sr = dataclasses.replace(params, update_mode="srekf_fast",
                               masked_writes=False, sr_noise_buffer=8)
    st_sr = init_state(p_sr, pad_to_multiple_of=8 * n_dev,
                       extra_dims=p_sr.sr_noise_buffer)
    st_sr = st_sr._replace(
        x=jnp.zeros((st_sr.dim,), jnp.float32).at[:D].set(st.x),
        sig=st.sig, active=st.active, n_active=st.n_active)
    st_sr = factor_from_state(st_sr)
    st_sr = st_sr._replace(P=jax.device_put(
        st_sr.P, NamedSharding(mesh, P("map", None))))
    f4 = jax.jit(lambda s: sr_update_sharded(s, zs, slots, Rs, valid,
                                             p_sr, mesh))
    b4, c4 = collective_bytes(f4.lower(st_sr).compile().as_text())
    out["shard_map_sr"] = {"bytes": b4, "counts": c4,
                           "total": int(sum(b4.values()))}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--capacity", type=int, default=256)
    ap.add_argument("--ticks", type=int, default=8)
    ap.add_argument("--devices", type=int, nargs="*", default=[2, 4, 8])
    ap.add_argument("--update-batch", action="store_true",
                    help="audit the big-batch joint update instead of the "
                         "session tick (SCALING.md §2)")
    ap.add_argument("--batch", type=int, default=256)
    args = ap.parse_args()

    import os
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=8")
    import jax
    jax.config.update("jax_platforms", "cpu")

    rows = []
    if args.update_batch:
        for n in args.devices:
            r = analyze_update_batch(n, args.capacity, args.batch)
            rows.append(r)
            print(f"[scaling] upd n={n}: shard_map "
                  f"{r['shard_map']['total']/1e6:.2f} MB vs gspmd "
                  f"{r['gspmd']['total']/1e6:.2f} MB "
                  f"(PHt={r['PHt_bytes']/1e6:.2f} MB)", file=sys.stderr)
    else:
        for n in args.devices:
            for path in ("gspmd", "shard_map"):
                r = analyze(n, path, args.capacity, args.ticks)
                rows.append(r)
                print(f"[scaling] n={n} {path}: "
                      f"coll={r['collective_total_bytes']/1e6:.2f} MB/tick "
                      f"{r['collective_counts']} "
                      f"wall={r['wall_ms_per_tick_virtual']} ms",
                      file=sys.stderr)
    print(json.dumps({"capacity": args.capacity, "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
