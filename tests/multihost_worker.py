"""Worker process for the two-process multi-host CPU test.

Each of the 2 processes owns 4 virtual CPU devices; the global mesh
spans all 8 across the process boundary (jax.distributed + gloo
collectives).  The worker runs the ShardedSlamSession (both the
explicit-collective shard_map update and the distributed square-root
path) for T ticks and checks the trajectory against the UNSHARDED
single-process session computed locally — real cross-host collectives,
same math.

Exit codes: 0 = pass, 1 = parity failure, 3 = environment unsupported
(jax.distributed / gloo unavailable) — the pytest wrapper skips on 3.
"""
import os
import sys

# repo root + tests dir on the path
_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))
sys.path.insert(0, _HERE)


def main():
    pid = int(sys.argv[1])
    nproc = int(sys.argv[2])
    port = sys.argv[3]
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    try:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
        jax.distributed.initialize(
            coordinator_address=f"localhost:{port}",
            num_processes=nproc, process_id=pid,
            initialization_timeout=60)
    except Exception as e:  # pragma: no cover - environment-dependent
        print(f"[worker {pid}] unsupported: {e!r}", flush=True)
        sys.exit(3)

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from ekf_slam_tpu.config import EKFParams
    from ekf_slam_tpu.parallel.sharded import ShardedSlamSession
    from ekf_slam_tpu.session import SlamSession
    from test_sim_session import SIM_RANSAC, make_traj

    assert len(jax.devices()) == 4 * nproc, "global device count"
    assert len(jax.local_devices()) == 4, "local device count"
    mesh = Mesh(np.asarray(jax.devices()).reshape(-1), ("map",))

    traj, _ = make_traj(T=25, n_beams=720)   # 720 beams: enough inliers
    # for wall promotion (the 60-point consensus, tests/test_sim_session)
    odom = np.asarray(traj.odom)
    rngs = np.asarray(traj.ranges)
    beams = np.asarray(traj.beam_angles)

    failures = []
    configs = [
        ("shard_map", EKFParams(capacity=16, max_obs=8, ref_compat=False,
                                dtype=jnp.float64,
                                update_mode="batched")),
        ("shard_map_syrk", EKFParams(capacity=16, max_obs=8,
                                     ref_compat=False, dtype=jnp.float64,
                                     update_mode="batched",
                                     correction="syrk")),
        ("srekf_fast", EKFParams(capacity=16, max_obs=8, ref_compat=False,
                                 dtype=jnp.float64,
                                 update_mode="srekf_fast",
                                 sr_noise_buffer=4)),
    ]
    for name, ep in configs:
        # unsharded single-process reference, computed locally
        ref = SlamSession(ekf_params=ep, ransac_params=SIM_RANSAC, seed=5)
        c_ref, o_ref = ref.run(odom, rngs, beams)

        sh = ShardedSlamSession(mesh=mesh, ekf_params=ep,
                                ransac_params=SIM_RANSAC, seed=5,
                                update_path="shard_map")
        carry = sh.init_carry(first_odom=odom[0])
        poses = []
        for t in range(odom.shape[0]):
            carry, out = sh.step(carry, odom[t], rngs[t], beams)
            poses.append(np.asarray(out.pose))   # replicated → local read
        poses = np.stack(poses)
        ref_poses = np.asarray(o_ref.pose)
        err = float(np.abs(poses - ref_poses).max())
        n_ref = int(c_ref.filt.n_active)
        n_sh = int(carry.filt.n_active)
        ok = err < 1e-7 and n_ref == n_sh and n_ref >= 1
        print(f"[worker {pid}] {name}: max|Δpose|={err:.2e} "
              f"landmarks {n_sh}/{n_ref} -> {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            failures.append(name)

    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
