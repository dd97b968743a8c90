"""Two-process multi-host CPU test.

Everything else in the suite runs collectives inside ONE process on a
virtual mesh; this spawns 2 REAL processes (jax.distributed + gloo),
each owning 4 virtual CPU devices, builds the 8-device global mesh
across the process boundary, and runs the sharded session paths
(shard_map batched, shard_map + distributed SYRK, sharded srekf_fast)
against the unsharded single-process reference inside each worker
(tests/multihost_worker.py).

Skips when the environment can't initialize jax.distributed (worker
exit code 3) or the coordination handshake never completes.

Evidence pinning: because those skips are
silent-green in a summary line, a PASSING run writes a small artifact
(experiments/results/multihost_ran.json) recording that the two
processes really executed and verified all three sharded paths — the
recorded artifact is the proof a given suite run exercised the real
cross-process collectives rather than soft-skipping.
"""
import datetime
import json
import os
import socket
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_sharded_session():
    port = str(_free_port())
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)          # worker sets its own device count
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(i), "2", port],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for i in range(2)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.skip("multi-process coordination did not complete")
    rcs = [p.returncode for p in procs]
    if any(rc == 3 for rc in rcs):
        pytest.skip(f"jax.distributed unsupported here:\n{outs[0][-800:]}")
    assert rcs == [0, 0], (
        f"worker rcs {rcs}\n--- worker 0 ---\n{outs[0][-2000:]}"
        f"\n--- worker 1 ---\n{outs[1][-2000:]}")
    # both workers verified all three sharded paths
    for o in outs:
        assert o.count("-> ok") >= 3, o[-2000:]
    # pin the evidence: record that this run EXECUTED (not skipped)
    results = os.path.join(os.path.dirname(HERE), "experiments", "results")
    try:
        os.makedirs(results, exist_ok=True)
        with open(os.path.join(results, "multihost_ran.json"), "w") as f:
            json.dump({
                "ran_utc": datetime.datetime.now(
                    datetime.timezone.utc).isoformat(timespec="seconds"),
                "workers": 2,
                "returncodes": rcs,
                "paths_verified_per_worker": [o.count("-> ok")
                                              for o in outs],
            }, f, indent=1)
            f.write("\n")
    except OSError:
        pass                  # read-only checkout: the assert above stands
