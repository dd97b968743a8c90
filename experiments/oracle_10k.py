"""Measure the REAL dense-oracle update cost at 10k landmarks — once.

The bench's 10k ``vs_baseline`` previously rested on a pure asymptotic
extrapolation from the 1k oracle (bench.py round-2).  One full oracle
update at K=10k costs ~2.4e13 f64 FLOPs (K·2D² correspond + 2D³ update,
D=20003) ≈ 10-30 minutes on a 2-core host — far too slow for the
driver's bench run, but affordable exactly once offline.  This script
times ``n`` real updates (gate + dense Kalman update, the same op bench.py
counts) and writes the artifact ``experiments/results/oracle_10k.json``;
bench.py uses the artifact as the measured 10k baseline and prints the
extrapolation as a cross-check.

Run: ``python -m experiments.oracle_10k [K] [n]`` from the repo root.
"""
from __future__ import annotations

import json
import os
import platform
import sys
import time

import numpy as np

from ekf_slam_tpu.oracle.np_ekf import NumpyEKFSLAM


def measure(k: int, n: int) -> dict:
    rng = np.random.default_rng(0)
    oracle = NumpyEKFSLAM(association="ml", s_cost=1e6, s_thresh=1e12)
    lm = rng.uniform(-40, 40, (k, 2))
    oracle.x = np.zeros(3 + 2 * k)
    oracle.x[3:] = lm.reshape(-1)
    D = len(oracle.x)
    A = rng.normal(0, 1, (D, 8)) / np.sqrt(D)
    oracle.P = 0.05 * np.eye(D) + 0.02 * (A @ A.T)
    oracle.s = np.arange(1, k + 1, dtype=float)

    idx = rng.integers(0, k, n)
    delta = lm[idx] - oracle.x[:2]
    r = np.hypot(delta[:, 0], delta[:, 1])
    b = np.mod(np.rad2deg(np.arctan2(delta[:, 1], delta[:, 0]))
               - oracle.x[2], 360.0)
    zs = np.stack([r, b, (idx + 1).astype(float)], axis=-1)

    times, t_gate, t_upd = [], [], []
    for i, z in enumerate(zs):
        R = np.diag([z[0] * 0.1, z[1] * 5.0])
        t0 = time.perf_counter()
        is_new, kk = oracle.correspond(z, R)
        t1 = time.perf_counter()
        oracle.update(z, kk if not is_new else int(z[2]) - 1, R)
        t2 = time.perf_counter()
        times.append(t2 - t0)
        t_gate.append(t1 - t0)
        t_upd.append(t2 - t1)
        print(f"[oracle_10k] update {i + 1}/{n}: gate {t1 - t0:.1f}s + "
              f"update {t2 - t1:.1f}s = {t2 - t0:.1f}s", flush=True)
    med = float(np.median(times))
    return {
        "k_landmarks": k,
        "n_updates": n,
        "median_seconds_per_update": med,
        "updates_per_sec": 1.0 / med,
        "gate_seconds_median": float(np.median(t_gate)),
        "update_seconds_median": float(np.median(t_upd)),
        "all_seconds": [round(t, 3) for t in times],
        "host": platform.node(),
        "cpu_count": os.cpu_count(),
        "numpy": np.__version__,
    }


def main():
    k = int(sys.argv[1]) if len(sys.argv) > 1 else 10000
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    out = measure(k, n)
    path = os.path.join(os.path.dirname(__file__), "results",
                        f"oracle_{k // 1000}k.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    print(f"[oracle_10k] wrote {path}", flush=True)


if __name__ == "__main__":
    main()
