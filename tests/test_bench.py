"""bench.py driver contract: ONE JSON line on stdout with the required
keys and the device it ran on, regardless of platform."""
import json
import os
import subprocess
import sys

REPO = os.path.join(os.path.dirname(__file__), "..")


def test_bench_emits_one_json_line_with_contract_keys():
    env = dict(os.environ,
               BENCH_K="1000", BENCH_FRAMES="0", BENCH_BATCH="4",
               BENCH_CHUNKS="1",
               JAX_PLATFORMS="cpu")
    code = ("import jax; jax.config.update('jax_platforms','cpu');"
            "import bench; bench.main()")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=1500)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [l for l in out.stdout.strip().splitlines() if l.strip()]
    assert len(lines) == 1, out.stdout
    rec = json.loads(lines[0])
    for key in ("metric", "value", "unit", "vs_baseline"):
        assert key in rec, rec
    assert rec["unit"] == "updates/s"
    assert rec["value"] > 0 and rec["vs_baseline"] > 0
    assert rec["metric"] == "ekf_updates_per_sec_chip_1000_landmarks"
    assert isinstance(rec.get("extra", {}), dict)
    # the spread of the in-invocation repetitions ships with the headline
    assert "spread_pct_1k" in rec["extra"], rec
    assert rec["extra"]["spread_pct_1k"] >= 0
    # every result names the device it ran on
    assert rec["extra"]["platform"] == "cpu"
    assert rec["extra"]["device_kind"] and rec["extra"]["device_count"] >= 1
