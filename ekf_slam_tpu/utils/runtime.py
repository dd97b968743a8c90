"""Process set-up shared by the entry points: the persistent compile cache
and what the program reports about the device it runs on.

Library code runs on whatever device JAX picks (the tests pin the CPU);
only the on-card smoke test (chip_smoke.py) demands a GPU, through
``require_gpu``.
"""
from __future__ import annotations

import os

import jax

#: the checkout this package was imported from (ekf_slam_tpu/utils/ → ..)
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else the fixed
    ``<checkout>/.jax_cache``.  The path is part of every cache key, so it
    never depends on a temp directory, a pid or the time."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set JAX already reads it, and
    nothing is set here."""
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def device_report() -> dict:
    """``{"platform", "kind", "count"}`` of the devices JAX found."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu(report: dict = None) -> dict:
    """The device report, or RuntimeError unless JAX's devices are GPUs —
    a measurement or smoke path never falls back to the CPU."""
    report = device_report() if report is None else report
    if report["platform"] != "gpu":
        raise RuntimeError(
            f"no GPU: JAX found {report['count']} {report['platform']} "
            f"device(s) ({report['kind']})")
    return report

