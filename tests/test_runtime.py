"""utils/runtime: the compile-cache location and the device report."""
import os

import jax
import pytest

from ekf_slam_tpu.utils import runtime


def test_cache_dir_follows_env_var(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.compile_cache_dir() == str(tmp_path)
    before = jax.config.jax_compilation_cache_dir
    assert runtime.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself: nothing else is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_defaults_to_fixed_checkout_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    a, b = runtime.compile_cache_dir(), runtime.compile_cache_dir()
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert a == b == os.path.join(checkout, ".jax_cache")


def test_device_report_names_platform_kind_count():
    rep = runtime.device_report()
    assert rep == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())}
    assert rep["count"] == 8              # conftest's virtual devices


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        runtime.require_gpu()
    gpu = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    assert runtime.require_gpu(gpu) is gpu
