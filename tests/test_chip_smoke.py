"""chip_smoke.py on the CPU: every phase at a tiny size through its phase
function (the card runs the same functions at full size), the refusal
without a GPU, and the exact last line of a passing run."""
import json
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke  # noqa: E402

TINY = chip_smoke.TINY


def test_phase_pipeline_campaign_tiny():
    out = chip_smoke.phase_campaign(TINY)
    assert out["finite"] and 0 < out["landmarks"] <= TINY.campaign_capacity
    assert out["ate_slam_aligned_m"] < out["ate_odom_m"]


def test_phase_pipeline_flagship_tiny():
    out = chip_smoke.phase_flagship(TINY)
    assert out["finite"] and out["landmarks"] > 0
    assert out["ticks"] == TINY.flagship_ticks


def test_phase_update_tiny():
    out = chip_smoke.phase_update(TINY)
    for name in ("bf16_syrk", "f32_gemm_default", "f32_gemm_highest"):
        assert out[name]["slots_identical"] and out[name]["finite"]
    assert out["f32_gemm_highest"]["rel_max_dP"] <= 1e-3
    assert out["step_temp_bytes"] >= 0


def test_phase_sqrt_tiny():
    out = chip_smoke.phase_sqrt(TINY)
    assert out["slots_identical"]
    for name in ("sr_update_chunked", "sr_update_panel"):
        assert out[name]["finite"] and out[name]["rel_max_dP"] <= 2e-3


def test_phase_stream_tiny():
    out = chip_smoke.phase_stream(TINY)
    assert out["returned"] == out["pushed"] == TINY.flagship_ticks
    assert out["max_dpose_m"] <= 1e-5


def test_phase_parity_tiny():
    out = chip_smoke.phase_parity(TINY)
    assert out["landmarks_device"] == out["landmarks_oracle"] > 0


def test_phase_four_on_virtual_devices():
    """--four's paths on 4 of the suite's 8 virtual CPU devices."""
    out = chip_smoke.phase_four(TINY, n=4)
    for name in ("gspmd", "shard_map", "shard_map_syrk", "srekf_fast"):
        assert out[name]["shards"] == 4
        assert out[name]["landmarks"][0] == out[name]["landmarks"][1] > 0
    assert out["fleet"]["shards"] == 4


def test_main_refuses_without_gpu(capsys):
    rc = chip_smoke.main([])
    out = capsys.readouterr()
    assert rc != 0
    assert '"ok": true' not in out.out and '"ok": true' not in out.err


def test_result_line_has_exactly_the_contract_keys():
    line = chip_smoke.result_line(
        {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
         "extra": "dropped"})
    rec = json.loads(line)
    assert rec == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line


@pytest.mark.gpu
def test_flagship_pipeline_on_the_card(gpu):
    """The flagship pipeline at full size on the card (skips elsewhere)."""
    out = chip_smoke.phase_flagship(chip_smoke.Sizes())
    assert out["finite"] and out["landmarks"] > 0
