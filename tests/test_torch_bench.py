"""The port's bench (sd_lora_trainer_tpu_torch/bench.py) against the JAX
bench's artifact schema.

The real bench code path runs in a subprocess on the CPU with the tiny
configs (BENCH_TINY=1 BENCH_PLATFORM=cpu). Its one stdout line carries
tests/test_bench_schema.py's required top-level and `config` keys and
records the levers as that test asks of the JAX bench; the bucketed run is
`train_throughput_bucketed` with each bucket's s/step; without a card and
without BENCH_PLATFORM=cpu, and on an unknown knob, it prints an error
line and exits 1. No MFU is reported without a known card.
"""

import json
import os
import subprocess
import sys

import pytest

from test_bench_schema import REQUIRED_CONFIG, REQUIRED_TOP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(extra_env, cpu=True):
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", BENCH_RES="64", BENCH_BS="2",
               BENCH_STEPS="2", BENCH_TINY="1")
    if cpu:
        env["BENCH_PLATFORM"] = "cpu"
    env.update(extra_env)
    r = subprocess.run([sys.executable, "-m", "sd_lora_trainer_tpu_torch.bench"], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    lines = [ln for ln in r.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, r.stdout + r.stderr[-3000:]
    return r.returncode, json.loads(lines[0]), r.stderr


def test_bench_json_schema_default():
    rc, out, err = _run({"BENCH_SCAN": "2"})
    assert rc == 0, err[-3000:]
    assert REQUIRED_TOP <= set(out), out
    cfg = out["config"]
    assert REQUIRED_CONFIG <= set(cfg), cfg
    assert (cfg["model"], cfg["resolution"], cfg["batch_size"], cfg["scan_k"]) == ("sdxl", 64, 2, 2)
    assert cfg["baseq"] == "none" and cfg["remat"] == "save:flash_out*,flash_lse*"
    assert cfg["adapter_targets"] == 91 and cfg["lora_rank"] == 16  # tiny SDXL's sites
    assert out["metric"] == "sdxl_lora_train_imgs_per_sec_chip_64px_bs2" and out["unit"] == "imgs/s"
    assert isinstance(out["value"], float) and out["value"] > 0
    assert isinstance(out["vs_baseline"], float)
    assert cfg["device"] == "cpu" and "mfu" not in out  # no card: no peak, no MFU
    assert cfg["flops_per_step"] > 0 and cfg["flops"] == "model, fwd+bwd, remat off"
    assert cfg["timed_steps"] == 2
    assert "per-step s:" in err


def test_bench_json_schema_levers_recorded():
    rc, out, err = _run({"BENCH_SCAN": "1", "BENCH_BASEQ": "int8",
                         "BENCH_REMAT": "save:flash_out*,flash_lse*",
                         "BENCH_STASH8": "flash_out*", "BENCH_FUSE_QKV": "0"})
    assert rc == 0, err[-3000:]
    cfg = out["config"]
    assert cfg["baseq"] == "int8"
    assert cfg["remat"] == "save:flash_out*,flash_lse*"
    assert cfg["stash8"] == "flash_out*"
    assert cfg["fuse_qkv"] is False
    assert cfg["scan_k"] == 1 and cfg["timed_steps"] == 2


@pytest.mark.parametrize("remat,recorded", [("full", True), ("off", False), ("light", "light")])
def test_bench_remat_words(remat, recorded):
    rc, out, err = _run({"BENCH_SCAN": "1", "BENCH_STEPS": "1", "BENCH_REMAT": remat})
    assert rc == 0, err[-3000:]
    assert out["config"]["remat"] == recorded


def test_bench_bucketed_metric():
    rc, out, err = _run({"BENCH_BUCKETS": "64x64,64x128", "BENCH_SCAN": "1"})
    assert rc == 0, err[-3000:]
    assert out["metric"] == "train_throughput_bucketed" and out["unit"] == "imgs/sec/chip"
    assert out["config"]["buckets"] == "64x64,64x128" and "mfu" not in out
    assert set(out["config"]["s_per_step_by_bucket"]) == {"64x64", "64x128"}
    assert out["config"]["timed_steps"] == 2  # at least one call per bucket


@pytest.mark.parametrize("env,cpu,message", [
    ({}, False, "no CUDA device"),
    ({"BENCH_REMAT": "sav:flash_out*"}, True, "unknown BENCH_REMAT"),
    ({"BENCH_BUCKETS": "1000x1024"}, True, "64-px multiples"),
])
def test_bench_refuses_with_an_error_line(env, cpu, message):
    rc, out, err = _run(env, cpu=cpu)
    assert rc == 1
    assert out["value"] is None and message in out["error"]
    assert REQUIRED_TOP - {"config"} <= set(out)


def test_bench_sd15_runs_the_one_encoder_model():
    """BENCH_MODEL=sd15: one text encoder and its TI rows, the SD1.5 UNet's
    LoRA sites, and "auto" resolving to no remat at <= 512px (the JAX
    package's rule, training/step.py)."""
    rc, out, err = _run({"BENCH_MODEL": "sd15", "BENCH_SCAN": "1"})
    assert rc == 0, err[-3000:]
    cfg = out["config"]
    assert REQUIRED_CONFIG <= set(cfg), cfg
    assert out["metric"] == "sd15_lora_train_imgs_per_sec_chip_64px_bs2"
    assert (cfg["model"], cfg["remat"], cfg["timed_steps"]) == ("sd15", False, 2)
    assert cfg["adapter_targets"] == 94  # tiny SD1.5's sites
    assert out["value"] > 0 and cfg["flops_per_step"] > 0
