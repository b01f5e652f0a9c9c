"""The port's TrainingConfig, StepConfig and optimizer groups against the JAX package's.

Every `train_configs/*.json` parses in both packages to the same field values
(the timestamped output dir, the start time and the informational device
aside). Options that belong to later slices of the port raise
NotImplementedError instead of being ignored.
"""

import dataclasses
import glob
import json
import os

import jax.numpy as jnp
import pytest
import torch

from sd_lora_trainer_tpu.config import TrainingConfig as JConfig
from sd_lora_trainer_tpu.training import optimizers as jo
from sd_lora_trainer_tpu_torch.config import TrainingConfig as TConfig
from sd_lora_trainer_tpu_torch.training import optimizers as to
from sd_lora_trainer_tpu_torch.training.step import StepConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "train_configs", "*.json")))
SKIP = {"output_dir", "start_time", "device", "pretrained_model", "seed"}


def test_field_surface_matches_jax():
    jfields = set(JConfig.model_fields)
    tfields = {f.name for f in dataclasses.fields(TConfig)} - {"_testing_no_output_dir"}
    assert jfields == tfields


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_train_configs_parse_like_jax(path):
    with open(path) as f:
        data = json.load(f)
    data = {**data, "seed": 0}
    j = JConfig(**data, _testing_no_output_dir=True)
    t = TConfig.from_dict({**data, "_testing_no_output_dir": True})
    for name in JConfig.model_fields:
        if name not in SKIP:
            assert getattr(t, name) == getattr(j, name), name


def _cfg(**kw):
    return TConfig(**{**dict(lora_training_urls="x", concept_mode="style",
                             sd_model_version="sdxl", _testing_no_output_dir=True), **kw})


@pytest.mark.parametrize("kw", [
    {"remat": "offload:flash_out*"}, {"remat": "offload:flash_out*,flash_lse*"},
    {"remat": "light+offload:flash_out*"}, {"remat": "offload:attn_out*", "quantize_base": "int8"},
    {"remat": "offload:ff_hidden*", "quantize_base": "int8+te"},
    {"remat": "light+offload:flash_out*,flash_lse*", "sd_model_version": "sd15"},
])
def test_later_slice_options_raise(kw):
    """Host offload of named activations (`offload:`) is the one remat plan
    left for a later slice; int8, the named plans and stash8 are ported."""
    with pytest.raises(NotImplementedError, match="later slice"):
        StepConfig.from_config(_cfg(**kw), 1.0)


@pytest.mark.parametrize("kw", [{"unet_optimizer_type": "prodigy"},
                                {"unet_optimizer_type": "AdamW8bit"}, {"ti_optimizer": "prodigy"}])
def test_later_slice_optimizers_raise(kw):
    with pytest.raises(NotImplementedError, match="later slice"):
        to.GroupOptimizer(_cfg(**kw), {"unet": {"x": torch.zeros(2, requires_grad=True)}})


def test_auto_resolves_to_remat_and_no_int8():
    """"auto" resolves as in the JAX package: an int8 base for SDXL LoRA with
    `light+save` keeping the flash residuals; "none" and a bf16 base with the
    flash residuals kept under full remat otherwise (tests/test_torch_step.py
    holds the whole grid against JAX)."""
    sc = StepConfig.from_config(_cfg(), 1.0)
    assert sc.remat == "light+save:flash_out*,flash_lse*" and sc.use_flash
    assert _cfg().resolve_quantize_base() == "int8"
    assert _cfg(quantize_base="none").resolve_quantize_base() == "none"
    sc = StepConfig.from_config(_cfg(quantize_base="none"), 1.0)
    assert sc.remat == "save:flash_out*,flash_lse*" and not sc.remat_te and not sc.stash8
    with pytest.raises(ValueError):
        _cfg(concept_mode="portrait")
    with pytest.raises(ValueError):
        _cfg(quantize_base="int4").resolve_quantize_base()


@pytest.mark.parametrize("kw", [{}, {"disable_ti": True, "freeze_unet_before_completion_f": 0.2},
                                {"txt_encoders_lr_warmup_steps": 0, "max_train_steps": 7}])
def test_lr_schedules_match_jax(kw):
    base = {**dict(lora_training_urls="x", concept_mode="style", sd_model_version="sdxl",
                   max_train_steps=100, _testing_no_output_dir=True), **kw}
    j, t = JConfig(**base), TConfig(**base)
    for name in ("unet_lr_schedule", "ti_lr_schedule", "te_lora_lr_schedule"):
        js, ts = getattr(jo, name)(j), getattr(to, name)(t)
        for step in (0, 1, 5, 50, 69, 71, 99, 100, 130):
            assert ts(step) == pytest.approx(float(js(jnp.asarray(step))), rel=1e-5, abs=1e-12)
