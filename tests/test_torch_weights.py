"""The port's checkpoint converters against the JAX package's.

1. Tiny SD1.5 and SDXL single files written by the JAX package's
   `synthesize_checkpoint` load through both loaders; every tensor of the
   port's UNet and text encoders equals the JAX one after the layout
   transpose (exactly: float32 both sides, transposes are exact).
2. The port's converters run on meta tensors over the real checkpoints' key
   inventories (tests/golden/ldm_{sd15,sdxl}_inventory.json, as
   tests/test_checkpoint_inventory.py runs the JAX ones): every key is
   consumed, and the trees equal the port's init trees in structure and shape.
"""

import json
import os

import numpy as np
import pytest
import torch

from sd_lora_trainer_tpu.models import weights as jw
from sd_lora_trainer_tpu.models.synthesize import (
    TINY_CLIP_G_CONFIG, TINY_CLIP_L_CONFIG, TINY_VAE_CONFIG, synthesize_checkpoint,
)
from sd_lora_trainer_tpu.models.unet import TINY_SD15_UNET_CONFIG, TINY_SDXL_UNET_CONFIG
from sd_lora_trainer_tpu_torch.interop import from_jax_params
from sd_lora_trainer_tpu_torch.models import clip as tc
from sd_lora_trainer_tpu_torch.models import unet as tu
from sd_lora_trainer_tpu_torch.models import weights as tw
from sd_lora_trainer_tpu_torch.models.lora import UNET_TARGETS, create_lora_params, iter_lora_leaves

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _flat(tree, prefix=""):
    """{dotted path: tensor} of a nested dict/list tree."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = tree
    return out


def _assert_same_tensors(port_tree, jax_tree):
    pt, jt = _flat(port_tree), _flat(from_jax_params(jax_tree, device="cpu"))
    assert sorted(pt) == sorted(jt)
    for k in pt:
        assert pt[k].shape == jt[k].shape, k
        np.testing.assert_array_equal(pt[k].numpy(), jt[k].numpy(), err_msg=k)


@pytest.mark.parametrize("version", ["sd15", "sdxl"])
def test_synthesized_checkpoint_converts_like_jax(version, tmp_path):
    jcfg = TINY_SDXL_UNET_CONFIG if version == "sdxl" else TINY_SD15_UNET_CONFIG
    path = str(tmp_path / f"tiny_{version}.safetensors")
    synthesize_checkpoint(path, version, jcfg, TINY_VAE_CONFIG, TINY_CLIP_L_CONFIG,
                          TINY_CLIP_G_CONFIG if version == "sdxl" else None, seed=0)
    import jax.numpy as jnp

    jm = jw.load_models_from_checkpoint(path, dtype=jnp.float32)
    tm = tw.load_models_from_checkpoint(
        path, dtype=torch.float32, device="cpu", unet_config=tu.UNetConfig(**jcfg.__dict__),
        clip_l_config=tc.TINY_CLIP_L_CONFIG,
        clip_g_config=tc.TINY_CLIP_G_CONFIG if version == "sdxl" else None,
    )
    assert tm.version == jm.version == version
    _assert_same_tensors(tm.unet, jm.unet)
    _assert_same_tensors(tm.text_encoder, jm.text_encoder)
    if version == "sdxl":
        _assert_same_tensors(tm.text_encoder_2, jm.text_encoder_2)
    assert tm.vae_state_dict and all(k.startswith(("encoder.", "decoder.", "quant", "post"))
                                     for k in tm.vae_state_dict)


def _meta_inventory(version):
    with open(os.path.join(GOLDEN, f"ldm_{version}_inventory.json")) as f:
        inv = json.load(f)
    return {k: torch.empty(tuple(v["shape"]), device="meta") for k, v in inv.items()}


def _shapes(tree):
    return {k: tuple(v.shape) for k, v in _flat(tree).items()}


@pytest.mark.parametrize("version", ["sd15", "sdxl"])
def test_converters_consume_the_real_inventory(version):
    sd = _meta_inventory(version)
    assert tw.detect_version(sd.keys()) == version
    ucfg = tu.SDXL_UNET_CONFIG if version == "sdxl" else tu.SD15_UNET_CONFIG
    unet = tw.convert_ldm_unet(tw._take_prefix(sd, tw.UNET_PREFIX), ucfg, device="meta")
    assert _shapes(unet) == _shapes(tu.init_unet_params(ucfg, None, device="meta"))
    prefix = tw.CLIP_SDXL_L_PREFIX if version == "sdxl" else tw.CLIP_SD15_PREFIX
    clip_l = tw.convert_hf_clip(tw._take_prefix(sd, prefix), tc.CLIP_L_CONFIG, device="meta")
    assert _shapes(clip_l) == _shapes(tc.init_clip_params(tc.CLIP_L_CONFIG, None, device="meta"))
    if version == "sdxl":
        clip_g = tw.convert_openclip(tw._take_prefix(sd, tw.CLIP_SDXL_G_PREFIX),
                                     tc.CLIP_BIG_G_CONFIG, device="meta")
        assert _shapes(clip_g) == _shapes(
            tc.init_clip_params(tc.CLIP_BIG_G_CONFIG, None, device="meta"))
        # 577 LoRA sites at the default targets on the SDXL UNet
        lora = create_lora_params(unet, 16, None, targets=UNET_TARGETS)
        assert len(list(iter_lora_leaves(lora))) == 577


def test_missing_and_extra_keys_fail_loud():
    family = tw._take_prefix(_meta_inventory("sdxl"), tw.UNET_PREFIX)
    missing = dict(family)
    missing.pop("middle_block.1.transformer_blocks.9.attn2.to_k.weight")
    with pytest.raises(KeyError, match="to_k"):
        tw.convert_ldm_unet(missing, tu.SDXL_UNET_CONFIG, device="meta")
    extra = dict(family)
    extra["middle_block.1.transformer_blocks.10.attn1.to_q.weight"] = torch.empty(
        1280, 1280, device="meta")
    with pytest.raises(ValueError, match="unconsumed"):
        tw.convert_ldm_unet(extra, tu.SDXL_UNET_CONFIG, device="meta")
