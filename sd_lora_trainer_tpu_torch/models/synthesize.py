"""Synthetic single-file checkpoints for tests, offline runs and the card.

Counterpart of sd_lora_trainer_tpu/models/synthesize.py: random weights
from a seed under the exact LDM key layout, at tiny or full widths, with the
model configs embedded in the file's metadata under the key
"sd_lora_trainer_tpu" (the JAX package's key), so either package's loader
rebuilds a tiny topology from the file alone, and a file either package
writes loads in the other. `dtype` is the file's float type (the released
SDXL checkpoints are fp16).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional

import torch

from sd_lora_trainer_tpu_torch.models.clip import CLIPTextConfig, init_clip_params
from sd_lora_trainer_tpu_torch.models.unet import TINY_SDXL_UNET_CONFIG, UNetConfig, init_unet_params
from sd_lora_trainer_tpu_torch.models.vae import VAEConfig, init_vae_params
from sd_lora_trainer_tpu_torch.models.weights import (
    CLIP_SD15_PREFIX,
    CLIP_SDXL_G_PREFIX,
    CLIP_SDXL_L_PREFIX,
    EMBEDDED_CONFIG_KEY,
    UNET_PREFIX,
    VAE_PREFIX,
    export_ldm_unet,
)
from sd_lora_trainer_tpu_torch.utils.safetensors_io import save_safetensors

# the JAX package's tiny family configs (tests, offline end-to-end runs)
TINY_CLIP_L_CONFIG = CLIPTextConfig(
    vocab_size=256, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
    max_position_embeddings=77, eos_token_id=255,
)
TINY_CLIP_G_CONFIG = CLIPTextConfig(
    vocab_size=256, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
    max_position_embeddings=77, eos_token_id=255, hidden_act="gelu", projection_dim=32,
)
TINY_VAE_CONFIG = VAEConfig(block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4)
# the tiny SDXL UNet widened to head dim 64 at every level: on the card its
# self-attention (>= 256 tokens) takes the flash kernels, which are built
# for head dims 40, 64, 80 and 160; the tiny UNet's 32 has no kernel there
TINY_FLASH_SDXL_UNET_CONFIG = dataclasses.replace(TINY_SDXL_UNET_CONFIG,
                                                  block_out_channels=(64, 128, 128))


def export_ldm_vae(params: dict, cfg: VAEConfig, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """A VAE tree -> its CompVis state dict (inverse of convert_ldm_vae)."""
    out: Dict[str, torch.Tensor] = {}

    def put(key, p, as_conv=False):  # conv and norm dicts share {"weight", "bias"}
        w = p["weight"].detach().to(dtype)
        out[f"{key}.weight"] = w[:, :, None, None] if as_conv else w
        out[f"{key}.bias"] = p["bias"].detach().to(dtype)

    def put_resnet(base, p):
        for name in ("norm1", "conv1", "norm2", "conv2"):
            put(f"{base}.{name}", p[name])
        if "conv_shortcut" in p:
            put(f"{base}.nin_shortcut", p["conv_shortcut"])

    def put_attn(base, p):
        put(f"{base}.norm", p["group_norm"])
        for key, name in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"), ("proj_out", "to_out")):
            put(f"{base}.{key}", p[name], as_conv=True)

    n = len(cfg.block_out_channels)
    enc = params["encoder"]
    put("encoder.conv_in", enc["conv_in"])
    for i, block in enumerate(enc["down_blocks"]):
        for j, rp in enumerate(block["resnets"]):
            put_resnet(f"encoder.down.{i}.block.{j}", rp)
        if "downsamplers" in block:
            put(f"encoder.down.{i}.downsample.conv", block["downsamplers"][0]["conv"])
    put_resnet("encoder.mid.block_1", enc["mid_block"]["resnets"][0])
    put_attn("encoder.mid.attn_1", enc["mid_block"]["attentions"][0])
    put_resnet("encoder.mid.block_2", enc["mid_block"]["resnets"][1])
    put("encoder.norm_out", enc["conv_norm_out"])
    put("encoder.conv_out", enc["conv_out"])

    dec = params["decoder"]
    put("decoder.conv_in", dec["conv_in"])
    put_resnet("decoder.mid.block_1", dec["mid_block"]["resnets"][0])
    put_attn("decoder.mid.attn_1", dec["mid_block"]["attentions"][0])
    put_resnet("decoder.mid.block_2", dec["mid_block"]["resnets"][1])
    for i, block in enumerate(dec["up_blocks"]):
        ldm_i = n - 1 - i
        for j, rp in enumerate(block["resnets"]):
            put_resnet(f"decoder.up.{ldm_i}.block.{j}", rp)
        if "upsamplers" in block:
            put(f"decoder.up.{ldm_i}.upsample.conv", block["upsamplers"][0]["conv"])
    put("decoder.norm_out", dec["conv_norm_out"])
    put("decoder.conv_out", dec["conv_out"])
    put("quant_conv", params["quant_conv"])
    put("post_quant_conv", params["post_quant_conv"])
    return out


def export_hf_clip(params: dict, cfg: CLIPTextConfig, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """A text-encoder tree -> a transformers CLIPTextModel state dict."""
    out: Dict[str, torch.Tensor] = {}

    def put(key, p):
        out[f"{key}.weight"] = p["weight"].detach().to(dtype)
        if "bias" in p:
            out[f"{key}.bias"] = p["bias"].detach().to(dtype)

    tm = params["text_model"]
    for name in ("token_embedding", "position_embedding"):
        put(f"text_model.embeddings.{name}", tm["embeddings"][name])
    for i, layer in enumerate(tm["encoder"]["layers"]):
        b = f"text_model.encoder.layers.{i}"
        put(f"{b}.layer_norm1", layer["layer_norm1"])
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            put(f"{b}.self_attn.{proj}", layer["self_attn"][proj])
        put(f"{b}.layer_norm2", layer["layer_norm2"])
        put(f"{b}.mlp.fc1", layer["mlp"]["fc1"])
        put(f"{b}.mlp.fc2", layer["mlp"]["fc2"])
    put("text_model.final_layer_norm", tm["final_layer_norm"])
    if "text_projection" in params:
        put("text_projection", params["text_projection"])
    return out


def export_openclip(params: dict, cfg: CLIPTextConfig, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """A text-encoder tree -> an OpenCLIP text-tower state dict (q, k, v
    fused into in_proj; text_projection the raw [D, P] matrix)."""
    out: Dict[str, torch.Tensor] = {}

    def t(x):
        return x.detach().to(dtype)

    tm = params["text_model"]
    out["token_embedding.weight"] = t(tm["embeddings"]["token_embedding"]["weight"])
    out["positional_embedding"] = t(tm["embeddings"]["position_embedding"]["weight"])
    for i, layer in enumerate(tm["encoder"]["layers"]):
        b = f"transformer.resblocks.{i}"
        sa = layer["self_attn"]
        qkv = ("q_proj", "k_proj", "v_proj")
        out[f"{b}.attn.in_proj_weight"] = torch.cat([t(sa[p]["weight"]) for p in qkv])
        out[f"{b}.attn.in_proj_bias"] = torch.cat([t(sa[p]["bias"]) for p in qkv])
        for key, p in ((f"{b}.attn.out_proj", sa["out_proj"]), (f"{b}.ln_1", layer["layer_norm1"]),
                       (f"{b}.ln_2", layer["layer_norm2"]), (f"{b}.mlp.c_fc", layer["mlp"]["fc1"]),
                       (f"{b}.mlp.c_proj", layer["mlp"]["fc2"])):
            out[f"{key}.weight"] = t(p["weight"])
            out[f"{key}.bias"] = t(p["bias"])
    out["ln_final.weight"] = t(tm["final_layer_norm"]["weight"])
    out["ln_final.bias"] = t(tm["final_layer_norm"]["bias"])
    out["text_projection"] = t(params["text_projection"]["weight"]).t().contiguous()
    return out


def synthesize_checkpoint(
    path: str,
    version: str,
    unet_cfg: UNetConfig,
    vae_cfg: VAEConfig,
    clip_l_cfg: CLIPTextConfig,
    clip_g_cfg: Optional[CLIPTextConfig] = None,
    seed: int = 0,
    dtype=torch.float32,
    device="cuda",
) -> None:
    """Write a random single-file checkpoint with the exact LDM key layout.

    The weights are drawn on `device` (the card, for a full-width file) and
    written one tensor at a time."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sd: Dict[str, torch.Tensor] = {}
    unet = init_unet_params(unet_cfg, gen, dtype=dtype, device=device)
    sd.update({UNET_PREFIX + k: v.to(dtype) for k, v in export_ldm_unet(unet, unet_cfg).items()})
    del unet
    vae = init_vae_params(vae_cfg, gen, dtype=dtype, device=device)
    sd.update({VAE_PREFIX + k: v for k, v in export_ldm_vae(vae, vae_cfg, dtype).items()})
    clip_l = init_clip_params(clip_l_cfg, gen, dtype=dtype, device=device)
    l_prefix = CLIP_SDXL_L_PREFIX if version == "sdxl" else CLIP_SD15_PREFIX
    sd.update({l_prefix + k: v for k, v in export_hf_clip(clip_l, clip_l_cfg, dtype).items()})
    if version == "sdxl":
        if clip_g_cfg is None:
            raise ValueError("an SDXL checkpoint needs clip_g_cfg")
        clip_g = init_clip_params(clip_g_cfg, gen, dtype=dtype, device=device)
        sd.update({CLIP_SDXL_G_PREFIX + k: v
                   for k, v in export_openclip(clip_g, clip_g_cfg, dtype).items()})
    metadata = {EMBEDDED_CONFIG_KEY: json.dumps({
        "version": version,
        "unet": dataclasses.asdict(unet_cfg),
        "vae": dataclasses.asdict(vae_cfg),
        "clip_l": dataclasses.asdict(clip_l_cfg),
        "clip_g": dataclasses.asdict(clip_g_cfg) if clip_g_cfg else None,
    })}
    save_safetensors(sd, path, metadata=metadata)
