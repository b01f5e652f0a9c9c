"""Single-file SD checkpoint -> parameter trees.

Counterpart of sd_lora_trainer_tpu/models/weights.py. A single-file
checkpoint is an LDM-layout safetensors with the families

    model.diffusion_model.*                     UNet   (CompVis naming)
    first_stage_model.*                         VAE    (a later slice)
    cond_stage_model.transformer.text_model.*   CLIP-L (SD1.5, HF naming)
    conditioner.embedders.0.transformer.*       CLIP-L (SDXL, HF naming)
    conditioner.embedders.1.model.*             CLIP-G (SDXL, OpenCLIP naming)

Each family converts into the port's trees: the JAX package's diffusers-style
module paths with the checkpoint's own torch layouts (linear (out, in), conv
OIHW), so no tensor is transposed. Every tensor of a family must be consumed
exactly once; leftovers raise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from sd_lora_trainer_tpu_torch.models.clip import CLIP_BIG_G_CONFIG, CLIP_L_CONFIG, CLIPTextConfig
from sd_lora_trainer_tpu_torch.models.unet import SD15_UNET_CONFIG, SDXL_UNET_CONFIG, UNetConfig

UNET_PREFIX = "model.diffusion_model."
VAE_PREFIX = "first_stage_model."
CLIP_SD15_PREFIX = "cond_stage_model.transformer."
CLIP_SDXL_L_PREFIX = "conditioner.embedders.0.transformer."
CLIP_SDXL_G_PREFIX = "conditioner.embedders.1.model."


def detect_version(keys) -> str:
    """'sdxl' | 'sd15' from checkpoint key inspection."""
    for k in keys:
        if k.startswith("conditioner.embedders.1."):
            return "sdxl"
    return "sd15"


def _take_prefix(sd: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


class _KeyConsumer:
    """Wraps a flat state dict; every get pops. Leftovers raise at finish."""

    def __init__(self, sd: dict, family: str, dtype, device=None):
        self.sd = dict(sd)
        self.family = family
        self.dtype = dtype
        self.device = device

    def _get(self, key: str) -> torch.Tensor:
        if key not in self.sd:
            raise KeyError(f"[{self.family}] missing checkpoint key: {key}")
        return self.sd.pop(key).to(device=self.device, dtype=self.dtype)

    def linear(self, key: str, bias: bool = True) -> dict:
        p = {"weight": self._get(f"{key}.weight")}
        if bias:
            p["bias"] = self._get(f"{key}.bias")
        return p

    def conv(self, key: str) -> dict:
        return {"weight": self._get(f"{key}.weight"), "bias": self._get(f"{key}.bias")}

    norm = conv  # {"weight", "bias"}

    def raw(self, key: str) -> torch.Tensor:
        return self._get(key)

    def has(self, key: str) -> bool:
        return key in self.sd

    def drop(self, key: str) -> None:
        self.sd.pop(key, None)

    def finish(self):
        if self.sd:
            leftover = sorted(self.sd.keys())[:10]
            raise ValueError(
                f"[{self.family}] {len(self.sd)} unconsumed checkpoint keys, e.g. {leftover}"
            )


def _ldm_resnet(c: _KeyConsumer, base: str) -> dict:
    p = {
        "norm1": c.norm(f"{base}.in_layers.0"),
        "conv1": c.conv(f"{base}.in_layers.2"),
        "time_emb_proj": c.linear(f"{base}.emb_layers.1"),
        "norm2": c.norm(f"{base}.out_layers.0"),
        "conv2": c.conv(f"{base}.out_layers.3"),
    }
    if c.has(f"{base}.skip_connection.weight"):
        p["conv_shortcut"] = c.conv(f"{base}.skip_connection")
    return p


def _ldm_transformer(c: _KeyConsumer, base: str, cfg: UNetConfig, depth: int) -> dict:
    def attn(b):
        return {
            "to_q": c.linear(f"{b}.to_q", bias=False),
            "to_k": c.linear(f"{b}.to_k", bias=False),
            "to_v": c.linear(f"{b}.to_v", bias=False),
            "to_out.0": c.linear(f"{b}.to_out.0"),
        }

    blocks = []
    for k in range(depth):
        tb = f"{base}.transformer_blocks.{k}"
        blocks.append({
            "norm1": c.norm(f"{tb}.norm1"),
            "attn1": attn(f"{tb}.attn1"),
            "norm2": c.norm(f"{tb}.norm2"),
            "attn2": attn(f"{tb}.attn2"),
            "norm3": c.norm(f"{tb}.norm3"),
            "ff.net.0.proj": c.linear(f"{tb}.ff.net.0.proj"),
            "ff.net.2": c.linear(f"{tb}.ff.net.2"),
        })
    p = {"norm": c.norm(f"{base}.norm"), "transformer_blocks": blocks}
    proj = c.linear if cfg.use_linear_projection else c.conv
    p["proj_in"] = proj(f"{base}.proj_in")
    p["proj_out"] = proj(f"{base}.proj_out")
    return p


def convert_ldm_unet(sd: dict, cfg: UNetConfig, dtype=torch.bfloat16, device=None) -> dict:
    c = _KeyConsumer(sd, "unet", dtype, device)
    n_levels = len(cfg.block_out_channels)
    params = {
        "conv_in": c.conv("input_blocks.0.0"),
        "time_embedding": {
            "linear_1": c.linear("time_embed.0"),
            "linear_2": c.linear("time_embed.2"),
        },
        "conv_norm_out": c.norm("out.0"),
        "conv_out": c.conv("out.2"),
    }
    if cfg.addition_embed_dim is not None:
        params["add_embedding"] = {
            "linear_1": c.linear("label_emb.0.0"),
            "linear_2": c.linear("label_emb.0.2"),
        }

    down_blocks = []
    idx = 1
    for i in range(n_levels):
        block = {"resnets": []}
        if cfg.cross_attention[i]:
            block["attentions"] = []
        for _ in range(cfg.layers_per_block):
            block["resnets"].append(_ldm_resnet(c, f"input_blocks.{idx}.0"))
            if cfg.cross_attention[i]:
                block["attentions"].append(
                    _ldm_transformer(c, f"input_blocks.{idx}.1", cfg, cfg.transformer_layers[i])
                )
            idx += 1
        if i < n_levels - 1:
            block["downsamplers"] = [{"conv": c.conv(f"input_blocks.{idx}.0.op")}]
            idx += 1
        down_blocks.append(block)
    params["down_blocks"] = down_blocks

    params["mid_block"] = {
        "resnets": [_ldm_resnet(c, "middle_block.0"), _ldm_resnet(c, "middle_block.2")],
        "attentions": [_ldm_transformer(c, "middle_block.1", cfg, cfg.mid_transformer_layers)],
    }

    up_blocks = []
    idx = 0
    for i in range(n_levels):
        level = n_levels - 1 - i
        block = {"resnets": []}
        if cfg.cross_attention[level]:
            block["attentions"] = []
        for j in range(cfg.layers_per_block + 1):
            block["resnets"].append(_ldm_resnet(c, f"output_blocks.{idx}.0"))
            module = 1
            if cfg.cross_attention[level]:
                block["attentions"].append(_ldm_transformer(
                    c, f"output_blocks.{idx}.{module}", cfg, cfg.transformer_layers[level]
                ))
                module += 1
            if j == cfg.layers_per_block and i < n_levels - 1:
                block["upsamplers"] = [{"conv": c.conv(f"output_blocks.{idx}.{module}.conv")}]
            idx += 1
        up_blocks.append(block)
    params["up_blocks"] = up_blocks
    c.finish()
    return params


def convert_hf_clip(sd: dict, cfg: CLIPTextConfig, dtype=torch.bfloat16, device=None) -> dict:
    c = _KeyConsumer(sd, "clip_l", dtype, device)
    c.drop("text_model.embeddings.position_ids")  # persisted buffer, not a weight
    layers = []
    for i in range(cfg.num_layers):
        b = f"text_model.encoder.layers.{i}"
        layers.append({
            "layer_norm1": c.norm(f"{b}.layer_norm1"),
            "self_attn": {
                "q_proj": c.linear(f"{b}.self_attn.q_proj"),
                "k_proj": c.linear(f"{b}.self_attn.k_proj"),
                "v_proj": c.linear(f"{b}.self_attn.v_proj"),
                "out_proj": c.linear(f"{b}.self_attn.out_proj"),
            },
            "layer_norm2": c.norm(f"{b}.layer_norm2"),
            "mlp": {"fc1": c.linear(f"{b}.mlp.fc1"), "fc2": c.linear(f"{b}.mlp.fc2")},
        })
    params = {
        "text_model": {
            "embeddings": {
                "token_embedding": {"weight": c.raw("text_model.embeddings.token_embedding.weight")},
                "position_embedding": {
                    "weight": c.raw("text_model.embeddings.position_embedding.weight")
                },
            },
            "encoder": {"layers": layers},
            "final_layer_norm": c.norm("text_model.final_layer_norm"),
        }
    }
    if c.has("text_projection.weight"):
        params["text_projection"] = c.linear("text_projection", bias=False)
    c.finish()
    return params


def convert_openclip(sd: dict, cfg: CLIPTextConfig, dtype=torch.bfloat16, device=None) -> dict:
    """OpenCLIP text tower -> the same tree as convert_hf_clip; the fused
    attn.in_proj splits into q/k/v."""
    c = _KeyConsumer(sd, "clip_g", dtype, device)
    for junk in ("logit_scale", "transformer.text_model.embeddings.position_ids"):
        c.drop(junk)
    d = cfg.hidden_size
    layers = []
    for i in range(cfg.num_layers):
        b = f"transformer.resblocks.{i}"
        in_w = c.raw(f"{b}.attn.in_proj_weight")  # [3D, D]
        in_b = c.raw(f"{b}.attn.in_proj_bias")  # [3D]
        layers.append({
            "layer_norm1": c.norm(f"{b}.ln_1"),
            "self_attn": {
                "q_proj": {"weight": in_w[:d], "bias": in_b[:d]},
                "k_proj": {"weight": in_w[d:2 * d], "bias": in_b[d:2 * d]},
                "v_proj": {"weight": in_w[2 * d:], "bias": in_b[2 * d:]},
                "out_proj": c.linear(f"{b}.attn.out_proj"),
            },
            "layer_norm2": c.norm(f"{b}.ln_2"),
            "mlp": {"fc1": c.linear(f"{b}.mlp.c_fc"), "fc2": c.linear(f"{b}.mlp.c_proj")},
        })
    params = {
        "text_model": {
            "embeddings": {
                "token_embedding": {"weight": c.raw("token_embedding.weight")},
                "position_embedding": {"weight": c.raw("positional_embedding")},
            },
            "encoder": {"layers": layers},
            "final_layer_norm": c.norm("ln_final"),
        },
        # OpenCLIP's text_projection is a raw [D, P] matrix applied x @ P
        "text_projection": {"weight": c.raw("text_projection").t()},
    }
    c.finish()
    return params


@dataclasses.dataclass
class LoadedModels:
    version: str
    unet: dict
    unet_config: UNetConfig
    text_encoder: dict
    text_encoder_config: CLIPTextConfig
    text_encoder_2: Optional[dict]
    text_encoder_2_config: Optional[CLIPTextConfig]
    vae_state_dict: Dict[str, torch.Tensor]  # first_stage_model.* for the VAE slice


def load_models_from_checkpoint(
    path: str,
    dtype=torch.bfloat16,
    device="cuda",
    unet_config: Optional[UNetConfig] = None,
    clip_l_config: Optional[CLIPTextConfig] = None,
    clip_g_config: Optional[CLIPTextConfig] = None,
) -> LoadedModels:
    """UNet + text encoders of a single-file checkpoint (safetensors.torch).

    Config overrides serve tiny synthetic checkpoints; the VAE family is split
    off by prefix and returned unconverted for the VAE slice."""
    from safetensors.torch import load_file

    sd = load_file(path)
    version = detect_version(sd.keys())
    vae_sd = _take_prefix(sd, VAE_PREFIX)
    unet_cfg = unet_config or (SDXL_UNET_CONFIG if version == "sdxl" else SD15_UNET_CONFIG)
    clip_l_cfg = clip_l_config or CLIP_L_CONFIG
    unet = convert_ldm_unet(_take_prefix(sd, UNET_PREFIX), unet_cfg, dtype, device)
    if version == "sdxl":
        clip_g_cfg = clip_g_config or CLIP_BIG_G_CONFIG
        te1 = convert_hf_clip(_take_prefix(sd, CLIP_SDXL_L_PREFIX), clip_l_cfg, dtype, device)
        te2 = convert_openclip(_take_prefix(sd, CLIP_SDXL_G_PREFIX), clip_g_cfg, dtype, device)
        return LoadedModels(version, unet, unet_cfg, te1, clip_l_cfg, te2, clip_g_cfg, vae_sd)
    te1 = convert_hf_clip(_take_prefix(sd, CLIP_SD15_PREFIX), clip_l_cfg, dtype, device)
    return LoadedModels(version, unet, unet_cfg, te1, clip_l_cfg, None, None, vae_sd)
