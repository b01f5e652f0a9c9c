"""Single-file SD checkpoint -> parameter trees.

Counterpart of sd_lora_trainer_tpu/models/weights.py. A single-file
checkpoint is an LDM-layout safetensors with the families

    model.diffusion_model.*                     UNet   (CompVis naming)
    first_stage_model.*                         VAE    (CompVis naming)
    cond_stage_model.transformer.text_model.*   CLIP-L (SD1.5, HF naming)
    conditioner.embedders.0.transformer.*       CLIP-L (SDXL, HF naming)
    conditioner.embedders.1.model.*             CLIP-G (SDXL, OpenCLIP naming)

Each family converts into the port's trees: the JAX package's diffusers-style
module paths with the checkpoint's own torch layouts (linear (out, in), conv
OIHW), so no tensor is transposed. Every tensor of a family must be consumed
exactly once; leftovers raise. `export_ldm_unet` is the inverse of
`convert_ldm_unet` (the full-finetune export).

The file is read by the port's utils/safetensors_io.py (no `safetensors`
package), memory-mapped: each tensor is read from disk when it is converted
and moved to its device. Tiny synthetic checkpoints (models/synthesize.py,
of either package) carry their model configs in the file's metadata under
the key "sd_lora_trainer_tpu"; the loader reads them as the JAX package's.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional

import torch

from sd_lora_trainer_tpu_torch.models.clip import CLIP_BIG_G_CONFIG, CLIP_L_CONFIG, CLIPTextConfig
from sd_lora_trainer_tpu_torch.models.unet import SD15_UNET_CONFIG, SDXL_UNET_CONFIG, UNetConfig
from sd_lora_trainer_tpu_torch.models.vae import SD15_VAE_CONFIG, SDXL_VAE_CONFIG, VAEConfig
from sd_lora_trainer_tpu_torch.utils.safetensors_io import load_safetensors, read_safetensors_metadata

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

    def conv_as_linear(self, key: str) -> dict:
        """A 1x1 conv [O, I, 1, 1] as a linear (O, I) (the VAE attention)."""
        w = self._get(f"{key}.weight")
        return {"weight": w[:, :, 0, 0] if w.ndim == 4 else w, "bias": self._get(f"{key}.bias")}

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


def export_ldm_unet(params: dict, cfg: UNetConfig) -> Dict[str, torch.Tensor]:
    """A UNet tree -> its LDM-layout state dict (float32, keys without the
    `model.diffusion_model.` prefix), as the JAX package's export. An int8
    weight (models/quant.py) is written dequantized."""
    out: Dict[str, torch.Tensor] = {}

    def put(key, p):  # linear, conv and norm dicts share {"weight"[, "bias"]}
        out[f"{key}.weight"] = p["weight"].float().detach().contiguous()
        if "bias" in p:
            out[f"{key}.bias"] = p["bias"].float().detach().contiguous()

    def put_resnet(base, p):
        for key, name in (("in_layers.0", "norm1"), ("in_layers.2", "conv1"),
                          ("emb_layers.1", "time_emb_proj"), ("out_layers.0", "norm2"),
                          ("out_layers.3", "conv2"), ("skip_connection", "conv_shortcut")):
            if name in p:
                put(f"{base}.{key}", p[name])

    def put_transformer(base, p):
        for name in ("norm", "proj_in", "proj_out"):
            put(f"{base}.{name}", p[name])
        for k, tb in enumerate(p["transformer_blocks"]):
            b = f"{base}.transformer_blocks.{k}"
            for name in ("norm1", "norm2", "norm3", "ff.net.0.proj", "ff.net.2"):
                put(f"{b}.{name}", tb[name])
            for attn in ("attn1", "attn2"):
                for proj in ("to_q", "to_k", "to_v", "to_out.0"):
                    put(f"{b}.{attn}.{proj}", tb[attn][proj])

    put("input_blocks.0.0", params["conv_in"])
    put("time_embed.0", params["time_embedding"]["linear_1"])
    put("time_embed.2", params["time_embedding"]["linear_2"])
    if "add_embedding" in params:
        put("label_emb.0.0", params["add_embedding"]["linear_1"])
        put("label_emb.0.2", params["add_embedding"]["linear_2"])
    put("out.0", params["conv_norm_out"])
    put("out.2", params["conv_out"])

    n_levels = len(cfg.block_out_channels)
    idx = 1
    for i in range(n_levels):
        block = params["down_blocks"][i]
        for j in range(cfg.layers_per_block):
            put_resnet(f"input_blocks.{idx}.0", block["resnets"][j])
            if cfg.cross_attention[i]:
                put_transformer(f"input_blocks.{idx}.1", block["attentions"][j])
            idx += 1
        if i < n_levels - 1:
            put(f"input_blocks.{idx}.0.op", block["downsamplers"][0]["conv"])
            idx += 1

    put_resnet("middle_block.0", params["mid_block"]["resnets"][0])
    put_transformer("middle_block.1", params["mid_block"]["attentions"][0])
    put_resnet("middle_block.2", params["mid_block"]["resnets"][1])

    idx = 0
    for i in range(n_levels):
        level = n_levels - 1 - i
        block = params["up_blocks"][i]
        for j in range(cfg.layers_per_block + 1):
            put_resnet(f"output_blocks.{idx}.0", block["resnets"][j])
            module = 1
            if cfg.cross_attention[level]:
                put_transformer(f"output_blocks.{idx}.{module}", block["attentions"][j])
                module += 1
            if j == cfg.layers_per_block and i < n_levels - 1:
                put(f"output_blocks.{idx}.{module}.conv", block["upsamplers"][0]["conv"])
            idx += 1
    return out


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


def _vae_resnet(c: _KeyConsumer, base: str) -> dict:
    p = {
        "norm1": c.norm(f"{base}.norm1"),
        "conv1": c.conv(f"{base}.conv1"),
        "norm2": c.norm(f"{base}.norm2"),
        "conv2": c.conv(f"{base}.conv2"),
    }
    if c.has(f"{base}.nin_shortcut.weight"):
        p["conv_shortcut"] = c.conv(f"{base}.nin_shortcut")
    return p


def _vae_attn(c: _KeyConsumer, base: str) -> dict:
    return {
        "group_norm": c.norm(f"{base}.norm"),
        "to_q": c.conv_as_linear(f"{base}.q"),
        "to_k": c.conv_as_linear(f"{base}.k"),
        "to_v": c.conv_as_linear(f"{base}.v"),
        "to_out": c.conv_as_linear(f"{base}.proj_out"),
    }


def convert_ldm_vae(sd: dict, cfg: VAEConfig, dtype=torch.bfloat16, device=None) -> dict:
    """CompVis VAE keys -> the tree of models/vae.py. The decoder's `up.{i}`
    is indexed by resolution level, so `up.{n-1}` runs first."""
    c = _KeyConsumer(sd, "vae", dtype, device)
    n = len(cfg.block_out_channels)
    down_blocks = []
    for i in range(n):
        block = {"resnets": [_vae_resnet(c, f"encoder.down.{i}.block.{j}")
                             for j in range(cfg.layers_per_block)]}
        if i < n - 1:
            block["downsamplers"] = [{"conv": c.conv(f"encoder.down.{i}.downsample.conv")}]
        down_blocks.append(block)
    encoder = {
        "conv_in": c.conv("encoder.conv_in"),
        "down_blocks": down_blocks,
        "mid_block": {
            "resnets": [_vae_resnet(c, "encoder.mid.block_1"), _vae_resnet(c, "encoder.mid.block_2")],
            "attentions": [_vae_attn(c, "encoder.mid.attn_1")],
        },
        "conv_norm_out": c.norm("encoder.norm_out"),
        "conv_out": c.conv("encoder.conv_out"),
    }
    up_blocks = []
    for i in range(n):
        ldm_i = n - 1 - i
        block = {"resnets": [_vae_resnet(c, f"decoder.up.{ldm_i}.block.{j}")
                             for j in range(cfg.layers_per_block + 1)]}
        if ldm_i > 0:
            block["upsamplers"] = [{"conv": c.conv(f"decoder.up.{ldm_i}.upsample.conv")}]
        up_blocks.append(block)
    decoder = {
        "conv_in": c.conv("decoder.conv_in"),
        "mid_block": {
            "resnets": [_vae_resnet(c, "decoder.mid.block_1"), _vae_resnet(c, "decoder.mid.block_2")],
            "attentions": [_vae_attn(c, "decoder.mid.attn_1")],
        },
        "up_blocks": up_blocks,
        "conv_norm_out": c.norm("decoder.norm_out"),
        "conv_out": c.conv("decoder.conv_out"),
    }
    params = {"encoder": encoder, "decoder": decoder, "quant_conv": c.conv("quant_conv"),
              "post_quant_conv": c.conv("post_quant_conv")}
    c.finish()
    return params


@dataclasses.dataclass
class LoadedModels:
    version: str
    unet: dict
    unet_config: UNetConfig
    vae: dict
    vae_config: VAEConfig
    text_encoder: dict
    text_encoder_config: CLIPTextConfig
    text_encoder_2: Optional[dict]
    text_encoder_2_config: Optional[CLIPTextConfig]


# the metadata key of synthesized checkpoints (shared with the JAX package)
EMBEDDED_CONFIG_KEY = "sd_lora_trainer_tpu"


def read_embedded_configs(path: str) -> Optional[dict]:
    """The model configs a synthesized checkpoint embeds in its metadata
    ({"version", "unet", "vae", "clip_l", "clip_g"}), or None for a
    standard SD checkpoint."""
    raw = read_safetensors_metadata(path).get(EMBEDDED_CONFIG_KEY)
    if not raw:
        return None
    data = json.loads(raw)
    for key in ("unet", "vae", "clip_l", "clip_g"):
        if data.get(key):
            data[key] = {k: tuple(v) if isinstance(v, list) else v for k, v in data[key].items()}
    return {
        "version": data["version"],
        "unet": UNetConfig(**data["unet"]),
        "vae": VAEConfig(**data["vae"]),
        "clip_l": CLIPTextConfig(**data["clip_l"]),
        "clip_g": CLIPTextConfig(**data["clip_g"]) if data.get("clip_g") else None,
    }


def load_models_from_checkpoint(
    path: str,
    dtype=torch.bfloat16,
    device="cuda",
    unet_config: Optional[UNetConfig] = None,
    vae_config: Optional[VAEConfig] = None,
    clip_l_config: Optional[CLIPTextConfig] = None,
    clip_g_config: Optional[CLIPTextConfig] = None,
) -> LoadedModels:
    """UNet, VAE and text encoders of a single-file checkpoint, on `device`.

    Configs: the overrides when given, else the ones the file embeds, else
    the standard SD1.5/SDXL topologies."""
    embedded = read_embedded_configs(path)
    if embedded is not None:
        unet_config = unet_config or embedded["unet"]
        vae_config = vae_config or embedded["vae"]
        clip_l_config = clip_l_config or embedded["clip_l"]
        clip_g_config = clip_g_config or embedded["clip_g"]
    sd = load_safetensors(path)
    version = detect_version(sd.keys())
    xl = version == "sdxl"
    unet_cfg = unet_config or (SDXL_UNET_CONFIG if xl else SD15_UNET_CONFIG)
    vae_cfg = vae_config or (SDXL_VAE_CONFIG if xl else SD15_VAE_CONFIG)
    clip_l_cfg = clip_l_config or CLIP_L_CONFIG
    unet = convert_ldm_unet(_take_prefix(sd, UNET_PREFIX), unet_cfg, dtype, device)
    vae = convert_ldm_vae(_take_prefix(sd, VAE_PREFIX), vae_cfg, dtype, device)
    te1 = convert_hf_clip(_take_prefix(sd, CLIP_SDXL_L_PREFIX if xl else CLIP_SD15_PREFIX),
                          clip_l_cfg, dtype, device)
    te2, clip_g_cfg = None, None
    if xl:
        clip_g_cfg = clip_g_config or CLIP_BIG_G_CONFIG
        te2 = convert_openclip(_take_prefix(sd, CLIP_SDXL_G_PREFIX), clip_g_cfg, dtype, device)
    return LoadedModels(version, unet, unet_cfg, vae, vae_cfg, te1, clip_l_cfg, te2, clip_g_cfg)
