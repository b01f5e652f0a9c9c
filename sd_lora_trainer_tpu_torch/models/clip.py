"""CLIP text encoders (CLIP-L and OpenCLIP bigG) over parameter dicts.

Counterpart of sd_lora_trainer_tpu/models/clip.py. One forward returns
- `last`: final_layer_norm(hidden) (SD1.5 conditioning);
- `penultimate`: the input of the last encoder layer (SDXL, "clip skip 2");
- `pooled`: the feature at the first EOS token after the final LN, through
  `text_projection` when present (SDXL's pooled embedding from TE2).

Textual inversion: `ti_embeddings` [n_new, D] rows are appended to the
frozen token table at lookup, so only the new rows receive gradients.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from sd_lora_trainer_tpu_torch.models.layers import dense, gelu, layer_norm, quick_gelu
from sd_lora_trainer_tpu_torch.ops.attention import make_causal_mask, multihead_attention


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"  # "quick_gelu" (CLIP-L) | "gelu" (bigG)
    eos_token_id: int = 49407
    projection_dim: Optional[int] = None  # set for bigG (1280)


CLIP_L_CONFIG = CLIPTextConfig()

CLIP_BIG_G_CONFIG = CLIPTextConfig(
    hidden_size=1280,
    num_layers=32,
    num_heads=20,
    intermediate_size=5120,
    hidden_act="gelu",
    projection_dim=1280,
)

# Tiny configs of the JAX package's models/synthesize.py, for tests.
TINY_CLIP_L_CONFIG = CLIPTextConfig(
    vocab_size=256, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
    max_position_embeddings=77, eos_token_id=255,
)
TINY_CLIP_G_CONFIG = CLIPTextConfig(
    vocab_size=256, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
    max_position_embeddings=77, eos_token_id=255, hidden_act="gelu", projection_dim=32,
)


def _encoder_layer(p: dict, x: torch.Tensor, mask: torch.Tensor, cfg: CLIPTextConfig):
    act = quick_gelu if cfg.hidden_act == "quick_gelu" else gelu
    h = layer_norm(p["layer_norm1"], x)
    sa = p["self_attn"]
    attn, _ = multihead_attention(
        dense(sa["q_proj"], h), dense(sa["k_proj"], h), dense(sa["v_proj"], h),
        cfg.num_heads, mask=mask,
    )
    x = x + dense(sa["out_proj"], attn)
    h = act(dense(p["mlp"]["fc1"], layer_norm(p["layer_norm2"], x)))
    return x + dense(p["mlp"]["fc2"], h)


def clip_text_forward(
    params: dict,
    input_ids: torch.Tensor,  # [B, 77] int
    cfg: CLIPTextConfig,
    ti_embeddings: Optional[torch.Tensor] = None,  # [n_new, D] trainable rows
    dtype=torch.bfloat16,
) -> dict:
    """Forward pass; see the module docstring for the returned dict."""
    tm = params["text_model"]
    table = tm["embeddings"]["token_embedding"]["weight"]
    if ti_embeddings is not None:
        table = torch.cat([table, ti_embeddings.to(table.dtype)], dim=0)
    # clamp like the JAX take(mode="clip"): an id past the table stays defined
    ids = input_ids.long().clamp(0, table.shape[0] - 1)
    x = table[ids].to(dtype)
    pos = tm["embeddings"]["position_embedding"]["weight"][: input_ids.shape[1]]
    x = x + pos.to(dtype)

    mask = make_causal_mask(input_ids.shape[1], device=x.device)
    hidden = x
    penultimate = None
    layers = tm["encoder"]["layers"]
    for i, layer_params in enumerate(layers):
        if i == len(layers) - 1:
            penultimate = hidden
        hidden = _encoder_layer(layer_params, hidden, mask, cfg)
    last = layer_norm(tm["final_layer_norm"], hidden)

    # first EOS position (argmax of ids == eos, robust to TI ids above eos)
    eos_pos = (input_ids == cfg.eos_token_id).int().argmax(dim=1)
    pooled = last[torch.arange(last.shape[0], device=last.device), eos_pos]
    if "text_projection" in params:
        pooled = dense(params["text_projection"], pooled)
    return {"last": last, "penultimate": penultimate, "pooled": pooled}


def init_clip_params(cfg: CLIPTextConfig, generator: torch.Generator, dtype=torch.float32,
                     device="cuda") -> dict:
    """Random-init params with the JAX package's init scales, torch layouts."""

    def randn(*shape, std):
        return torch.randn(shape, generator=generator, dtype=dtype, device=device) * std

    def lin(n_in, n_out):
        return {"weight": randn(n_out, n_in, std=0.02),
                "bias": torch.zeros(n_out, dtype=dtype, device=device)}

    def ln():
        return {"weight": torch.ones(cfg.hidden_size, dtype=dtype, device=device),
                "bias": torch.zeros(cfg.hidden_size, dtype=dtype, device=device)}

    d, ffn = cfg.hidden_size, cfg.intermediate_size
    layers = [
        {
            "layer_norm1": ln(),
            "self_attn": {"q_proj": lin(d, d), "k_proj": lin(d, d), "v_proj": lin(d, d),
                          "out_proj": lin(d, d)},
            "layer_norm2": ln(),
            "mlp": {"fc1": lin(d, ffn), "fc2": lin(ffn, d)},
        }
        for _ in range(cfg.num_layers)
    ]
    params = {
        "text_model": {
            "embeddings": {
                "token_embedding": {"weight": randn(cfg.vocab_size, d, std=0.014)},
                "position_embedding": {"weight": randn(cfg.max_position_embeddings, d, std=0.01)},
            },
            "encoder": {"layers": layers},
            "final_layer_norm": ln(),
        }
    }
    if cfg.projection_dim is not None:
        params["text_projection"] = {"weight": randn(cfg.projection_dim, d, std=0.02)}
    return params
