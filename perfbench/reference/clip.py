"""The reference CLIP text towers: OpenAI CLIP ViT-L/14's (SD1.5 and SDXL's
first encoder) and OpenCLIP ViT-bigG/14's (SDXL's second), from their
published `text_encoder*/config.json`: pre-LN encoder layers under a causal
mask, the final LayerNorm, and the pooled feature at the first end token,
projected where the tower has a `text_projection`. Textual-inversion rows
are appended to the token table."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from perfbench.reference.nn import Prec, heads, layer_norm, linear, merge, softmax_attention


@dataclasses.dataclass(frozen=True)
class ClipSpec:
    hidden: int
    layers: int
    heads: int
    act: str
    eos: int

    @classmethod
    def from_config(cls, te: dict) -> "ClipSpec":
        return cls(hidden=te["hidden_size"], layers=te["num_hidden_layers"],
                   heads=te["num_attention_heads"], act=te["hidden_act"], eos=te["eos_token_id"])


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x)


def clip_text(params: dict, ids: torch.Tensor, spec: ClipSpec, prec: Prec,
              ti_rows: Optional[torch.Tensor] = None) -> dict:
    """{"last", "penultimate", "pooled"} of a [B, 77] id batch."""
    tm = params["text_model"]
    table = tm["embeddings"]["token_embedding"]["weight"]
    if ti_rows is not None:
        table = torch.cat([table.to(ti_rows.dtype), ti_rows], dim=0)
    x = table[ids].to(prec.dt) + tm["embeddings"]["position_embedding"]["weight"][: ids.shape[1]].to(prec.dt)
    n = ids.shape[1]
    mask = torch.full((n, n), float("-inf"), device=ids.device).triu(1)
    layers = tm["encoder"]["layers"]
    penultimate = None
    for i, lp in enumerate(layers):
        if i == len(layers) - 1:
            penultimate = x
        h = layer_norm(lp["layer_norm1"], x)
        sa = lp["self_attn"]
        q, k, v = (heads(linear(sa[n_], h, prec), spec.heads)
                   for n_ in ("q_proj", "k_proj", "v_proj"))
        x = x + linear(sa["out_proj"], merge(softmax_attention(q, k, v, prec, mask)[0]), prec)
        h = _act(spec.act, linear(lp["mlp"]["fc1"], layer_norm(lp["layer_norm2"], x), prec))
        x = x + linear(lp["mlp"]["fc2"], h, prec)
    last = layer_norm(tm["final_layer_norm"], x)
    eos = (ids == spec.eos).int().argmax(dim=1)
    pooled = last[torch.arange(ids.shape[0], device=ids.device), eos]
    if "text_projection" in params:
        pooled = linear(params["text_projection"], pooled, prec)
    return {"last": last, "penultimate": penultimate, "pooled": pooled}
