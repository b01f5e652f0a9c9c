"""Fused attention projections (counterpart of models/fuse.py in the JAX package).

`fuse_attention_projections` rewrites a UNet param tree so each transformer
block issues fewer, larger matmuls:

- attn1 (self-attention): to_q/to_k/to_v weights (C, C) concatenate into one
  (3C, C) `qkv` weight over the same input;
- attn2 (cross-attention): to_k/to_v weights (C, ctx) concatenate into one
  (2C, ctx) `kv` weight over the text context.

The base weights leave their projection dicts (no extra memory); the dicts
stay as LoRA carriers, and the forward applies each low-rank delta to its
split slice. Not applicable with DoRA, whose column norm needs the
per-projection base weight.
"""

from __future__ import annotations

import torch


def _fuse_tblock(tb: dict) -> dict:
    tb = dict(tb)
    for attn, names, fused_key in (
        ("attn1", ("to_q", "to_k", "to_v"), "qkv"),
        ("attn2", ("to_k", "to_v"), "kv"),
    ):
        a = dict(tb[attn])
        if not all("weight" in a.get(n, {}) for n in names):
            continue
        a[fused_key] = {"weight": torch.cat([a[n]["weight"] for n in names], dim=0)}
        for n in names:
            sub = dict(a[n])
            del sub["weight"]
            a[n] = sub  # keeps any "lora" subdict in place
        tb[attn] = a
    return tb


def _fuse_attention(sp: dict) -> dict:
    sp = dict(sp)
    sp["transformer_blocks"] = [_fuse_tblock(tb) for tb in sp["transformer_blocks"]]
    return sp


def fuse_attention_projections(unet_params: dict) -> dict:
    """A new tree with fused qkv/kv weights in every spatial transformer."""
    out = dict(unet_params)
    for key in ("down_blocks", "up_blocks"):
        blocks = []
        for bp in out.get(key, []):
            bp = dict(bp)
            if "attentions" in bp:
                bp["attentions"] = [_fuse_attention(sp) for sp in bp["attentions"]]
            blocks.append(bp)
        out[key] = blocks
    mid = dict(out["mid_block"])
    if "attentions" in mid:
        mid["attentions"] = [_fuse_attention(sp) for sp in mid["attentions"]]
    out["mid_block"] = mid
    return out
