"""Attention ops for the UNet and CLIP stacks.

Counterpart of sd_lora_trainer_tpu/ops/attention.py. Two paths:
- `multihead_attention`: plain matmul attention with an fp32 softmax, for
  cross-attention, CLIP and short self-attention; with `capture_scores` it
  also returns the DAAM scores (pre-softmax scaled logits summed over heads).
- `ops/flash_attention.py`: the CUDA flash kernels for self-attention of
  >= 256 tokens, chosen by `self_attention`.

`out_name` names the attention's output for the selective remat plans: it
is attached to the op that produces it, the probabilities times V
(ops/checkpoint_names.py).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from sd_lora_trainer_tpu_torch.ops.checkpoint_names import checkpoint_name
from sd_lora_trainer_tpu_torch.ops.flash_attention import flash_attention_qualifies, flash_mha


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, l, d = x.shape
    return x.reshape(b, l, heads, d // heads).transpose(1, 2)  # [B,H,L,dh]


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, l, dh = x.shape
    return x.transpose(1, 2).reshape(b, l, h * dh)


def multihead_attention(
    q: torch.Tensor,  # [B, Lq, D]
    k: torch.Tensor,  # [B, Lk, D]
    v: torch.Tensor,  # [B, Lk, D]
    heads: int,
    mask: Optional[torch.Tensor] = None,  # additive, broadcastable to [B,H,Lq,Lk]
    capture_scores: bool = False,
    out_name: Optional[str] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain attention with fp32 softmax. Returns (out [B,Lq,D], scores|None);
    scores are the pre-softmax scaled logits summed over heads, fp32."""
    qh, kh, vh = _split_heads(q, heads), _split_heads(k, heads), _split_heads(v, heads)
    scale = 1.0 / math.sqrt(qh.shape[-1])
    # fp32 logits, as the JAX einsum's preferred_element_type=f32
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits + mask
    captured = logits.sum(dim=1) if capture_scores else None  # [B,Lq,Lk]
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    b, h, lq, lk = probs.shape
    # torch.matmul's bmm with its operand copies made outside the name
    p3, v3 = probs.reshape(b * h, lq, lk), vh.reshape(b * h, lk, vh.shape[-1])
    with checkpoint_name(out_name):
        out = torch.bmm(p3, v3)
    return _merge_heads(out.view(b, h, lq, -1)), captured


def self_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    use_flash: bool = False,
    pre_padded: int = 0,  # caller padded the sequence; this many tokens are real
    name_tag: str = "",
    stash8_out: bool = False,
    out_name: Optional[str] = None,
) -> torch.Tensor:
    """Self-attention over image tokens; the flash kernels when shapes qualify.

    `name_tag` and `stash8_out` go to `flash_mha` (its residuals' names and
    their int8 stash); `out_name` names the plain path's output. On the flash
    path the output is the flash op's o, a view, so it names no op of its own.

    `pre_padded > 0`: only the first `pre_padded` tokens are real. The flash
    path masks the pad tokens via segment ids; the plain path masks the pad
    KEYS additively so real rows never attend to them (pad rows are sliced
    off by the caller and get a zero cotangent).
    """
    if use_flash and flash_attention_qualifies(q.shape, k.shape, heads, q.device):
        return flash_mha(q, k, v, heads, name_tag=name_tag, stash8_out=stash8_out,
                         pre_padded=pre_padded)
    mask = None
    if pre_padded:
        keymask = torch.arange(k.shape[1], device=k.device) < pre_padded
        mask = torch.where(keymask, 0.0, -1e9).float()[None, None, None, :]
    out, _ = multihead_attention(q, k, v, heads, mask=mask, out_name=out_name)
    return out


def make_causal_mask(length: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Additive causal mask [1, 1, L, L] (CLIP text encoder)."""
    neg = -0.7 * torch.finfo(torch.float32).max
    mask = torch.triu(torch.full((length, length), neg, dtype=dtype, device=device), diagonal=1)
    return mask[None, None]
