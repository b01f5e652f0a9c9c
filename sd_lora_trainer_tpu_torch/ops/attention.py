"""Attention ops for the UNet and CLIP stacks.

Counterpart of sd_lora_trainer_tpu/ops/attention.py. Two paths:
- `multihead_attention`: plain matmul attention with an fp32 softmax, for
  cross-attention, CLIP and short self-attention; with `capture_scores` it
  also returns the DAAM scores (pre-softmax scaled logits summed over heads).
- `ops/flash_attention.py`: the CUDA flash kernels for self-attention of
  >= 256 tokens, chosen by `self_attention`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

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
    return _merge_heads(torch.matmul(probs, vh)), captured


def self_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    use_flash: bool = False,
    pre_padded: int = 0,  # caller padded the sequence; this many tokens are real
) -> torch.Tensor:
    """Self-attention over image tokens; the flash kernels when shapes qualify.

    `pre_padded > 0`: only the first `pre_padded` tokens are real. The flash
    path masks the pad tokens via segment ids; the plain path masks the pad
    KEYS additively so real rows never attend to them (pad rows are sliced
    off by the caller and get a zero cotangent).
    """
    if use_flash and flash_attention_qualifies(q.shape, k.shape, heads, q.device):
        return flash_mha(q, k, v, heads, pre_padded=pre_padded)
    mask = None
    if pre_padded:
        keymask = torch.arange(k.shape[1], device=k.device) < pre_padded
        mask = torch.where(keymask, 0.0, -1e9).float()[None, None, None, :]
    out, _ = multihead_attention(q, k, v, heads, mask=mask)
    return out


def make_causal_mask(length: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Additive causal mask [1, 1, L, L] (CLIP text encoder)."""
    neg = -0.7 * torch.finfo(torch.float32).max
    mask = torch.triu(torch.full((length, length), neg, dtype=dtype, device=device), diagonal=1)
    return mask[None, None]
