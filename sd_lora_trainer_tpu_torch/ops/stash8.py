"""int8 activation stashing for the named-remat plans.

Counterpart of sd_lora_trainer_tpu/ops/stash8.py. `stash8(x, name)`
quantizes x row-wise (last axis, symmetric int8, scale max(amax, 1e-12)/127)
and returns the dequantized x̃; every consumer sees x̃ in the forward and in
the backward, and the gradient passes straight through the quantizer. The
quantization is one op (`sd_lora_torch::quantize_rowwise`) named `name`, so a
plan that saves the name keeps the int8 codes and fp32 scales across the
block instead of a bf16 copy, and the backward recomputes x̃ by one dequant.

One difference from JAX, where saving the int8 pair also prunes x's producer
from the recompute: eager PyTorch re-runs the producer of x in the backward
(see ops/checkpoint_names.py). The bytes kept are JAX's; the work saved is
not, except for the flash output, whose op quantizes inside
(`flash_mha(stash8_out=True)`), so its kernel is still skipped.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from sd_lora_trainer_tpu_torch.ops.checkpoint_names import checkpoint_name


def quantize_rowwise(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes int8 [..., D], scales fp32 [..., 1]), as the JAX quantizer."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127.0, 127.0).to(torch.int8)
    return q, scale


def dequantize_rowwise(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """q * scale in fp32, rounded once to `dtype` (JAX's astype chain): one
    kernel that writes `dtype` directly, with no fp32 copy in between."""
    if dtype == torch.float32:
        return q * scale
    return torch.mul(q, scale, out=torch.empty_like(q, dtype=dtype))


@torch.library.custom_op("sd_lora_torch::quantize_rowwise", mutates_args=())
def _quantize_rowwise_op(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return quantize_rowwise(x)


@_quantize_rowwise_op.register_fake
def _(x):
    return torch.empty_like(x, dtype=torch.int8), x.new_empty(x.shape[:-1] + (1,), dtype=torch.float32)


class _Stash8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, name):
        with checkpoint_name(name):
            q, s = _quantize_rowwise_op(x)
        return dequantize_rowwise(q, s, x.dtype)

    @staticmethod
    def backward(ctx, g):
        # straight-through: the quantizer stands in for the identity
        return g, None


def stash8(x: torch.Tensor, name: str) -> torch.Tensor:
    """Fake-quantize x to row-wise int8; a plan that saves `name` keeps the int8 pair."""
    return _Stash8.apply(x, name)


def expand_names(raw: str, channels) -> List[str]:
    """A comma list of checkpoint names; a trailing '*' expands over the
    per-level channel suffixes ('attn_out*' -> 'attn_out_c320', ...)."""
    names = []
    for n in raw.split(","):
        n = n.strip()
        if n.endswith("*"):
            names += [n[:-1] + f"_c{c}" for c in sorted(set(channels))]
        elif n:
            names.append(n)
    return names
