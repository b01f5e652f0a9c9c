"""Plain PyTorch layers of the reference, written from the published
architectures (diffusers' UNet2DConditionModel, OpenAI CLIP / OpenCLIP
text towers). Activations are NCHW for convolutions, [B, L, C] for tokens.

`Prec` is the precision the reference computes in:

- "fp32": float32 throughout, TF32 off (the reference that judges);
- "bf16": bfloat16 activations and weights, float32 norm statistics,
  softmax and losses: what a correct bf16 program computes;
- "fp8": as "bf16", with both operands of every matmul and convolution
  rounded to float8 e4m3 under a per-tensor scale first: the lower
  precision that the check has to fail (its control).

Nothing here imports the program under test.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


@dataclasses.dataclass(frozen=True)
class Prec:
    name: str = "fp32"
    # the attention of more than this many query rows runs in blocks of them,
    # its probabilities recomputed in the backward (memory, not arithmetic)
    block_rows: int = 1024
    # plain: no blocks and no recompute, so that FlopCounterMode counts the
    # model's operations once (the FLOP count, on the meta device)
    plain: bool = False

    @property
    def dt(self) -> torch.dtype:
        return torch.float32 if self.name == "fp32" else torch.bfloat16

    def mm_in(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a matmul or convolution as this precision feeds it."""
        x = x.to(self.dt)
        if self.name != "fp8" or x.device.type == "meta":
            return x
        scale = (x.detach().abs().amax().float() / E4M3_MAX).clamp(min=1e-30)
        return _Fp8Round.apply(x, scale)


class _Fp8Round(torch.autograd.Function):
    """x rounded to e4m3 under `scale`; the gradient passes straight through
    (the control's backward operands are rounded where they enter a matmul)."""

    @staticmethod
    def forward(ctx, x, scale):
        return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def linear(p: dict, x: torch.Tensor, prec: Prec, lora: Optional[dict] = None) -> torch.Tensor:
    """x W^T + b, plus the low-rank path scale * (x A^T) B^T when `lora`."""
    y = torch.matmul(prec.mm_in(x), prec.mm_in(p["weight"]).t())
    if lora is not None:
        down = torch.matmul(prec.mm_in(x), prec.mm_in(lora["a"]).t())
        y = y + torch.matmul(prec.mm_in(down), prec.mm_in(lora["b"]).t()) * lora["scale"]
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


def conv(p: dict, x: torch.Tensor, prec: Prec, stride: int = 1, padding: int = 1,
         lora: Optional[dict] = None) -> torch.Tensor:
    """NCHW convolution; a conv adapter is A (r, in, kh, kw) at the base
    conv's stride and padding, then B as a 1x1 convolution."""
    y = F.conv2d(prec.mm_in(x), prec.mm_in(p["weight"]), stride=stride, padding=padding)
    if lora is not None:
        down = F.conv2d(prec.mm_in(x), prec.mm_in(lora["a"]), stride=stride, padding=padding)
        y = y + F.conv2d(prec.mm_in(down), prec.mm_in(lora["b"])) * lora["scale"]
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)[None, :, None, None]
    return y


def group_norm(p: dict, x: torch.Tensor, groups: int, eps: float) -> torch.Tensor:
    """GroupNorm of NCHW activations with float32 statistics."""
    out = F.group_norm(x.float(), groups, p["weight"].float(), p["bias"].float(), eps)
    return out.to(x.dtype)


def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    out = F.layer_norm(x.float(), (x.shape[-1],), p["weight"].float(), p["bias"].float(), eps)
    return out.to(x.dtype)


def heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, l, c = x.shape
    return x.reshape(b, l, n, c // n).transpose(1, 2)


def merge(x: torch.Tensor) -> torch.Tensor:
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


def softmax_attention(q, k, v, prec: Prec, mask: Optional[torch.Tensor] = None,
                      want_logits: bool = False):
    """softmax(q k^T / sqrt(d) + mask) v over [B, H, L, d], the logits and
    softmax in float32. Returns (out, logits or None)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(prec.mm_in(q).float(), prec.mm_in(k).float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits + mask
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(prec.mm_in(probs), prec.mm_in(v))
    return out.to(prec.dt), (logits if want_logits else None)


class _BlockedAttention(torch.autograd.Function):
    """Self-attention in blocks of query rows: the forward keeps the output
    and each row's log-sum-exp; the backward computes each block's
    probabilities again. Float32 logits and softmax; operands as `prec`."""

    @staticmethod
    def forward(ctx, q, k, v, prec: Prec):
        scale = 1.0 / math.sqrt(q.shape[-1])
        qi, ki, vi = prec.mm_in(q), prec.mm_in(k), prec.mm_in(v)
        outs, lses = [], []
        for s in range(0, q.shape[2], prec.block_rows):
            logits = torch.matmul(qi[:, :, s:s + prec.block_rows].float(),
                                  ki.float().transpose(-1, -2)) * scale
            lse = torch.logsumexp(logits, dim=-1, keepdim=True)
            probs = torch.exp(logits - lse)
            outs.append(torch.matmul(prec.mm_in(probs), vi).to(prec.dt))
            lses.append(lse)
        ctx.prec, ctx.scale = prec, scale
        out = torch.cat(outs, dim=2)
        ctx.save_for_backward(q, k, v, out, torch.cat(lses, dim=2))
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        prec, scale = ctx.prec, ctx.scale
        qi, ki, vi = prec.mm_in(q), prec.mm_in(k), prec.mm_in(v)
        dq = torch.empty_like(q, dtype=torch.float32)
        dk = torch.zeros_like(k, dtype=torch.float32)
        dv = torch.zeros_like(v, dtype=torch.float32)
        di = (dout.float() * out.float()).sum(dim=-1, keepdim=True)
        for s in range(0, q.shape[2], prec.block_rows):
            e = s + prec.block_rows
            logits = torch.matmul(qi[:, :, s:e].float(), ki.float().transpose(-1, -2)) * scale
            probs = torch.exp(logits - lse[:, :, s:e])
            do = prec.mm_in(dout[:, :, s:e])
            dv += torch.matmul(prec.mm_in(probs).transpose(-1, -2), do).float()
            dp = torch.matmul(do, vi.transpose(-1, -2)).float()
            ds = probs * (dp - di[:, :, s:e]) * scale
            dq[:, :, s:e] = torch.matmul(prec.mm_in(ds), ki).float()
            dk += torch.matmul(prec.mm_in(ds).transpose(-1, -2), qi[:, :, s:e]).float()
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def self_attention(q, k, v, prec: Prec) -> torch.Tensor:
    if prec.plain or q.shape[2] <= prec.block_rows:
        return softmax_attention(q, k, v, prec)[0]
    return _BlockedAttention.apply(q, k, v, prec)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers' Timesteps(dim, flip_sin_to_cos=True, downscale_freq_shift=0)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
