"""Layer primitives over plain parameter dicts.

Counterpart of sd_lora_trainer_tpu/models/layers.py. Every model of the port
is a function over a nested dict of tensors whose module paths are the JAX
package's diffusers-style names; the leaves keep the checkpoint's torch
layouts and names:

- linear: "weight" (out, in), optional "bias";
- conv: "weight" OIHW, "bias"; activations stay NHWC at the public surface
  (the convs read them as channels-last NCHW views, no copies);
- norms: "weight", "bias".

A param dict may carry a "lora" subdict ({"a", "b", "alpha"[, "magnitude"]});
`dense`/`conv2d` apply the low-rank path when present. A "weight" may be an
int8 `QTensor` (models/quant.py): it dequantizes where it is cast. LoRA matrices keep the
peft/kohya layouts: a (r, in) or (r, in, kh, kw), b (out, r) or (out, r, 1, 1).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from sd_lora_trainer_tpu_torch.ops.checkpoint_names import checkpoint_name


def _lora_scale(lora: dict) -> float:
    alpha = lora["alpha"]
    alpha = alpha.value if hasattr(alpha, "value") else float(alpha)
    return alpha / lora["a"].shape[0]


def _apply_lora_dense(p: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y += scale * (x A^T) B^T, optionally DoRA-normalized.

    The delta runs in the activation dtype; scale = alpha / rank.
    """
    lora = p["lora"]
    scale = _lora_scale(lora)
    a = lora["a"].to(x.dtype)
    b = lora["b"].to(x.dtype)
    delta = F.linear(F.linear(x, a), b) * scale
    if "magnitude" in lora:
        # DoRA (arXiv:2402.09353): W' = m * (W0 + s·BA) / ||W0 + s·BA|| per output
        w = p["weight"].float() + (lora["b"].float() @ lora["a"].float()) * scale
        m = lora["magnitude"] / torch.clamp(torch.linalg.norm(w, dim=1), min=1e-6)
        return ((y + delta).float() * m).to(x.dtype)
    return y + delta


def dense(p: dict, x: torch.Tensor, name: Optional[str] = None) -> torch.Tensor:
    """x W^T (+ LoRA path when p['lora'] exists) (+ bias).

    `name` names the output for the selective remat plans; it is attached to
    the matmul (ops/checkpoint_names.py), which without LoRA takes the bias
    too, so the name covers one op. The weight's cast (an int8 weight's
    dequantization) stays outside the name: it is never kept.
    """
    w = p["weight"].to(x.dtype)
    if "lora" not in p:
        bias = p["bias"].to(x.dtype) if "bias" in p else None
        with checkpoint_name(name):
            return F.linear(x, w, bias)
    with checkpoint_name(name):
        y = F.linear(x, w)
    y = _apply_lora_dense(p, x, y)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def _conv_nhwc(x: torch.Tensor, w: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def conv2d(p: dict, x: torch.Tensor, stride: int = 1, padding="SAME") -> torch.Tensor:
    """NHWC conv with an OIHW weight (+ optional conv-LoRA path).

    padding: an int, "VALID", or "SAME" (odd kernels at stride 1). Conv LoRA
    follows peft's Conv2d adapter: A is a (r, in, kh, kw) conv with the base
    conv's stride and padding, B a 1x1 (out, r) conv.
    """
    w = p["weight"].to(x.dtype)
    if padding == "VALID":
        padding = 0
    elif padding == "SAME":
        if stride != 1 or w.shape[-1] % 2 == 0:
            raise ValueError("SAME padding is supported for odd kernels at stride 1")
        padding = w.shape[-1] // 2
    y = _conv_nhwc(x, w, stride, padding)
    if "lora" in p:
        lora = p["lora"]
        ya = _conv_nhwc(x, lora["a"].to(x.dtype), stride, padding)
        yb = _conv_nhwc(ya, lora["b"].to(x.dtype), 1, 0)
        y = y + yb * _lora_scale(lora)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def group_norm(p: dict, x: torch.Tensor, groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over the channel (last) axis of NHWC, fp32 statistics."""
    b, h, w, c = x.shape
    xf = x.float().reshape(b, h * w, groups, c // groups)
    var, mean = torch.var_mean(xf, dim=(1, 3), keepdim=True, correction=0)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    return (xf * p["weight"].float() + p["bias"].float()).to(x.dtype)


def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, fp32 statistics."""
    out = F.layer_norm(x.float(), (x.shape[-1],), p["weight"].float(), p["bias"].float(), eps)
    return out.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP-L activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)


def timestep_embedding(
    timesteps: torch.Tensor, dim: int, max_period: float = 10000.0, flip_sin_to_cos: bool = True
) -> torch.Tensor:
    """Sinusoidal timestep embedding, fp32 (diffusers semantics with
    downscale_freq_shift=0)."""
    half = dim // 2
    log_period = torch.log(torch.tensor(max_period, dtype=torch.float32, device=timesteps.device))
    freqs = torch.exp(
        -log_period * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half
    )
    args = timesteps.float()[..., None] * freqs[None]
    sin, cos = torch.sin(args), torch.cos(args)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbor 2x spatial upsample for NHWC."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
