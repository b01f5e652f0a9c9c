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
`dense`/`conv2d` apply the low-rank path when present. Under tensor
parallelism a split projection's dict carries a `TPSplit` under "tp"
(parallel/sharding.py): its weight is this rank's part, and `dense` runs
the Megatron split. A "weight" may be an
int8 `QTensor` (models/quant.py): it dequantizes where it is cast. LoRA matrices keep the
peft/kohya layouts: a (r, in) or (r, in, kh, kw), b (out, r) or (out, r, 1, 1).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from sd_lora_trainer_tpu_torch.ops import norms
from sd_lora_trainer_tpu_torch.ops.checkpoint_names import checkpoint_name
from sd_lora_trainer_tpu_torch.utils import profiling


def _lora_scale(lora: dict) -> float:
    alpha = lora["alpha"]
    alpha = alpha.value if hasattr(alpha, "value") else float(alpha)
    return alpha / lora["a"].shape[0]


def _apply_lora_dense(p: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y += scale * (x A^T) B^T, optionally DoRA-normalized.

    The delta runs in the activation dtype; scale = alpha / rank.
    """
    with profiling.layer("lora"):
        lora = p["lora"]
        scale = _lora_scale(lora)
        tp = p.get("tp")
        a, b = lora["a"], lora["b"]
        if tp is not None:
            if "magnitude" in lora:
                raise ValueError("DoRA needs each output's whole weight norm; it does not run on "
                                 "a tensor-parallel split (use sharding_mode 'dp')")
            a, b = tp.lora_a(a), tp.lora_b(b)
        delta = F.linear(F.linear(x, a.to(x.dtype)), b.to(x.dtype)) * scale
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

    A "tp" split: "col" gives this rank's output features (the caller has
    entered x into the model group); "row" takes this rank's input
    features and sums the partial outputs over the model group before the
    bias.
    """
    w = p["weight"].to(x.dtype)
    if w.ndim == 3:  # GEGLU [2, inner, in] (parallel/sharding.py): value rows, then gate
        w = w.flatten(0, 1)
    row = "tp" in p and p["tp"].kind == "row"
    bias = p["bias"].to(x.dtype).reshape(-1) if "bias" in p else None
    if "lora" not in p and not row:
        with checkpoint_name(name):
            return F.linear(x, w, bias)
    with checkpoint_name(name):
        y = F.linear(x, w)
    if "lora" in p:
        y = _apply_lora_dense(p, x, y)
    if row:
        y = p["tp"].exit(y)
    if bias is not None:
        y = y + bias
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
        with profiling.layer("lora"):
            ya = _conv_nhwc(x, lora["a"].to(x.dtype), stride, padding)
            yb = _conv_nhwc(ya, lora["b"].to(x.dtype), 1, 0)
            y = y + yb * _lora_scale(lora)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def group_norm(p: dict, x: torch.Tensor, groups: int = 32, eps: float = 1e-5,
               silu: bool = False) -> torch.Tensor:
    """GroupNorm over the channel (last) axis of NHWC, fp32 statistics;
    `silu(group_norm(...))` in one pass when `silu` (ops/norms.py: the fused
    kernels on a card, the plain formulas elsewhere)."""
    with profiling.layer("norm"):
        return norms.group_norm(x, p["weight"], p["bias"], groups, eps, silu)


def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, fp32 statistics (ops/norms.py)."""
    with profiling.layer("norm"):
        return norms.layer_norm(x, p["weight"], p["bias"], eps)


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
    # a fill on the device, not a host tensor: a captured step copies nothing from the host
    log_period = torch.log(torch.full((), max_period, dtype=torch.float32, device=timesteps.device))
    freqs = torch.exp(
        -log_period * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half
    )
    args = timesteps.float()[..., None] * freqs[None]
    sin, cos = torch.sin(args), torch.cos(args)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbor 2x spatial upsample for NHWC."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
