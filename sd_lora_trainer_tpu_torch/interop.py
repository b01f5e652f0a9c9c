"""Parameter trees of the JAX package -> the port's tensors.

`from_jax_params(tree)` takes a nested dict/list of numpy arrays (the JAX
package's UNet/CLIP params, LoRA tree or TI rows, as `np.asarray` gives them)
and returns the port's tree: linear "kernel" (in, out) -> "weight" (out, in),
conv "kernel" HWIO -> "weight" OIHW, norm "scale" -> "weight", LoRA
a (in, r) / b (r, out) -> a (r, in) / b (out, r) (convs HWIO -> OIHW), a
LoraAlpha-like leaf (anything with `.value`) -> the port's `LoraAlpha`, and
an int8 QTensor-like kernel (anything with `.q` and `.s`) -> the port's
`QTensor`, its codes and fp32 scales in the torch layout (the output channel
first).
Everything else keeps its name and layout. The tensors go to the card unless
`device` says otherwise (the tests pass "cpu"). It never imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from sd_lora_trainer_tpu_torch.models.lora import LoraAlpha
from sd_lora_trainer_tpu_torch.models.quant import QTensor


# the one definition of the two packages' layouts, by a tensor's rank: the
# port's axes in JAX's order (a matrix (out, in) as JAX's (in, out), a conv
# weight OIHW as HWIO), and the inverse; other ranks are laid out alike
_TO_JAX = {2: (1, 0), 4: (2, 3, 1, 0)}
_TO_TORCH = {n: tuple(int(i) for i in np.argsort(p)) for n, p in _TO_JAX.items()}


def _to_torch_layout(x: np.ndarray) -> np.ndarray:
    return np.transpose(x, _TO_TORCH[x.ndim]) if x.ndim in _TO_TORCH else x


def relaid(ndim: int) -> bool:
    """Whether a tensor of rank `ndim` is laid out otherwise in JAX."""
    return ndim in _TO_JAX


def jax_layout(t: torch.Tensor) -> torch.Tensor:
    """A view of the port's tensor `t` in the JAX package's layout."""
    return t.permute(_TO_JAX[t.ndim]) if t.ndim in _TO_JAX else t


def from_jax_order(flat: torch.Tensor, shape) -> torch.Tensor:
    """A view in `shape` (the port's layout) of `flat`, which holds the
    elements in `jax_layout`'s order: the inverse of
    `jax_layout(t).reshape(-1)`."""
    if len(shape) not in _TO_JAX:
        return flat.view(shape)
    return flat.view([shape[i] for i in _TO_JAX[len(shape)]]).permute(_TO_TORCH[len(shape)])


def _tensor(x, device, dtype) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.kind in "iub":
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    # floats (bf16 included) go through float32 before the target dtype
    a = np.ascontiguousarray(a.astype(np.float32))
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def from_jax_params(tree, device="cuda", dtype=torch.float32, requires_grad: bool = False):
    """Convert a JAX-package param/LoRA/TI tree; see the module docstring."""

    def leaf(x):
        t = _tensor(x, device, dtype)
        return t.requires_grad_() if requires_grad and t.is_floating_point() else t

    def kernel(v):
        if hasattr(v, "q") and hasattr(v, "s"):  # int8 weight: dtype of its dequantization
            q = _tensor(_to_torch_layout(np.asarray(v.q)), device, None)
            s = _tensor(_to_torch_layout(np.asarray(v.s)), device, torch.float32)
            return QTensor(q, s, getattr(torch, np.dtype(v.dtype).name))
        return leaf(_to_torch_layout(np.asarray(v)))

    def conv(node):
        if hasattr(node, "value") and not isinstance(node, np.ndarray):
            return LoraAlpha(node.value)
        if isinstance(node, dict):
            if "a" in node and "b" in node:  # LoRA adapter
                out = {k: conv(v) for k, v in node.items()}
                out["a"] = leaf(_to_torch_layout(np.asarray(node["a"])))
                out["b"] = leaf(_to_torch_layout(np.asarray(node["b"])))
                return out
            out = {}
            for k, v in node.items():
                if k == "kernel":
                    out["weight"] = kernel(v)
                elif k == "scale":
                    out["weight"] = leaf(v)
                else:
                    out[k] = conv(v)
            return out
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        if node is None:
            return None
        return leaf(node)

    return conv(tree)
