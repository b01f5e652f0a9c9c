"""Parameter trees of the JAX package -> the port's tensors.

`from_jax_params(tree)` takes a nested dict/list of numpy arrays (the JAX
package's UNet/CLIP params, LoRA tree or TI rows, as `np.asarray` gives them)
and returns the port's tree: linear "kernel" (in, out) -> "weight" (out, in),
conv "kernel" HWIO -> "weight" OIHW, norm "scale" -> "weight", LoRA
a (in, r) / b (r, out) -> a (r, in) / b (out, r) (convs HWIO -> OIHW), and a
LoraAlpha-like leaf (anything with `.value`) -> the port's `LoraAlpha`.
Everything else keeps its name and layout. It never imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from sd_lora_trainer_tpu_torch.models.lora import LoraAlpha


def _to_torch_layout(x: np.ndarray) -> np.ndarray:
    if x.ndim == 2:
        return x.T
    if x.ndim == 4:
        return np.transpose(x, (3, 2, 0, 1))
    return x


def _tensor(x, device, dtype) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.kind in "iub":
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    # floats (bf16 included) go through float32 before the target dtype
    a = np.ascontiguousarray(a.astype(np.float32))
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def from_jax_params(tree, device="cpu", dtype=torch.float32, requires_grad: bool = False):
    """Convert a JAX-package param/LoRA/TI tree; see the module docstring."""

    def leaf(x):
        t = _tensor(x, device, dtype)
        return t.requires_grad_() if requires_grad and t.is_floating_point() else t

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
                    out["weight"] = leaf(_to_torch_layout(np.asarray(v)))
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
