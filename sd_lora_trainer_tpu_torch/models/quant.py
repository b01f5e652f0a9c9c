"""Frozen-base weight quantization (int8 codes + per-output-channel scales).

Counterpart of sd_lora_trainer_tpu/models/quant.py. In LoRA mode the base
weights are read-only: gradients flow only through the adapter tree. Storing
the base matmul/conv weights as per-output-channel symmetric int8 (codes +
fp32 scales) halves their device residency against bf16; on SDXL that frees
~2.4 GiB.

The port keeps the checkpoint's torch layouts, dense [out, in] and conv OIHW,
so the output channel is axis 0 here (the JAX package's last axis) and the
scales reduce over every other axis. On the same float32 weights the codes
and scales equal JAX's bit for bit (transposed).

Dequantization happens at the point of use: `QTensor.to(dtype)` is
duck-typed, so every consumer site (`layers.dense`/`conv2d`, the fused
qkv/kv matmuls of models/unet.py, DoRA's `.float()`, `merge_lora`)
dequantizes where a bf16 weight would have been cast. Inside a recomputed
block the bf16 weight is a transient rebuilt from the codes in the backward;
a layer that is not recomputed keeps the dequantized weight from forward to
backward (F.linear/F.conv2d save it), as in JAX.
"""

from __future__ import annotations

from typing import Any

import torch

from sd_lora_trainer_tpu_torch.ops.stash8 import dequantize_rowwise


class QTensor:
    """Per-output-channel symmetric int8 weight: w ~= q * s.

    Duck-types what the layer code touches on a weight: `.to(dtype)` and
    `.float()` dequantize; `.shape`, `.ndim`, `.dtype` (the logical dtype a
    dequantized weight has) and `.device` describe it. `.to(device)` moves
    the codes and scales.
    """

    __slots__ = ("q", "s", "_dtype")

    def __init__(self, q: torch.Tensor, s: torch.Tensor, dtype=torch.bfloat16):
        self.q = q  # int8 codes, the weight's shape
        self.s = s  # fp32 scales, [out, 1, ...] (broadcasts over q)
        self._dtype = dtype

    @property
    def shape(self):
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.ndim

    @property
    def dtype(self):
        return self._dtype

    @property
    def device(self):
        return self.q.device

    def to(self, target):
        """Dequantize to a dtype (int8 -> fp32 times s, one rounding to the
        dtype, as JAX's astype chain), or move to a device."""
        if isinstance(target, torch.dtype):
            return dequantize_rowwise(self.q, self.s, target)
        return QTensor(self.q.to(target), self.s.to(target), self._dtype)

    def float(self) -> torch.Tensor:
        return self.to(torch.float32)

    def __repr__(self):
        return f"QTensor(shape={tuple(self.q.shape)}, dtype={self._dtype})"


def quantize_kernel(w: torch.Tensor, dtype=None) -> QTensor:
    """bf16/fp32 weight -> per-output-channel symmetric int8 QTensor; the
    output channel is axis 0 (dense [out, in], conv OIHW)."""
    wf = w.float()
    amax = wf.abs().amax(dim=tuple(range(1, w.ndim)), keepdim=True)
    s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.round(wf / s).to(torch.int8)
    return QTensor(q, s, dtype or w.dtype)


# tiny I/O boundary convs, and the text encoders' tables (JAX names them
# "weight", not "kernel", so it never quantizes them)
_SKIP_LEAVES = frozenset({"conv_in", "conv_out", "token_embedding", "position_embedding"})


def quantize_base_weights(tree: Any, _name: str = "") -> Any:
    """A copy of a frozen param tree with every 2-D/4-D float "weight" as int8.

    Norm weights and biases (1-D) stay, as do the boundary convs and the
    embedding tables (`_SKIP_LEAVES`); already quantized weights pass
    through, so the transform is idempotent.
    """
    if isinstance(tree, dict):
        w = tree.get("weight")
        if w is not None and not isinstance(w, dict):
            if isinstance(w, QTensor) or _name in _SKIP_LEAVES:
                return tree
            if w.ndim in (2, 4) and w.is_floating_point():
                return dict(tree, weight=quantize_kernel(w))
            return tree
        return {k: quantize_base_weights(v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(quantize_base_weights(v, _name) for v in tree)
    return tree


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def quantized_bytes_saved(tree: Any) -> int:
    """Bytes freed by the quantization, as JAX counts them: one byte per
    int8 code (bf16 -> int8)."""
    saved = 0
    for leaf in _leaves(tree):
        if isinstance(leaf, QTensor):
            leaf = leaf.q
        if torch.is_tensor(leaf) and leaf.dtype == torch.int8:
            saved += leaf.numel()
    return saved


def _tree_bytes(tree) -> int:
    n = 0
    for leaf in _leaves(tree):
        for t in ((leaf.q, leaf.s) if isinstance(leaf, QTensor) else (leaf,)):
            if torch.is_tensor(t):
                n += t.numel() * t.element_size()
    return n


def quantize_frozen(frozen, mode: str) -> float:
    """Quantize a run's frozen models in place; returns the GiB freed.

    The counterpart of the JAX train loop's quantize_base step
    (sd_lora_trainer_tpu/main.py:292-325): "int8" replaces the UNet's
    weights, "int8+te" the text encoders' too (the step then remats the
    conditioning, `StepConfig.remat_te`); "none" changes nothing. The bf16
    originals are dropped with the old trees, so nothing else may hold them;
    create the adapters from the unquantized tree first, as the product does.
    """
    if mode not in ("none", "int8", "int8+te"):
        raise ValueError(f"quantize_base must be 'none', 'int8' or 'int8+te', got {mode!r}")
    fields = {"none": (), "int8": ("unet_params",),
              "int8+te": ("unet_params", "te1_params", "te2_params")}[mode]
    freed = 0
    for field in fields:
        tree = getattr(frozen, field)
        if tree is None:
            continue
        before = _tree_bytes(tree)
        quantized = quantize_base_weights(tree)
        freed += before - _tree_bytes(quantized)
        setattr(frozen, field, quantized)
    return freed / 2**30
