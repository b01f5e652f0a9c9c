"""AdamW with 8-bit block-wise quantized moments (the "AdamW8bit" option).

Counterpart of sd_lora_trainer_tpu/training/quantized_adam.py, in plain
torch (the JAX version is plain XLA, no kernel of its own), without
bitsandbytes. Both moments are uint8 indices into bitsandbytes' dynamic
codebooks (signed for m, unsigned for v; pinned by
tests/golden/bnb_dynamic_map.json) with one fp32 absmax scale per block of
2048 elements. Each tensor is padded to whole blocks on its own, and an
absmax of 0 is read as a scale of 1. A step dequantizes, updates and
requantizes in fp32.

Block order: a block is 2048 consecutive elements of the tensor in the JAX
package's layout (interop.py `jax_layout`: a matrix's transpose, a conv
weight's HWIO), not of the port's storage. Every trainable UNet matrix here
is the transpose of JAX's and every conv weight the OIHW of its HWIO, so
blocks taken in storage order would group other elements under one absmax
scale, and the quantized moments, so the updates, would differ from JAX's.
A saved state says so (`JAX_ORDER_KEY`); one saved without it, whose blocks
followed the storage order, is re-blocked when it is loaded.

Layout: the JAX package updates tensor by tensor, which in eager torch is
tens of kernels for each of a full-finetune UNet's ~1,700 tensors. Here the
padded tensors of one dtype and device are laid out one after another in
flat buffers of about BUCKET elements (a larger tensor gets one of its own),
so a step is a few dozen large ops per buffer. The blocks are the same as
the per-tensor layout's, so the results are too, bit for bit.

The update count lives on the host (`count`, saved in the state) and in a
device tensor that `sync` fills from it, so the bias corrections are
device values and a captured update replays (training/optimizers.py);
the moments are updated in place.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from sd_lora_trainer_tpu_torch.interop import from_jax_order, jax_layout, relaid

BLOCK = 2048
# elements per flat buffer: bounds the step's fp32 temporaries (~1.5 GB)
BUCKET = 1 << 25
# the state entry that marks blocks in JAX's element order
JAX_ORDER_KEY = "blocks_in_jax_order"


def _pad_len(n: int) -> int:
    return (n + BLOCK - 1) // BLOCK * BLOCK


def _create_dynamic_map(signed: bool, max_exponent_bits: int = 7, total_bits: int = 8):
    """bitsandbytes' `create_dynamic_map`: per decade i of 7, 2^i linear
    fraction values (signed) or 2^(i+1) (unsigned), then exact 0 and 1."""
    data = []
    non_sign_bits = total_bits - 1
    additional_items = 2 ** (non_sign_bits - max_exponent_bits) - 1
    for i in range(max_exponent_bits):
        fraction_items = int(
            2 ** (i + non_sign_bits - max_exponent_bits) + 1
            if signed
            else 2 ** (i + non_sign_bits - max_exponent_bits + 1) + 1
        )
        boundaries = np.linspace(0.1, 1, fraction_items)
        means = (boundaries[:-1] + boundaries[1:]) / 2.0
        data += ((10 ** (-(max_exponent_bits - 1) + i)) * means).tolist()
        if signed:
            data += (-(10 ** (-(max_exponent_bits - 1) + i)) * means).tolist()
    if additional_items > 0:
        boundaries = np.linspace(0.1, 1, additional_items + 1)
        means = (boundaries[:-1] + boundaries[1:]) / 2.0
        data += ((10 ** (-(max_exponent_bits - 1) + max_exponent_bits - 1)) * means).tolist()
        if signed:
            data += (-(10 ** (-(max_exponent_bits - 1) + max_exponent_bits - 1)) * means).tolist()
    data.append(0)
    data.append(1.0)
    data += [0] * (256 - len(data))
    data.sort()
    return torch.tensor(data, dtype=torch.float32)


_UMAP = _create_dynamic_map(signed=False)
_SMAP = _create_dynamic_map(signed=True)
# the index of exact 0 in each sorted map (the moments' initial state)
_UZERO = 0
_SZERO = 127


def _nearest_index(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Index of the nearest codebook entry (codebook sorted ascending); a
    tie goes to the right."""
    idx = torch.searchsorted(codebook, x, out_int32=True).clamp_(1, codebook.numel() - 1)
    left, right = codebook[idx - 1], codebook[idx]
    return torch.where((x - left) < (right - x), idx - 1, idx).to(torch.uint8)


def _quantize_blocks(blocks: torch.Tensor, codebook: torch.Tensor):
    """fp32 [n, BLOCK] -> (uint8 indices [n, BLOCK], fp32 scales [n])."""
    absmax = blocks.abs().amax(dim=1, keepdim=True)
    scale = torch.where(absmax > 0, absmax, 1.0)
    return _nearest_index(blocks / scale, codebook), scale[:, 0]


def _dequantize_blocks(q: torch.Tensor, scale: torch.Tensor, codebook: torch.Tensor):
    return codebook[q.int()] * scale[:, None]


def quantize_blockwise(x: torch.Tensor, signed: bool = True):
    """fp32 -> (uint8 codebook indices [n_blocks, BLOCK], fp32 scales [n_blocks])."""
    flat = x.float().reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, _pad_len(flat.numel()) - flat.numel()))
    codebook = (_SMAP if signed else _UMAP).to(x.device)
    return _quantize_blocks(flat.view(-1, BLOCK), codebook)


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor, shape,
                         signed: bool = True) -> torch.Tensor:
    codebook = (_SMAP if signed else _UMAP).to(q.device)
    flat = _dequantize_blocks(q, scale, codebook).reshape(-1)
    return flat[: int(np.prod(shape, dtype=np.int64))].reshape(shape)


class _Bucket:
    """Consecutive tensors of one dtype and device in flat quantized moments;
    tensor j's blocks are rows first_block[j]: first_block[j] + n_blocks[j]."""

    def __init__(self, indices: List[int], params: List[torch.Tensor]):
        self.indices = indices
        self.n_blocks = [_pad_len(p.numel()) // BLOCK for p in params]
        self.first_block = np.cumsum([0] + self.n_blocks[:-1]).tolist()
        n, dev = sum(self.n_blocks), params[0].device
        self.mu_q = torch.full((n, BLOCK), _SZERO, dtype=torch.uint8, device=dev)
        self.nu_q = torch.full((n, BLOCK), _UZERO, dtype=torch.uint8, device=dev)
        self.mu_scale = torch.zeros(n, dtype=torch.float32, device=dev)
        self.nu_scale = torch.zeros(n, dtype=torch.float32, device=dev)

    def views(self, flat: torch.Tensor, params: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each tensor's region of a flat [n_blocks * BLOCK] buffer, in its
        shape, the region holding its elements in the JAX layout's order."""
        return [from_jax_order(flat[f * BLOCK: f * BLOCK + p.numel()], p.shape)
                for f, p in zip(self.first_block, params)]


class AdamW8bit:
    kind = "adamw8bit"

    def __init__(self, params: List[torch.Tensor], b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0, bucket: int = BUCKET):
        self.params = list(params)
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.count = 0
        self.buckets: List[_Bucket] = []
        run: List[int] = []
        size = 0
        for i, p in enumerate(self.params):
            head = self.params[run[0]] if run else p
            if run and ((p.dtype, p.device) != (head.dtype, head.device)
                        or size + _pad_len(p.numel()) > bucket):
                self.buckets.append(_Bucket(run, [self.params[j] for j in run]))
                run, size = [], 0
            run.append(i)
            size += _pad_len(p.numel())
        if run:
            self.buckets.append(_Bucket(run, [self.params[j] for j in run]))
        self._where = {i: (bk, j) for bk in self.buckets for j, i in enumerate(bk.indices)}
        device = self.params[0].device
        self._smap, self._umap = _SMAP.to(device), _UMAP.to(device)
        self._count_t = torch.zeros((), dtype=torch.float32, device=device)

    def sync(self) -> None:
        self._count_t.fill_(self.count)

    def bias_corrections(self):
        """(1 - b1^n, 1 - b2^n) for this update's n, in fp32 as the JAX
        package has them, 0-d on the device."""
        count = self._count_t + 1.0
        return 1.0 - self.b1**count, 1.0 - self.b2**count

    @torch.no_grad()
    def update(self, lr) -> None:
        """One update of every tensor from its .grad (a missing grad is 0)
        at `lr` (a float, or a 0-d device tensor): device work only."""
        bc1, bc2 = self.bias_corrections()
        b1, b2 = self.b1, self.b2
        for bk in self.buckets:
            params = [self.params[j] for j in bk.indices]
            n = sum(bk.n_blocks) * BLOCK
            device = params[0].device
            g = torch.zeros(n, dtype=torch.float32, device=device)
            with_grad = [i for i, p in enumerate(params) if p.grad is not None]
            views = bk.views(g, params)
            if with_grad:
                torch._foreach_copy_([views[i] for i in with_grad],
                                     [params[i].grad for i in with_grad])
            g = g.view(-1, BLOCK)
            m = b1 * _dequantize_blocks(bk.mu_q, bk.mu_scale, self._smap) + (1 - b1) * g
            v = b2 * _dequantize_blocks(bk.nu_q, bk.nu_scale, self._umap) + (1 - b2) * g * g
            del g
            update = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.weight_decay:
                p32 = torch.zeros(n, dtype=torch.float32, device=device)
                torch._foreach_copy_(bk.views(p32, params), params)
                update += self.weight_decay * p32.view(-1, BLOCK)
                del p32
            update = (-lr * update).to(params[0].dtype).reshape(-1)
            for q, scale, (new_q, new_scale) in (
                    (bk.mu_q, bk.mu_scale, _quantize_blocks(m, self._smap)),
                    (bk.nu_q, bk.nu_scale, _quantize_blocks(v, self._umap))):
                q.copy_(new_q)
                scale.copy_(new_scale)
            del m, v
            torch._foreach_add_(params, bk.views(update, params))

    def advance(self) -> None:
        self.count += 1

    def step(self, lr) -> None:
        self.sync()
        self.update(lr)
        self.advance()

    def moments(self, i: int) -> Dict[str, torch.Tensor]:
        """Tensor i's quantized moments: views of its rows of the flat buffers."""
        bk, j = self._where[i]
        f, nb = bk.first_block[j], bk.n_blocks[j]
        return {"mu_q": bk.mu_q[f:f + nb], "mu_scale": bk.mu_scale[f:f + nb],
                "nu_q": bk.nu_q[f:f + nb], "nu_scale": bk.nu_scale[f:f + nb]}

    def state_tensors(self) -> Dict[str, torch.Tensor]:
        out = {"count": torch.tensor(self.count, dtype=torch.int64),
               JAX_ORDER_KEY: torch.tensor(1, dtype=torch.int64)}
        for i in range(len(self.params)):
            for name, t in self.moments(i).items():
                out[f"{name}.{i:05d}"] = t
        return out

    @torch.no_grad()
    def load_state_tensors(self, sd: Dict[str, torch.Tensor]) -> None:
        """Copy a state of `state_tensors` in. A state without
        `JAX_ORDER_KEY` has its blocks in the port's storage order: each
        matrix's and conv weight's moments are dequantized in that order
        and quantized anew in JAX's. An fsdp shard's whole tensor is not at
        hand, so such a state is refused there."""
        self.count = int(sd["count"])
        old = JAX_ORDER_KEY not in sd
        for i, p in enumerate(self.params):
            saved = {name: sd[f"{name}.{i:05d}"] for name in self.moments(i)}
            if old and relaid(len(getattr(p, "fsdp_whole_shape", ()))):
                raise ValueError(
                    "this AdamW8bit state has its blocks in the port's storage order, which an "
                    "fsdp shard cannot re-block: resume it without fsdp, or start anew")
            if old and relaid(p.ndim):
                saved = _reblocked(saved, p.shape, p.device)
            for name, t in self.moments(i).items():
                t.copy_(saved[name])


def _reblocked(saved: Dict[str, torch.Tensor], shape, device) -> Dict[str, torch.Tensor]:
    """One tensor's quantized moments, blocked in storage order, blocked in
    JAX's element order (dequantized, then quantized anew)."""
    out = {}
    for m, signed in (("mu", True), ("nu", False)):
        x = dequantize_blockwise(saved[f"{m}_q"].to(device), saved[f"{m}_scale"].to(device),
                                 shape, signed=signed)
        out[f"{m}_q"], out[f"{m}_scale"] = quantize_blockwise(jax_layout(x), signed=signed)
    return out
