"""Flash attention for the UNet's big self-attention blocks.

Counterpart of sd_lora_trainer_tpu/ops/flash_attention.py. At 1024px SDXL the
top self-attention runs at 4096 image tokens; materializing the
[B, heads, 4096, 4096] logits would waste device memory and bandwidth. Two
hand-written CUDA kernels (csrc/flash_fwd.cu, csrc/flash_bwd.cu) sit behind
one custom op, `sd_lora_torch::flash_attention`, with its backward
registered:

- `flash_fwd`: o and the fp32 log-sum-exp `lse` [B, H, L];
- `flash_bwd`: dQ, dK and dV in one fused pass from q, k, v, dO, lse and
  di = rowsum(o*dO) (the JAX package's two backward kernels, dK/dV and dQ).

Being an op, it is seen by a selective remat policy, which can keep its
outputs and skip the forward kernel in the backward (models/unet.py).

Each wrapper takes the plain PyTorch version (`*_ref`) for a tensor on the
CPU, and for a CUDA tensor launches its kernel or raises. The kernels take
every head dim the JAX gate admits (1-256): they are built for every
round_up(d, 16) from 16 to 256 and read bf16 tiles through TMA, which reads
columns d..round_up(d, 16)-1 as zeros (head dim 40 is read as 48 with no
copy); a head dim that is not a multiple of 8 is zero-padded to one in
device memory and the outputs sliced back (`_at_kernel_head_dim`), since
TMA needs 16-byte row strides. `sm_scale` always uses the real head dim. Ragged
sequence lengths are padded to `_pad_plan` and masked with segment ids (ids 1
below `valid_len`, 0 above), so pad rows attend only to pad keys.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from sd_lora_trainer_tpu_torch.ops.checkpoint_names import checkpoint_name
from sd_lora_trainer_tpu_torch.ops.kernels import HEAD_DIM_TILES, FlashArgs, FlashStrides, kernel_lib
from sd_lora_trainer_tpu_torch.ops.stash8 import dequantize_rowwise, quantize_rowwise

# Kernel launches per wrapper; only a real CUDA launch counts. A launch
# recorded into a CUDA graph (a captured train step, training/step.py) is
# made by each replay of the graph, with no Python: the wrapper records
# beside it an increment of a device counter (`_REPLAYED`), which the
# replays execute. `launch_counts()` reads both; `RECORDED` counts the
# launches recorded into graphs.
LAUNCHES = {"flash_fwd": 0, "flash_bwd": 0}
RECORDED = {"flash_fwd": 0, "flash_bwd": 0}
_REPLAYED: Dict[Tuple[str, torch.device], torch.Tensor] = {}

_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for counter in _REPLAYED.values():
        counter.zero_()


def launch_counts() -> Dict[str, int]:
    """Each kernel's launches: the wrapper's own, and those the replays of
    captured graphs made (read from the device: a wait for the card)."""
    counts = dict(LAUNCHES)
    for (name, _), counter in _REPLAYED.items():
        counts[name] += int(counter)
    return counts


def prepare_graph_counts(device: torch.device) -> None:
    """Allocate `device`'s replay counters; before a capture, which must
    not allocate what outlives it."""
    for name in LAUNCHES:
        if (name, device) not in _REPLAYED:
            _REPLAYED[name, device] = torch.zeros((), dtype=torch.int64, device=device)


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def count_launch(name: str, device: torch.device) -> None:
    """Count one launch of kernel `name` on `device`, just made on the current
    stream: on the host, or, while the stream is captured, on the device."""
    if _capturing():
        counter = _REPLAYED.get((name, device))
        if counter is None:
            raise RuntimeError(f"{name}: captured before prepare_graph_counts({device})")
        counter.add_(1)
        RECORDED[name] += 1
    else:
        LAUNCHES[name] += 1


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def kernel_takes_head_dim(head_dim: int) -> bool:
    """Every head dim up to 256, as the JAX gate: the kernels are built for
    each round_up(d, 16) in HEAD_DIM_TILES (16-256), and a head dim off a
    multiple of 8 is padded to one first (`_at_kernel_head_dim`)."""
    return 1 <= head_dim <= HEAD_DIM_TILES[-1]


def flash_attention_qualifies(q_shape, k_shape, heads: int, device) -> bool:
    """Gate: tensors on CUDA, self-attention of >= 256 tokens, head_dim <= 256,
    as the JAX gate. Cross-attention and short sequences stay plain; every
    qualifying head dim has a kernel (`kernel_takes_head_dim`)."""
    if torch.device(device).type != "cuda":
        return False
    _, lq, d = q_shape
    lk = k_shape[1]
    return lq == lk and lq >= 256 and d // heads <= 256


def _pad_plan(l: int):
    """(padded_len, block_q, block_k) for a self-attention length l.

    The padded lengths equal the JAX package's plan (lengths above 512 that
    are not 1024-multiples pad up to one; lengths <= 512 pad to a
    128-multiple), so both packages mask the same pad tokens. The block
    entries are the TPU kernel's tiles, kept so the plans compare equal; the
    CUDA kernels tile at 128 rows, which divides every padded length.
    """
    if l % 1024 == 0 or (l <= 512 and l % 128 == 0):
        lp = l
    else:
        lp = _round_up(l, 1024 if l > 512 else 128)
    blk_q = min(512, lp)
    blk_k = min(1024, lp)
    if lp % blk_q:
        blk_q = 128
    if lp % blk_k:
        blk_k = 128
    return lp, blk_q, blk_k


# ---------------------------------------------------------------------------
# Plain versions (the CPU path and the kernels' yardstick on the card)
# ---------------------------------------------------------------------------


def _attend_mask(length: int, valid_len: int, device) -> torch.Tensor:
    """[L, L] bool, True where query and key share a segment id."""
    ids = torch.arange(length, device=device) < valid_len
    return ids[:, None] == ids[None, :]


def _probs(q, k, lse, sm_scale, valid_len):
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if valid_len:
        s = s.masked_fill(~_attend_mask(q.shape[2], valid_len, q.device), float("-inf"))
    if lse is None:
        lse = torch.logsumexp(s, dim=-1)
    return torch.exp(s - lse[..., None]), lse


def flash_fwd_ref(q, k, v, sm_scale: float, valid_len: int = 0):
    """(o, lse) of segment-masked attention; q, k, v [B, H, L, d]."""
    p, lse = _probs(q, k, None, sm_scale, valid_len)
    return torch.matmul(p, v.float()).to(q.dtype), lse


def flash_bwd_dkv_ref(q, k, v, do, lse, di, sm_scale: float, valid_len: int = 0):
    """(dk, dv) from the forward's lse and di = rowsum(o * do)."""
    p, _ = _probs(q, k, lse, sm_scale, valid_len)
    dof = do.float()
    dv = torch.matmul(p.transpose(-1, -2), dof)
    ds = p * (torch.matmul(dof, v.float().transpose(-1, -2)) - di[..., None])
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * sm_scale
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_ref(q, k, v, do, lse, di, sm_scale: float, valid_len: int = 0):
    """dq from the forward's lse and di = rowsum(o * do)."""
    p, _ = _probs(q, k, lse, sm_scale, valid_len)
    ds = p * (torch.matmul(do.float(), v.float().transpose(-1, -2)) - di[..., None])
    return (torch.matmul(ds, k.float()) * sm_scale).to(q.dtype)


def flash_bwd_ref(q, k, v, do, lse, di, sm_scale: float, valid_len: int = 0):
    """(dq, dk, dv) from the forward's lse and di = rowsum(o * do)."""
    dk, dv = flash_bwd_dkv_ref(q, k, v, do, lse, di, sm_scale, valid_len)
    return flash_bwd_dq_ref(q, k, v, do, lse, di, sm_scale, valid_len), dk, dv


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _on_cpu(*tensors) -> bool:
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return True
    if devices != {"cuda"}:
        raise ValueError(f"flash attention needs all tensors on one of cpu/cuda, got {devices}")
    return False


def _kernel_readable(x: torch.Tensor) -> bool:
    """A contiguous last dim, 8-element strides and a 16-byte aligned base,
    so the kernels can read rows of 8 elements as one 16-byte load."""
    return x.stride(-1) == 1 and not any(s % 8 for s in x.stride()[:-1]) and x.data_ptr() % 16 == 0


def _check_inputs(q, k, v):
    b, h, length, d = q.shape
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash kernels take bf16 or fp32, got {q.dtype}")
    if not kernel_takes_head_dim(d) or length % 128:
        raise ValueError(f"no flash kernel for head_dim={d}, L={length}: the kernels take "
                         f"head dims 1-{HEAD_DIM_TILES[-1]} and L a multiple of 128, the rows "
                         f"both kernels tile at")
    for name, x in (("k", k), ("v", v)):
        if tuple(x.shape) != tuple(q.shape) or x.dtype != q.dtype:
            raise ValueError(f"{name}: expected {tuple(q.shape)} {q.dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")


def _at_kernel_head_dim(kernel, tensors, *args):
    """kernel(*tensors, *args) with the [B, H, L, d] tensors zero-padded to a
    head dim that is a multiple of 8 (TMA reads rows in 16-byte units) and
    the [B, H, L, d] outputs sliced back to d; [B, H, L] ones (lse, di) pass
    as they are. The zero columns add nothing to q.k and come out as zero
    columns of o, dq, dk and dv: the JAX package pads d = 160 to 256 on the
    same argument."""
    d = tensors[0].shape[-1]
    d8 = _round_up(d, 8)
    if d8 == d:
        return kernel(*tensors, *args)
    padded = [F.pad(x, (0, d8 - d)) if x.dim() == 4 else x for x in tensors]
    return tuple(o[..., :d] if o.dim() == 4 else o for o in kernel(*padded, *args))


def _kernel_operand(name: str, x: torch.Tensor) -> torch.Tensor:
    """x as the kernels read it through TMA, which cannot convert: bf16 (fp32
    is rounded here, the tensor cores' input precision either way), read in
    place when its layout allows it."""
    if x.dtype != torch.bfloat16:
        x = _kernel_layout(x.to(torch.bfloat16))
    if not _kernel_readable(x):
        raise ValueError(f"{name}: needs a contiguous last dim, 8-element strides, 16-byte alignment")
    return x


def _strides(x: torch.Tensor) -> FlashStrides:
    return FlashStrides(*x.stride()[:3])


def _launch(name: str, q, k, v, *, dout=None, out_a, out_b=None, out_c=None, acc=None, sem=None,
            lse, di=None, sm_scale: float, valid_len: int, dtype: torch.dtype) -> None:
    b, h, length, d = q.shape
    none = FlashStrides(0, 0, 0)
    args = FlashArgs(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
        dout=dout.data_ptr() if dout is not None else None,
        out_a=out_a.data_ptr(), out_b=out_b.data_ptr() if out_b is not None else None,
        lse=lse.data_ptr(), di=di.data_ptr() if di is not None else None,
        sq=_strides(q), sk=_strides(k), sv=_strides(v),
        sdo=_strides(dout) if dout is not None else none,
        sa=_strides(out_a), sb=_strides(out_b) if out_b is not None else none,
        batch=b, heads=h, len=length, head_dim=d, sm_scale=sm_scale,
        valid_len=valid_len, dtype=_DTYPE_CODES[dtype],
        out_c=out_c.data_ptr() if out_c is not None else None,
        sc=_strides(out_c) if out_c is not None else none,
        acc=acc.data_ptr() if acc is not None else None,
        sem=sem.data_ptr() if sem is not None else None,
    )
    fn = getattr(kernel_lib(name), name)
    rc = fn(ctypes.byref(args), ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    count_launch(name, q.device)


def _empty_like_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, d] view of a fresh [B, L, H, d] buffer (heads merge for free)."""
    b, h, length, d = x.shape
    return torch.empty(b, length, h, d, dtype=x.dtype, device=x.device).transpose(1, 2)


def flash_fwd(q, k, v, sm_scale: float, valid_len: int = 0):
    """K1: (o [B,H,L,d] in q's dtype, lse fp32 [B,H,L]) for q, k, v [B, H, L, d]."""
    if _on_cpu(q, k, v):
        return flash_fwd_ref(q, k, v, sm_scale, valid_len)
    _check_inputs(q, k, v)
    return _at_kernel_head_dim(_flash_fwd_launch, (q, k, v), sm_scale, valid_len)


def _flash_fwd_launch(q, k, v, sm_scale: float, valid_len: int):
    b, h, length, _ = q.shape
    o = _empty_like_heads(q)
    lse = torch.empty(b, h, length, dtype=torch.float32, device=q.device)
    out_dtype = q.dtype
    q, k, v = (_kernel_operand(n, x) for n, x in (("q", q), ("k", k), ("v", v)))
    _launch("flash_fwd", q, k, v, out_a=o, lse=lse, sm_scale=sm_scale, valid_len=valid_len,
            dtype=out_dtype)
    return o, lse


def _check_residuals(q, do, lse, di):
    if tuple(do.shape) != tuple(q.shape) or do.dtype != q.dtype:
        raise ValueError(f"do: expected {tuple(q.shape)} {q.dtype}, got {tuple(do.shape)} {do.dtype}")
    for name, x in (("lse", lse), ("di", di)):
        if (tuple(x.shape) != tuple(q.shape[:3]) or x.dtype != torch.float32
                or not x.is_contiguous() or x.data_ptr() % 16):
            raise ValueError(f"{name}: expected contiguous 16-byte aligned fp32 {tuple(q.shape[:3])}")


def flash_bwd(q, k, v, do, lse, di, sm_scale: float, valid_len: int = 0):
    """(dq, dk, dv) [B, H, L, d] in q's dtype, one fused kernel launch.

    dq is summed across key tiles in an fp32 buffer in a fixed order (each
    64-row q tile's adds take turns on a counter zeroed here), so every
    launch on the same inputs gives the same bits, as dk and dv do.
    """
    if _on_cpu(q, k, v, do, lse, di):
        return flash_bwd_ref(q, k, v, do, lse, di, sm_scale, valid_len)
    _check_inputs(q, k, v)
    _check_residuals(q, do, lse, di)
    return _at_kernel_head_dim(_flash_bwd_launch, (q, k, v, do, lse, di), sm_scale, valid_len)


def _flash_bwd_launch(q, k, v, do, lse, di, sm_scale: float, valid_len: int):
    b, h, length, d = q.shape
    out_dtype = q.dtype
    dq, dk, dv = _empty_like_heads(q), _empty_like_heads(k), _empty_like_heads(v)
    q, k, v, do = (_kernel_operand(n, x) for n, x in (("q", q), ("k", k), ("v", v), ("do", do)))
    # the kernel's first add into each q tile stores, so acc needs no zeroing;
    # sem counts, per 64-row q tile, the key tiles whose part is in: from zero
    acc = torch.empty(b, h, length, _round_up(d, 16), dtype=torch.float32, device=q.device)
    sem = torch.zeros(b * h * (length // 64), dtype=torch.int32, device=q.device)
    _launch("flash_bwd", q, k, v, dout=do, out_a=dk, out_b=dv, out_c=dq, acc=acc, sem=sem,
            lse=lse, di=di, sm_scale=sm_scale, valid_len=valid_len, dtype=out_dtype)
    return dq, dk, dv


def _kernel_layout(x: torch.Tensor) -> torch.Tensor:
    """x itself when the kernels can read it in place, else a contiguous copy."""
    return x if _kernel_readable(x) else x.contiguous()


# The attention is an op of its own, so that a selective remat policy sees it
# and can keep its outputs (o, lse) for the backward instead of running the
# forward kernel again (models/unet.py, `flash_out*` and `flash_lse*`). Its
# backward is an op too, so that a dispatch mode (FlopCounterMode,
# FakeTensorMode) sees the backward kernel's call, not the ctypes launch.


@torch.library.custom_op("sd_lora_torch::flash_attention_backward", mutates_args=())
def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, sm_scale: float,
                             valid_len: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the attention from its inputs, its outputs o and lse,
    and dO."""
    if do.is_cuda:
        do = _kernel_layout(do)
    # di = rowsum(o * dO) stays plain torch, as it is plain jnp in the JAX bwd
    di = (o.float() * do.float()).sum(-1).contiguous()
    return flash_bwd(q, k, v, do, lse, di, sm_scale, valid_len)


@flash_attention_backward.register_fake
def _(q, k, v, o, lse, do, sm_scale, valid_len):
    return _empty_like_heads(q), _empty_like_heads(k), _empty_like_heads(v)



@torch.library.custom_op("sd_lora_torch::flash_attention", mutates_args=())
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float,
                    valid_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) = softmax(sm_scale * q k^T + segment mask) v over [B, H, L, d];
    lse carries no gradient."""
    return flash_fwd(q, k, v, sm_scale, valid_len)


@flash_attention.register_fake
def _(q, k, v, sm_scale, valid_len):
    return _empty_like_heads(q), q.new_empty(q.shape[:3], dtype=torch.float32)


def _setup_context(ctx, inputs, output):
    q, k, v, sm_scale, valid_len = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.sm_scale, ctx.valid_len = sm_scale, valid_len


def _flash_attention_backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    grads = flash_attention_backward(q, k, v, o, lse, do, ctx.sm_scale, ctx.valid_len)
    return tuple(grads) + (None, None)


flash_attention.register_autograd(_flash_attention_backward, setup_context=_setup_context)


@torch.library.custom_op("sd_lora_torch::flash_attention_stash8", mutates_args=())
def flash_attention_stash8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float,
                           valid_len: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(int8 codes of o, their fp32 row scales, lse): o as a row-wise int8 pair
    (ops/stash8.py), which is what a plan that saves `flash_out` keeps."""
    o, lse = flash_fwd(q, k, v, sm_scale, valid_len)
    return quantize_rowwise(o) + (lse,)


@flash_attention_stash8.register_fake
def _(q, k, v, sm_scale, valid_len):
    return (torch.empty_like(q, dtype=torch.int8), q.new_empty(q.shape[:3] + (1,)),
            q.new_empty(q.shape[:3]))


class _FlashAttentionStash8(torch.autograd.Function):
    """Flash attention whose output õ is the dequantized int8 pair: õ is both
    the output and the backward's residual, as in the JAX `stash8_out`."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale: float, valid_len: int, names):
        with checkpoint_name(*names):
            qo, so, lse = flash_attention_stash8(q, k, v, sm_scale, valid_len)
        ctx.save_for_backward(q, k, v, qo, so, lse)
        ctx.sm_scale, ctx.valid_len = sm_scale, valid_len
        return dequantize_rowwise(qo, so, q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, qo, so, lse = ctx.saved_tensors
        o = dequantize_rowwise(qo, so, q.dtype)
        grads = flash_attention_backward(q, k, v, o, lse, do, ctx.sm_scale, ctx.valid_len)
        return tuple(grads) + (None,) * 3


def flash_mha(q, k, v, heads: int, name_tag: str = "", stash8_out: bool = False,
              pre_padded: int = 0) -> torch.Tensor:
    """[B, L, D] multihead self-attention through the flash kernels.

    The op's outputs are named `flash_out{name_tag}` and `flash_lse{name_tag}`
    (ops/checkpoint_names.py): a remat plan that saves both keeps them and
    does not run the forward kernel again in the backward. `stash8_out` keeps
    o as a row-wise int8 pair instead (ops/stash8.py).

    `pre_padded > 0`: the caller already padded the sequence to this length's
    `_pad_plan` (models/unet.py pads once per spatial-transformer module);
    only the first `pre_padded` tokens are real, the kernels mask the rest
    via segment ids, and the output keeps the padded length.
    """
    b, lq, d = q.shape
    lk = k.shape[1]
    head_dim = d // heads
    sm_scale = 1.0 / math.sqrt(head_dim)
    if pre_padded:
        lp = _pad_plan(pre_padded)[0]
        if not lq == lk == lp:
            raise ValueError(f"pre_padded={pre_padded} needs L={lp}, got {lq}, {lk}")
        valid = pre_padded if pre_padded != lp else 0
    elif lq == lk:
        lp = _pad_plan(lq)[0]
        valid = lq if lp != lq else 0
        if valid:
            q, k, v = (F.pad(x, (0, 0, 0, lp - lq)) for x in (q, k, v))
    else:
        raise ValueError(f"flash_mha is self-attention only, got lq={lq}, lk={lk}")

    def split(x):
        x = x.unflatten(-1, (heads, head_dim)).transpose(1, 2)
        return _kernel_layout(x) if x.is_cuda else x

    names = (f"flash_out{name_tag}", f"flash_lse{name_tag}")
    # the head split (and any copy for the kernels' layout) stays outside the name
    qh, kh, vh = split(q), split(k), split(v)
    if stash8_out:
        out = _FlashAttentionStash8.apply(qh, kh, vh, sm_scale, valid, names)
    else:
        with checkpoint_name(*names):
            out, _ = flash_attention(qh, kh, vh, sm_scale, valid)
    out = out.transpose(1, 2).reshape(b, out.shape[2], d)
    if valid and not pre_padded:
        out = out[:, :lq]
    return out


# ---------------------------------------------------------------------------
# FLOPs of the model's work, for FlopCounterMode (utils/profiling.py)
# ---------------------------------------------------------------------------


def attention_pairs(length: int, valid_len: int) -> int:
    """(query, key) pairs of the model's attention: the real tokens' only.
    The kernels also attend the pad tokens among themselves (the segment
    mask leaves (L - valid)^2 more pairs); that is not the model's work."""
    return (valid_len or length) ** 2


@register_flop_formula([torch.ops.sd_lora_torch.flash_attention,
                        torch.ops.sd_lora_torch.flash_attention_stash8])
def _forward_flops(q_shape, k_shape, v_shape, sm_scale, valid_len, *args, out_shape=None,
                   **kwargs) -> int:
    b, h, length, d = q_shape
    return 4 * b * h * attention_pairs(length, valid_len) * d  # S = QK^T, O = PV


@register_flop_formula(torch.ops.sd_lora_torch.flash_attention_backward)
def _backward_flops(q_shape, k_shape, v_shape, o_shape, lse_shape, do_shape, sm_scale, valid_len,
                    *args, out_shape=None, **kwargs) -> int:
    b, h, length, d = q_shape
    # dP = dO V^T, dV = P^T dO, dQ = dS K, dK = dS^T Q; the fused kernel's
    # recompute of S is not the model's work
    return 8 * b * h * attention_pairs(length, valid_len) * d
