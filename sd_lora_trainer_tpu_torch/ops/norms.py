"""LayerNorm and GroupNorm (with an optional fused SiLU) through hand-written
CUDA kernels (csrc/norm.cu), for the port's norm layer (models/layers.py).

Each norm has here:

- its plain PyTorch version (`layer_norm_ref`, `group_norm_ref`): the
  formulas the layer has always run, fp32 statistics and affine and the
  output cast back to x's dtype (`F.silu` after it for the fused form);
- plain versions of what its kernels compute (`*_fwd_ref`: the output and
  the fp32 mean and rstd kept for the backward; `*_bwd_ref`: dx, and dγ and
  dβ where asked for, from x, dy and those statistics): the
  `torch.autograd.Function`'s forward and backward for a tensor off the
  card, so that a CPU test can hold the backward's algebra against autograd
  through the plain version;
- a `torch.autograd.Function` (`_LayerNorm`, `_GroupNorm`) whose forward and
  backward launch the kernels for CUDA tensors.

`layer_norm` and `group_norm` take the plain version for a tensor that is
not on a card (CPU, meta, fake: every CPU test reads the formulas it always
read), and the Function for a CUDA tensor, which launches the kernels or
raises. The kernels read x in its dtype (bf16 or fp32), take γ and β in bf16
or fp32, keep the statistics and the affine in fp32 and round the output
once; the fused form's SiLU is applied before that rounding.

The tile sizes come from the shape alone (`layer_plan`, `group_plan`): one
algorithm a norm, its tiles adapted to C, C / G and the rows. A LayerNorm row
that does not fit a warp's registers (C beyond 32 x 16 bytes x 10 vectors, or
C off a 16-byte multiple) runs as a GroupNorm of one group and one row a
sample.

Launches: `LAUNCHES` counts the forwards (`norm_fwd`) and backwards
(`norm_bwd`) made outside a CUDA graph. A launch recorded into a graph (the
captured train step) hands the kernel a device counter that the kernel's
last block adds one to at each replay: no graph node of its own, where an
`add_` beside each of the ~900 norm calls of an SDXL step would cost ~2 ms
of a replay. `RECORDED` counts the launches recorded into graphs.
`launch_counts()` reads both, as ops/flash_attention.py's does flash's.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from sd_lora_trainer_tpu_torch.ops.kernels import NormArgs, kernel_lib

LAUNCHES = {"norm_fwd": 0, "norm_bwd": 0}
RECORDED = {"norm_fwd": 0, "norm_bwd": 0}
_REPLAYED: Dict[Tuple[str, torch.device], torch.Tensor] = {}

_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
# csrc/norm.cu: a LayerNorm block is 8 warps, a row a warp, the row held as
# NV 16-byte vectors a lane for these NV
LAYER_WARPS = 8
LAYER_VECTORS = (1, 2, 3, 4, 5, 6, 8, 10)
# the LayerNorm backward's blocks when it sums dγ and dβ (a partial a block)
AFFINE_BLOCKS = 264
# a GroupNorm block: C / vec threads across a row, as many rows at once as
# fill GROUP_THREADS (at most GROUP_MAX_THREADS threads); about GROUP_BLOCKS
# blocks over (sample, tile)
GROUP_THREADS = 256
GROUP_MAX_THREADS = 512
GROUP_BLOCKS = 1024


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for counter in _REPLAYED.values():
        counter.zero_()


def launch_counts() -> Dict[str, int]:
    """Each direction's launches: the wrappers' own and those the replays of
    captured graphs made (read from the device: a wait for the card)."""
    counts = dict(LAUNCHES)
    for (name, _), counter in _REPLAYED.items():
        counts[name] += int(counter)
    return counts


def _card(device) -> torch.device:
    """`device` with its index where it is a card ("cuda" is the current one)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def prepare_graph_counts(device: torch.device) -> None:
    """Allocate `device`'s replay counters; before a capture, which must not
    allocate what outlives it."""
    device = _card(device)
    for name in LAUNCHES:
        if (name, device) not in _REPLAYED:
            _REPLAYED[name, device] = torch.zeros((), dtype=torch.int64, device=device)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# Tiles, from the shape alone
# ---------------------------------------------------------------------------


def layer_plan(rows: int, channels: int, itemsize: int, affine: bool) -> Optional[Tuple[int, int]]:
    """(NV, blocks) of the LayerNorm kernels for [rows, channels], or None
    where a row does not fit a warp's registers as 16-byte vectors."""
    vec = 16 // itemsize
    need = _cdiv(channels, 32 * vec)
    nv = next((n for n in LAYER_VECTORS if n >= need), None)
    if channels % vec or nv is None:
        return None
    blocks = _cdiv(rows, LAYER_WARPS)
    return nv, min(blocks, AFFINE_BLOCKS) if affine else blocks


def group_plan(batch: int, rows: int, channels: int,
               itemsize: int) -> Tuple[int, int, int, int, int]:
    """(vec, cols, rpi, tile, tiles) of the GroupNorm kernels for [batch,
    rows, channels]: elements a thread loads at once (16 bytes' worth where C
    allows it, else 1), threads across a row, rows a block reads at once,
    rows a tile (a block's) and tiles a sample."""
    vec = 16 // itemsize
    if channels % vec:
        vec = 1
    cols = channels // vec
    if cols > GROUP_MAX_THREADS:
        raise ValueError(f"group_norm: {channels} channels take {cols} loads a row; the kernel "
                         f"takes at most {GROUP_MAX_THREADS}")
    rpi = max(1, GROUP_THREADS // cols)
    per_sample = max(1, min(_cdiv(GROUP_BLOCKS, batch), _cdiv(rows, rpi)))
    tile = _cdiv(_cdiv(rows, per_sample), rpi) * rpi
    return vec, cols, rpi, tile, _cdiv(rows, tile)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _grouped(x: torch.Tensor, groups: int) -> torch.Tensor:
    """x [B, ..., C] as fp32 [B, rows, G, C / G]."""
    b, c = x.shape[0], x.shape[-1]
    return x.float().reshape(b, -1, groups, c // groups)


def group_norm_fwd_ref(x, weight, bias, groups: int, eps: float, silu: bool = False):
    """(out, mean, rstd): the norm of x [B, ..., C] over each sample's
    groups of C / G adjacent channels, fp32 statistics (mean and rstd
    [B, G]), cast to x's dtype, then SiLU'd when `silu`."""
    xf = _grouped(x, groups)
    var, mean = torch.var_mean(xf, dim=(1, 3), keepdim=True, correction=0)
    rstd = torch.rsqrt(var + eps)
    xf = ((xf - mean) * rstd).reshape(x.shape)
    out = (xf * weight.float() + bias.float()).to(x.dtype)
    if silu:
        out = F.silu(out)
    return out, mean.reshape(x.shape[0], groups), rstd.reshape(x.shape[0], groups)


def group_norm_ref(x, weight, bias, groups: int, eps: float, silu: bool = False) -> torch.Tensor:
    """GroupNorm over the channel (last) axis, fp32 statistics; SiLU after it
    when `silu`."""
    return group_norm_fwd_ref(x, weight, bias, groups, eps, silu)[0]


def group_norm_bwd_ref(x, dy, weight, bias, mean, rstd, groups: int, silu: bool,
                       need_weight: bool = False, need_bias: bool = False):
    """(dx, dγ or None, dβ or None) as the kernels compute them: x̂ from the
    kept statistics, the gradient at the norm's output dy' (through the SiLU,
    recomputed, when `silu`), g = dy' γ, dx = rstd (g - mean(g) - x̂ mean(g
    x̂)) over each sample's group, all in fp32."""
    xf = _grouped(x, groups)
    shape = xf.shape
    mean, rstd = mean.reshape(shape[0], 1, groups, 1), rstd.reshape(shape[0], 1, groups, 1)
    w, bb = weight.float().reshape(groups, -1), bias.float().reshape(groups, -1)
    xh = (xf - mean) * rstd
    d = dy.float().reshape(shape)
    if silu:
        y = xh * w + bb
        s = torch.sigmoid(y)
        d = d * s * (1 + y * (1 - s))
    g = d * w
    n = shape[1] * shape[3]
    c1 = g.sum(dim=(1, 3), keepdim=True) / n
    c2 = (g * xh).sum(dim=(1, 3), keepdim=True) / n
    dx = (rstd * (g - c1 - xh * c2)).reshape(x.shape).to(x.dtype)
    dw = (d * xh).sum(dim=(0, 1)).reshape(-1).to(weight.dtype) if need_weight else None
    db = d.sum(dim=(0, 1)).reshape(-1).to(bias.dtype) if need_bias else None
    return dx, dw, db


def layer_norm_fwd_ref(x, weight, bias, eps: float):
    """(out, mean, rstd): LayerNorm over the last axis in fp32, cast to x's
    dtype; mean and rstd fp32, one a row."""
    c = x.shape[-1]
    out = F.layer_norm(x.float(), (c,), weight.float(), bias.float(), eps).to(x.dtype)
    var, mean = torch.var_mean(x.float().reshape(-1, c), dim=-1, correction=0)
    return out, mean, torch.rsqrt(var + eps)


def layer_norm_ref(x, weight, bias, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis, fp32 statistics."""
    c = x.shape[-1]
    return F.layer_norm(x.float(), (c,), weight.float(), bias.float(), eps).to(x.dtype)


def layer_norm_bwd_ref(x, dy, weight, bias, mean, rstd, need_weight: bool = False,
                       need_bias: bool = False):
    """(dx, dγ or None, dβ or None) as the kernels compute them, in fp32:
    dx = rstd (g - mean(g) - x̂ mean(g x̂)) over each row, g = dy γ."""
    c = x.shape[-1]
    xh = (x.float().reshape(-1, c) - mean[:, None]) * rstd[:, None]
    d = dy.float().reshape(-1, c)
    g = d * weight.float()
    dx = rstd[:, None] * (g - g.mean(-1, keepdim=True) - xh * (g * xh).mean(-1, keepdim=True))
    dw = (d * xh).sum(0).to(weight.dtype) if need_weight else None
    db = d.sum(0).to(bias.dtype) if need_bias else None
    return dx.reshape(x.shape).to(x.dtype), dw, db


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _operand(name: str, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x contiguous and 16-byte aligned (a copy where it is not), in `dtype`."""
    if x.dtype != dtype:
        raise TypeError(f"norm kernels: {name} is {x.dtype}, expected {dtype}")
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _param(name: str, p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if p.device != x.device or p.numel() != x.shape[-1]:
        raise ValueError(f"norm kernels: {name} must be [{x.shape[-1]}] on {x.device}, got "
                         f"{tuple(p.shape)} on {p.device}")
    if p.dtype not in _DTYPE_CODES:
        p = p.float()
    p = p.reshape(-1).contiguous()  # read as 16-byte vectors: aligned
    return p if p.data_ptr() % 16 == 0 else p.clone()


def _check_x(x: torch.Tensor) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"norm kernels take bf16 or fp32, got {x.dtype}")
    if x.numel() == 0:
        raise ValueError(f"norm kernels: empty input {tuple(x.shape)}")


def _launch(fn: str, direction: str, x: torch.Tensor, weight: torch.Tensor, **fields) -> None:
    """Launch `fn` of csrc/norm.cu on the current stream, counting it under
    `direction`: on the host, or while the stream is captured, by the kernel
    on the device counter that each replay then advances."""
    device = _card(x.device)
    counter = None
    if _capturing():
        counter = _REPLAYED.get((direction, device))
        if counter is None:
            raise RuntimeError(f"{direction}: captured before prepare_graph_counts({device})")
    ptrs = {k: (v.data_ptr() if v is not None else None) for k, v in fields.items()
            if isinstance(v, torch.Tensor) or v is None}
    plain = {k: v for k, v in fields.items() if k not in ptrs}
    args = NormArgs(x=x.data_ptr(), weight=weight.data_ptr(),
                    counter=counter.data_ptr() if counter is not None else None,
                    dtype=_DTYPE_CODES[x.dtype], wdtype=_DTYPE_CODES[weight.dtype],
                    **ptrs, **plain)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(kernel_lib("norm"), fn)(ctypes.byref(args), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError {rc}")
    if counter is None:
        LAUNCHES[direction] += 1
    else:
        RECORDED[direction] += 1


def _empty_stats(shape, x: torch.Tensor):
    return (torch.empty(shape, dtype=torch.float32, device=x.device),
            torch.empty(shape, dtype=torch.float32, device=x.device))


def _group_fields(x: torch.Tensor, groups: int):
    b, c = x.shape[0], x.shape[-1]
    rows = x.numel() // (b * c)
    vec, cols, rpi, tile, tiles = group_plan(b, rows, c, x.element_size())
    return dict(rows=rows, batch=b, channels=c, groups=groups, vec=vec, cols=cols, rpi=rpi,
                tile=tile, tiles=tiles)


def group_norm_fwd_kernel(x, weight, bias, groups: int, eps: float, silu: bool = False):
    """`group_norm_fwd_ref` on the card: (out, mean [B, G], rstd [B, G])."""
    _check_x(x)
    x = _operand("x", x, x.dtype)
    w, b = _param("weight", weight, x), _param("bias", bias, x)
    fields = _group_fields(x, groups)
    out = torch.empty_like(x)
    mean, rstd = _empty_stats((fields["batch"], groups), x)
    work = torch.empty(fields["batch"] * fields["tiles"] * groups * 2, dtype=torch.float32,
                       device=x.device)
    _launch("norm_group_forward", "norm_fwd", x, w, bias=b, out=out, mean=mean, rstd=rstd,
            work=work, eps=eps, silu=int(silu), **fields)
    return out, mean, rstd


def group_norm_bwd_kernel(x, dy, weight, bias, mean, rstd, groups: int, silu: bool,
                          need_weight: bool = False, need_bias: bool = False):
    """`group_norm_bwd_ref` on the card."""
    _check_x(x)
    x, dy = _operand("x", x, x.dtype), _operand("dy", dy, x.dtype)
    w, b = _param("weight", weight, x), _param("bias", bias, x)
    fields = _group_fields(x, groups)
    n, c = fields["batch"] * fields["tiles"], fields["channels"]
    dx = torch.empty_like(x)
    dw = torch.empty_like(w) if need_weight else None
    db = torch.empty_like(w) if need_bias else None
    work = torch.empty((n * c + fields["batch"] * groups) * 2, dtype=torch.float32,
                       device=x.device)
    _launch("norm_group_backward", "norm_bwd", x, w, dy=dy, bias=b, out=dx,
            mean=mean.contiguous(), rstd=rstd.contiguous(), work=work, dweight=dw, dbias=db,
            silu=int(silu), **fields)
    return dx, _as(dw, weight), _as(db, bias)


def _as(g: Optional[torch.Tensor], p: torch.Tensor) -> Optional[torch.Tensor]:
    return None if g is None else g.to(p.dtype).reshape(p.shape)


def layer_norm_fwd_kernel(x, weight, bias, eps: float):
    """`layer_norm_fwd_ref` on the card: (out, mean [rows], rstd [rows])."""
    _check_x(x)
    c = x.shape[-1]
    rows = x.numel() // c
    plan = layer_plan(rows, c, x.element_size(), affine=False)
    if plan is None:
        out, mean, rstd = group_norm_fwd_kernel(x.reshape(rows, 1, c), weight, bias, 1, eps)
        return out.reshape(x.shape), mean.reshape(rows), rstd.reshape(rows)
    x = _operand("x", x, x.dtype)
    w, b = _param("weight", weight, x), _param("bias", bias, x)
    out = torch.empty_like(x)
    mean, rstd = _empty_stats((rows,), x)
    nv, blocks = plan
    _launch("norm_layer_forward", "norm_fwd", x, w, bias=b, out=out, mean=mean, rstd=rstd,
            rows=rows, channels=c, vec=16 // x.element_size(), nv=nv, blocks=blocks, eps=eps)
    return out, mean, rstd


def layer_norm_bwd_kernel(x, dy, weight, bias, mean, rstd, need_weight: bool = False,
                          need_bias: bool = False):
    """`layer_norm_bwd_ref` on the card."""
    _check_x(x)
    c = x.shape[-1]
    rows = x.numel() // c
    affine = need_weight or need_bias
    plan = layer_plan(rows, c, x.element_size(), affine)
    if plan is None:
        dx, dw, db = group_norm_bwd_kernel(x.reshape(rows, 1, c), dy.reshape(rows, 1, c), weight,
                                           bias, mean, rstd, 1, False, need_weight, need_bias)
        return dx.reshape(x.shape), dw, db
    x, dy = _operand("x", x, x.dtype), _operand("dy", dy, x.dtype)
    w, b = _param("weight", weight, x), _param("bias", bias, x)
    nv, blocks = plan
    dx = torch.empty_like(x)
    dw = torch.empty_like(w) if need_weight else None
    db = torch.empty_like(w) if need_bias else None
    work = (torch.empty(blocks * c * 2, dtype=torch.float32, device=x.device) if affine
            else None)
    _launch("norm_layer_backward", "norm_bwd", x, w, dy=dy, bias=b, out=dx,
            mean=mean.contiguous(), rstd=rstd.contiguous(), work=work, dweight=dw, dbias=db,
            rows=rows, channels=c, vec=16 // x.element_size(), nv=nv, blocks=blocks)
    return dx, _as(dw, weight), _as(db, bias)


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------


class _GroupNorm(torch.autograd.Function):
    """GroupNorm (+SiLU): the kernels on a card, the `*_ref` algebra off it."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups: int, eps: float, silu: bool):
        fwd = group_norm_fwd_kernel if x.is_cuda else group_norm_fwd_ref
        out, mean, rstd = fwd(x, weight, bias, groups, eps, silu)
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        ctx.groups, ctx.silu = groups, silu
        return out

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mean, rstd = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        bwd = group_norm_bwd_kernel if x.is_cuda else group_norm_bwd_ref
        dx, dw, db = bwd(x, dy, weight, bias, mean, rstd, ctx.groups, ctx.silu, need_w, need_b)
        return dx if need_x else None, dw, db, None, None, None


class _LayerNorm(torch.autograd.Function):
    """LayerNorm: the kernels on a card, the `*_ref` algebra off it."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float):
        fwd = layer_norm_fwd_kernel if x.is_cuda else layer_norm_fwd_ref
        out, mean, rstd = fwd(x, weight, bias, eps)
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mean, rstd = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        bwd = layer_norm_bwd_kernel if x.is_cuda else layer_norm_bwd_ref
        dx, dw, db = bwd(x, dy, weight, bias, mean, rstd, need_w, need_b)
        return dx if need_x else None, dw, db, None


def group_norm(x, weight, bias, groups: int, eps: float, silu: bool = False) -> torch.Tensor:
    """GroupNorm of x [B, ..., C] (SiLU'd when `silu`): the kernels for a CUDA
    tensor, the plain version for any other."""
    if x.device.type != "cuda":
        return group_norm_ref(x, weight, bias, groups, eps, silu)
    return _GroupNorm.apply(x, weight, bias, groups, eps, silu)


def layer_norm(x, weight, bias, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis: the kernels for a CUDA tensor, the plain
    version for any other."""
    if x.device.type != "cuda":
        return layer_norm_ref(x, weight, bias, eps)
    return _LayerNorm.apply(x, weight, bias, eps)
