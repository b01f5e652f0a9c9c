"""The mesh, its collectives and the sharding rules of parallel training.

Counterpart of sd_lora_trainer_tpu/parallel/sharding.py. JAX annotates arrays
with shardings and XLA inserts the collectives; eager PyTorch runs them by
hand, one process per card, over `torch.distributed` process groups:

- **dp** (LoRA, TI, TE-LoRA): every trainable replicates; each rank computes
  the loss on its own rows of the global batch and the gradients are averaged
  over the "data" group in flat buckets per dtype.
- **fsdp** (full finetune): each trainable UNet tensor is kept as its rank's
  shard of its elements flattened in the JAX layout's order (AdamW8bit's
  block order, interop.py `jax_layout`), padded to whole
  blocks (`FsdpShards`).
  A down/mid/up layer all-gathers its tensors in one flat bucket when it
  runs (inside its remat region, so the recompute gathers again) and the
  gradients come back through the gather's backward, one reduce-scatter.
  TI and TE-LoRA replicate.
- **tp** (LoRA): a data x model grid. The frozen UNet's attention and GEGLU
  projections are Megatron-split over the "model" group (`shard_unet_tp`):
  to_q/to_k/to_v and ff.net.0.proj by output features, to_out.0 and ff.net.2
  by input features, so self-attention runs on each rank's own heads (the
  flash kernels on the card) and one all-reduce closes each row split.
  Adapters replicate; one on a split projection enters the model group
  where the projection uses it, so the part of its gradient each rank
  computes there is summed over the group (and a term every rank computes
  whole, the L1 penalty, is not).

The frozen base replicates in dp and fsdp, as in JAX. Every collective goes
through a `Group` method, which counts its calls and bytes by kind
(`collective_stats`, the counterpart of JAX's HLO count). A collective the
backend refuses raises.
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from sd_lora_trainer_tpu_torch.interop import from_jax_order, jax_layout
from sd_lora_trainer_tpu_torch.training.quantized_adam import BLOCK

# torch >= 2.12 renames the tensor collectives; the old names are what older
# torch has, so they stay
warnings.filterwarnings("ignore", message=r".*(all_gather_into_tensor|reduce_scatter_tensor)"
                        r"` is deprecated", category=FutureWarning)

_STATS: Dict[str, Dict[str, int]] = {}


def reset_collective_stats() -> None:
    _STATS.clear()


def collective_stats() -> dict:
    """{kind: {"calls", "bytes"}} since the last reset, plus "total_bytes".
    Bytes are each collective's output, as JAX's `collective_stats` counts
    them; a group of one process runs no collective and counts nothing."""
    out = {k: dict(v) for k, v in _STATS.items()}
    out["total_bytes"] = sum(v["bytes"] for v in _STATS.values())
    return out


def _count(kind: str, t: torch.Tensor) -> None:
    entry = _STATS.setdefault(kind, {"calls": 0, "bytes": 0})
    entry["calls"] += 1
    entry["bytes"] += t.numel() * t.element_size()


class Group:
    """One process group of the mesh and the collectives run over it."""

    def __init__(self, pg, size: int, rank: int):
        self.pg, self.size, self.rank = pg, size, rank

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the group, in place."""
        if self.size == 1:
            return t
        dist.all_reduce(t, group=self.pg)
        _count("all_reduce", t)
        return t

    def all_gather(self, shard: torch.Tensor) -> torch.Tensor:
        """The ranks' shards concatenated along dim 0, in rank order."""
        if self.size == 1:
            return shard
        shard = shard.contiguous()
        out = shard.new_empty((self.size * shard.shape[0],) + tuple(shard.shape[1:]))
        dist.all_gather_into_tensor(out, shard, group=self.pg)
        _count("all_gather", out)
        return out

    def reduce_scatter(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice along dim 0 of the sum of every rank's `full`."""
        if self.size == 1:
            return full
        full = full.contiguous()
        out = full.new_empty((full.shape[0] // self.size,) + tuple(full.shape[1:]))
        dist.reduce_scatter_tensor(out, full, group=self.pg)
        _count("reduce_scatter", out)
        return out

    def average(self, t: torch.Tensor) -> torch.Tensor:
        """The group's mean of `t` as the value, with the gradient of the
        local `t` (what a global batch mean gives each rank's rows)."""
        if self.size == 1:
            return t
        mean = self.all_reduce_(t.detach().clone()) / self.size
        return t + (mean - t).detach()

    def total(self, t: torch.Tensor) -> torch.Tensor:
        """The group's sum of a tensor that carries no gradient."""
        return self.all_reduce_(t.detach().clone())


class Mesh:
    """The data x model grid of the processes (rank = data * n_model + model,
    JAX's `create_mesh_2d` order) and its process groups. One process runs
    one device. Without a process group it is the mesh of one device."""

    def __init__(self, n_data: int, n_model: int = 1, device="cpu"):
        self.device = torch.device(device)
        initialized = dist.is_available() and dist.is_initialized()
        self.world = dist.get_world_size() if initialized else 1
        self.rank = dist.get_rank() if initialized else 0
        if n_data * n_model != self.world:
            raise ValueError(f"a {n_data} x {n_model} mesh needs {n_data * n_model} processes, "
                             f"the group has {self.world}")
        self.n_data, self.n_model = n_data, n_model
        self.data_rank, self.model_rank = divmod(self.rank, n_model)
        self.backend = dist.get_backend() if initialized else "none"
        data_pg = model_pg = None
        if initialized:
            # every rank creates every group, in the same order
            for m in range(n_model):
                pg = dist.new_group([d * n_model + m for d in range(n_data)])
                if m == self.model_rank:
                    data_pg = pg
            for d in range(n_data):
                pg = dist.new_group([d * n_model + m for m in range(n_model)])
                if d == self.data_rank:
                    model_pg = pg
        self.data = Group(data_pg, n_data, self.data_rank)
        self.model = Group(model_pg, n_model, self.model_rank)

    @property
    def is_main(self) -> bool:
        return self.rank == 0


# ---------------------------------------------------------------------------
# Collectives that gradients flow through
# ---------------------------------------------------------------------------


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, group: Group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce_(g.contiguous().clone()), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: the sum over the model group forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group: Group):
        return group.all_reduce_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherBucket(torch.autograd.Function):
    """Whole tensors from their flat shards (one dtype) in one all-gather;
    backward, their gradients in one reduce-scatter (summed over the
    group). Rank r's bucket is its shards back to back, so the gathered
    buffer is [ranks, bucket] and a tensor is its columns, rank by rank."""

    @staticmethod
    def forward(ctx, group: Group, shapes, *shards):
        ctx.group, ctx.lens = group, [s.numel() for s in shards]
        flat = torch.cat([s.reshape(-1) for s in shards])
        full = group.all_gather(flat).view(group.size, -1)
        return tuple(from_jax_order(part.reshape(-1)[:math.prod(shape)], shape)
                     for part, shape in zip(full.split(ctx.lens, dim=1), shapes))

    @staticmethod
    def backward(ctx, *grads):
        # each gradient's flat storage into its columns of one [ranks, bucket]
        # buffer (the zeros are the padding), one reduce-scatter of it
        buf = grads[0].new_zeros(ctx.group.size, sum(ctx.lens))
        for g, col in zip(grads, buf.split(ctx.lens, dim=1)):
            k, flat = col.shape[1], jax_layout(g).reshape(-1)
            rows, rest = divmod(flat.numel(), k)
            col[:rows].copy_(flat[:rows * k].view(rows, k))
            if rest:
                col[rows, :rest].copy_(flat[rows * k:])
        shards = ctx.group.reduce_scatter(buf.view(-1))
        return (None, None) + tuple(shards.split(ctx.lens))


def copy_to_model(x: torch.Tensor, group: Group) -> torch.Tensor:
    return x if group.size == 1 else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group: Group) -> torch.Tensor:
    return x if group.size == 1 else _ReduceFromModel.apply(x, group)


# ---------------------------------------------------------------------------
# Group rules (the JAX package's `trainable_shardings` and
# `optimizer_state_shardings`), as PartitionSpec-like tuples: () replicates,
# ("data",) shards the flat storage over the data group
# ---------------------------------------------------------------------------


def _map(tree, fn, path=()):
    if torch.is_tensor(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn, path + (str(i),)) for i, v in enumerate(tree)]
    return tree


def fsdp_spec(leaf: torch.Tensor, n: int) -> tuple:
    """The flat storage sharded over the data group, padded to whole blocks;
    a 0-d tensor replicates."""
    return ("data",) if leaf.ndim > 0 and n > 1 else ()


def trainable_shardings(trainable: dict, mode: str, n: int) -> dict:
    """dp and tp replicate every trainable (adapters are MBs; under tp the
    frozen base is what splits); fsdp shards the `unet` group and replicates
    TI and TE-LoRA."""
    return {group: _map(sub, lambda p, t: fsdp_spec(t, n)
                        if (mode == "fsdp" and group == "unet") else ())
            for group, sub in trainable.items()}


def state_param_index(key: str) -> Optional[int]:
    """The index in its group of the tensor a per-tensor optimizer state key
    ("<name>.<index>") belongs to; None for a group's own scalars."""
    name, _, idx = key.rpartition(".")
    return int(idx) if name and idx.isdigit() else None


def optimizer_state_shardings(optimizer, trainable_sh: dict) -> dict:
    """{"<group>.<state key>": spec} for a GroupOptimizer's state: a
    per-tensor entry follows its tensor's spec, so a moment follows its
    group's rule, never its shape (a TI row shaped like a UNet tensor still
    replicates); 0-d entries (counters, Prodigy's d) replicate."""
    out = {}
    for name, opt in optimizer.groups.items():
        specs = list(_flat_specs(trainable_sh[name]))
        for key, value in opt.state_tensors().items():
            idx = state_param_index(key)
            out[f"{name}.{key}"] = specs[idx] if idx is not None and value.ndim > 0 else ()
    return out


def _flat_specs(tree):
    if isinstance(tree, tuple):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _flat_specs(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _flat_specs(v)


# ---------------------------------------------------------------------------
# Tensor parallelism: the frozen UNet's Megatron split, torch [out, in] layout
# ---------------------------------------------------------------------------

_TP_ATTN_COL = ("to_q", "to_k", "to_v")


def unet_tp_spec(path, leaf: torch.Tensor, n: int) -> tuple:
    """The split of one UNet leaf (path: its keys) over the model group, in
    the torch layout: `("model", None)` splits a linear weight's output rows.
    The counterpart of JAX's `unet_tp_spec` on the [in, out] kernels; GEGLU's
    ff.net.0.proj is [2, inner, in] here (`unet_tp_geglu_reshape`)."""
    keys = [str(k) for k in path]
    name = keys[-1] if keys else ""
    parent = keys[-2] if len(keys) >= 2 else ""
    grand = keys[-3] if len(keys) >= 3 else ""

    def col():
        if name == "weight" and leaf.ndim == 2 and leaf.shape[0] % n == 0:
            return ("model", None)
        if name == "bias" and leaf.ndim == 1 and leaf.shape[0] % n == 0:
            return ("model",)
        return ()

    def row():  # the bias is added after the sum
        if name == "weight" and leaf.ndim == 2 and leaf.shape[1] % n == 0:
            return (None, "model")
        return ()

    if grand in ("attn1", "attn2") and parent in _TP_ATTN_COL:
        return col()
    if grand in ("attn1", "attn2") and parent == "to_out.0":
        return row()
    if parent == "ff.net.0.proj":
        if name == "weight" and leaf.ndim == 3 and leaf.shape[1] % n == 0:
            return (None, "model", None)
        if name == "bias" and leaf.ndim == 2 and leaf.shape[1] % n == 0:
            return (None, "model")
        return ()
    if parent == "ff.net.2":
        return row()
    return ()


def unet_tp_geglu_reshape(unet_params: dict) -> dict:
    """Every GEGLU up-projection as weight [2, inner, in] and bias [2, inner]
    (views): value and gate on their own axis, so a split of `inner` keeps a
    rank's value and gate columns together. The UNet reads either layout."""

    def fix(path, leaf):
        if len(path) >= 2 and path[-2] == "ff.net.0.proj":
            if path[-1] == "weight" and leaf.ndim == 2:
                return leaf.view(2, leaf.shape[0] // 2, leaf.shape[1])
            if path[-1] == "bias" and leaf.ndim == 1:
                return leaf.view(2, leaf.shape[0] // 2)
        return leaf

    return _map(unet_params, fix)


class TPSplit:
    """The marker a split projection dict carries under "tp": how `dense`
    (models/layers.py) runs it. "col" splits the output features (the caller
    enters its input into the model group once, `enter`); "row" splits the
    input features and sums the partial outputs (`exit`) before the bias.
    An adapter on the projection enters the model group (its gradient from
    this use is summed over the ranks) and uses this rank's rows of B
    ("col") or columns of A ("row")."""

    def __init__(self, kind: str, group: Group):
        self.kind, self.group = kind, group

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return copy_to_model(x, self.group)

    def exit(self, y: torch.Tensor) -> torch.Tensor:
        return reduce_from_model(y, self.group)

    def _part(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        k = t.shape[dim] // self.group.size
        return t.narrow(dim, self.group.rank * k, k)

    def lora_a(self, a: torch.Tensor) -> torch.Tensor:
        a = self.enter(a)
        return self._part(a, 1) if self.kind == "row" else a

    def lora_b(self, b: torch.Tensor) -> torch.Tensor:
        b = self.enter(b)
        return self._part(b, 0) if self.kind == "col" else b

    def __repr__(self):
        return f"TPSplit({self.kind}, {self.group.rank}/{self.group.size})"


def _block_heads(cfg, path) -> int:
    """The head count of the transformer blocks under `path`."""
    if path[0] == "mid_block":
        return cfg.mid_num_heads
    level = int(path[1])
    if path[0] == "up_blocks":
        level = len(cfg.block_out_channels) - 1 - level
    return cfg.num_heads[level]


def shard_block_tp(block: dict, heads: int, group: Group) -> dict:
    """This rank's copy of one frozen transformer block under tp: leaves
    follow `unet_tp_spec` on the GEGLU-reshaped block (split leaves are
    contiguous copies of this rank's part) and split projection dicts carry
    a `TPSplit` under "tp", so the block runs `heads / group.size` heads of
    its own (models/unet.py). A block whose heads the group does not divide
    stays whole, as JAX's per-head split falls back to plain attention."""
    n = group.size
    if n == 1 or heads % n:
        return block
    block = unet_tp_geglu_reshape(block)

    def split(proj: dict, path) -> dict:
        specs = {k: unet_tp_spec(path + (k,), v, n) for k, v in proj.items()
                 if torch.is_tensor(v)}
        if not specs.get("weight"):
            return proj
        out = dict(proj)
        for k, spec in specs.items():
            if spec:
                out[k] = TPSplit("row", group)._part(proj[k], spec.index("model")).contiguous()
        out["tp"] = TPSplit("row" if specs["weight"][-1] == "model" else "col", group)
        return out

    def walk(tree, path):
        if not isinstance(tree, dict):
            return tree
        if "weight" in tree and torch.is_tensor(tree["weight"]):
            return split(tree, path)
        return {k: walk(v, path + (str(k),)) for k, v in tree.items()}

    return walk(block, ())


def shard_unet_tp(unet_params: dict, cfg, mesh: Mesh) -> dict:
    """This rank's copy of the frozen UNet under tp: every transformer block
    through `shard_block_tp` at its level's head count; the rest whole."""

    def walk(tree, path):
        if isinstance(tree, list):
            if path and path[-1] == "transformer_blocks":
                heads = _block_heads(cfg, path)
                return [shard_block_tp(b, heads, mesh.model) for b in tree]
            return [walk(v, path + (str(i),)) for i, v in enumerate(tree)]
        if isinstance(tree, dict):
            return {k: walk(v, path + (str(k),)) for k, v in tree.items()}
        return tree

    return walk(unet_params, ())


# ---------------------------------------------------------------------------
# fsdp: trainable UNet tensors as flat shards in whole AdamW8bit blocks
# ---------------------------------------------------------------------------


def _shard_len(numel: int, n: int) -> int:
    """Elements of each rank's shard: the flat storage padded to n whole
    blocks each, so a shard holds whole blocks of the unsharded layout."""
    per = n * BLOCK
    return (numel + per - 1) // per * BLOCK


def whole_shape(t: torch.Tensor) -> Optional[torch.Size]:
    """The whole tensor's shape if `t` is an fsdp shard (`FsdpShards`
    marks each one), else None."""
    return getattr(t, "fsdp_whole_shape", None)


class FsdpShards:
    """The trainable UNet as this rank's flat shards (leaves that require
    grad, in the tree's structure) and the gathers back to whole tensors.
    A shard carries its whole tensor's shape (`whole_shape`)."""

    def __init__(self, group: Group):
        self.group = group

    def shard_tree(self, tree, specs):
        """`tree` with each tensor whose spec (`trainable_shardings`) is
        sharded replaced by its shard (the whole tensor is not kept)."""

        def walk(t, spec):
            if torch.is_tensor(t):
                if not spec:
                    return t
                s = self.shard_of(t.detach()).requires_grad_(t.requires_grad)
                s.fsdp_whole_shape = t.shape
                return s
            if isinstance(t, dict):
                return {k: walk(v, spec[k]) for k, v in t.items()}
            if isinstance(t, (list, tuple)):
                return [walk(v, sp) for v, sp in zip(t, spec)]
            return t

        return walk(tree, specs)

    def shard_of(self, full: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
        """This rank's shard of a whole tensor."""
        n, s = self.group.size, _shard_len(full.numel(), self.group.size)
        flat = F.pad(jax_layout(full).reshape(-1), (0, n * s - full.numel()), value=fill)
        return flat[self.group.rank * s:(self.group.rank + 1) * s].clone()

    def gather(self, tree):
        """Whole tensors (autograd through the gather) of a subtree of
        shards, one all-gather for each dtype among them."""
        by_dtype: Dict[torch.dtype, list] = {}

        def collect(path, t):
            if whole_shape(t) is not None:
                by_dtype.setdefault(t.dtype, []).append((path, t))

        _map(tree, collect)
        whole = {}
        for group in by_dtype.values():
            outs = _GatherBucket.apply(self.group, [whole_shape(t) for _, t in group],
                                       *[t for _, t in group])
            whole.update({path: out for (path, _), out in zip(group, outs)})
        return _map(tree, lambda path, t: whole.get(path, t))

    @torch.no_grad()
    def full_of(self, shard: torch.Tensor, value: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The whole tensor of a shard (or of `value`, shaped like it, such as
        its gradient), on every rank (a collective)."""
        shape = whole_shape(shard)
        value = shard if value is None else value
        return from_jax_order(self.group.all_gather(value.detach())[:math.prod(shape)], shape)

    def on_rank0(self, whole: torch.Tensor) -> Optional[torch.Tensor]:
        """A gathered tensor in host memory on rank 0 (which writes the
        files); the other ranks drop theirs."""
        return whole.cpu() if self.group.rank == 0 else None

    # optimizer state: a per-tensor entry is elementwise (shaped like the
    # shard), AdamW8bit's block codes [blocks, BLOCK] or its scales [blocks]

    @torch.no_grad()
    def full_state(self, value: torch.Tensor, shard: torch.Tensor) -> torch.Tensor:
        shape = whole_shape(shard)
        numel = math.prod(shape)
        gathered = self.group.all_gather(value.contiguous())
        if value.shape == shard.shape:
            return from_jax_order(gathered[:numel], shape)
        return gathered[: (numel + BLOCK - 1) // BLOCK]

    def state_shard(self, name: str, full: torch.Tensor, shard: torch.Tensor) -> torch.Tensor:
        n, s = self.group.size, shard.numel()
        if tuple(full.shape) == tuple(whole_shape(shard)) and not name.endswith(
                ("_q", "_scale")):
            return self.shard_of(full.to(shard.device))
        blocks = s // BLOCK
        rows = full.to(shard.device)
        # padding blocks as a fresh quantizer leaves them: code of 0, scale 1
        fill = {"mu_q": 127, "nu_q": 0}.get(name, 1.0)
        pad = [0, 0] * (rows.ndim - 1) + [0, n * blocks - rows.shape[0]]
        rows = F.pad(rows, pad, value=fill)
        return rows[self.group.rank * blocks:(self.group.rank + 1) * blocks].clone()


# ---------------------------------------------------------------------------
# The plan a parallel step runs under
# ---------------------------------------------------------------------------


class ParallelPlan:
    """What a step needs of the mesh: its rows of the global batch, the
    batch statistics of the losses, the fsdp gathers, and the gradient sync.

    - `local_rows(t)`: this rank's rows (dim 0) of a global-batch tensor;
    - `batch`: the data group, whose `average`/`total` make the losses'
      batch-level reductions global;
    - `fsdp`: the shards of a full finetune's UNet, or None;
    - `specs`: `trainable_shardings` of the run, which decided the shards
      (and decides the optimizer state's, `optimizer_state_shardings`).
    """

    def __init__(self, mesh: Mesh, specs: dict, fsdp: Optional[FsdpShards] = None):
        self.mesh, self.specs, self.fsdp = mesh, specs, fsdp
        self.batch = mesh.data

    @property
    def n_data(self) -> int:
        return self.mesh.n_data

    def local_rows(self, t: torch.Tensor) -> torch.Tensor:
        k = t.shape[0] // self.mesh.n_data
        return t.narrow(0, self.mesh.data_rank * k, k)

    def gather(self, tree):
        return self.fsdp.gather(tree) if self.fsdp is not None else tree

    def is_sharded(self, t: torch.Tensor) -> bool:
        return self.fsdp is not None and whole_shape(t) is not None

    @torch.no_grad()
    def sync_grads(self, tensors: List[torch.Tensor]) -> None:
        """Average every gradient over the data group: the shards' came
        summed from the reduce-scatter, the rest go in one flat bucket per
        dtype."""
        n = self.mesh.n_data
        if n == 1:
            return
        buckets: Dict[Tuple, List[torch.Tensor]] = {}
        for t in tensors:
            if t.grad is None:
                continue
            if self.is_sharded(t):
                t.grad.div_(n)
            else:
                buckets.setdefault((t.grad.dtype, t.grad.device), []).append(t.grad)
        for grads in buckets.values():
            flat = torch.cat([g.reshape(-1) for g in grads])
            self.mesh.data.all_reduce_(flat).div_(n)
            torch._foreach_copy_(grads, [c.view_as(g) for c, g in
                                         zip(flat.split([g.numel() for g in grads]), grads)])

    def grad_sq_sum(self, tensors: List[torch.Tensor]) -> torch.Tensor:
        """The squared L2 norm of the whole gradient (shards summed over the
        data group)."""
        sharded = [t.grad.float().pow(2).sum() for t in tensors
                   if t.grad is not None and self.is_sharded(t)]
        rest = [t.grad.float().pow(2).sum() for t in tensors
                if t.grad is not None and not self.is_sharded(t)]
        device = next(t.grad.device for t in tensors if t.grad is not None)
        total = sum(rest) if rest else torch.zeros((), device=device)
        if sharded:
            total = total + self.mesh.data.total(torch.stack(sharded).sum())
        return total

    def average_metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each metric as the data group's mean (one all-reduce)."""
        if self.mesh.n_data == 1 or not metrics:
            return metrics
        keys = sorted(metrics)
        flat = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
        flat = self.mesh.data.all_reduce_(flat) / self.mesh.n_data
        return dict(zip(keys, flat.unbind()))


def parallelize(mode: str, mesh: Mesh, trainable: dict, frozen):
    """(plan, trainable, frozen) of a run under `mode` on `mesh`:

    - "fsdp": the tensors `trainable_shardings` shards (the `unet` group)
      become this rank's shards;
    - "tp": the frozen UNet becomes this rank's Megatron split (a new
      FrozenModels; the one given keeps the whole base, for renders);
    - "dp": nothing changes but the batch split and the gradient average.
    """
    import dataclasses

    specs = trainable_shardings(trainable, mode, mesh.n_data)
    if mode == "fsdp":
        shards = FsdpShards(mesh.data)
        trainable = shards.shard_tree(trainable, specs)
        return ParallelPlan(mesh, specs, fsdp=shards), trainable, frozen
    if mode == "tp":
        unet = shard_unet_tp(frozen.unet_params, frozen.unet_config, mesh)
        return ParallelPlan(mesh, specs), trainable, dataclasses.replace(frozen, unet_params=unet)
    return ParallelPlan(mesh, specs), trainable, frozen
