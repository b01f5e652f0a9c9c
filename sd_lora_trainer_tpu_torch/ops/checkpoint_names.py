"""Names of saved activations for the selective remat plans.

Counterpart of `jax.ad_checkpoint.checkpoint_name` as the JAX package uses it
(models/unet.py `_tag`, ops/flash_attention.py `_named_flash`). In JAX a name
tags a tensor, and a policy that saves the name also prunes the tensor's
producer from the recompute. Eager PyTorch has no such pruning: under
`torch.utils.checkpoint` the recompute re-runs the region op by op, and an
op is skipped only where something below autograd hands back its kept
outputs. So a name here is attached to the op that produces the tensor:

    with checkpoint_name("ff_hidden_c640"):
        h2 = F.linear(h, w, b)        # the one op the name covers

`saving_names(names)` is the `context_fn` of a checkpointed region that
keeps the listed names. In the region's forward, every op (other than a
view) issued inside a scope whose names are all listed has its outputs kept;
in the recompute, the same scopes hand those outputs back in order instead
of running the ops. Only the ops inside such scopes pass through a Python
dispatch mode: torch's `create_selective_checkpoint_contexts` would put
every op of the region through one, which doubles the host's time per op
of an eager, host-bound step. Keep each scope to the producing op, so that a
weight cast or a copy before it is not kept as well. A scope may carry
several names that must all be listed, as the flash op's two outputs do
(`flash_out`, `flash_lse`). Outside such a region a scope has no effect.

`saving_names(names, offload=True)` is the "offload:" plan: the kept
outputs are copied to pinned host memory (non-blocking, on a side stream)
and the device copies are freed with the forward; the recompute copies
them back to the device. A CPU tensor is copied to fresh host memory: there
is no device memory to free.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Callable, FrozenSet, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map_only

_STATE = threading.local()


class _Offloaded:
    """A host copy of a device tensor, and the event that ends the copy."""

    def __init__(self, t: torch.Tensor):
        self.device = t.device
        if not t.is_cuda:
            self.host, self.event = t.detach().clone(), None
            return
        self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        stream = _side_stream(t.device)
        stream.wait_stream(torch.cuda.current_stream(t.device))
        with torch.cuda.stream(stream):
            self.host.copy_(t.detach(), non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(stream)
        t.record_stream(stream)  # the allocator keeps t until the copy ends

    def restore(self) -> torch.Tensor:
        if self.event is None:
            return self.host
        torch.cuda.current_stream(self.device).wait_event(self.event)
        return self.host.to(self.device, non_blocking=True)


_SIDE_STREAMS: dict = {}


def _side_stream(device) -> "torch.cuda.Stream":
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


def _restore(x):
    return x.restore() if isinstance(x, _Offloaded) else x


class _Keep(TorchDispatchMode):
    """Run each op and keep its outputs (detached: they hold no graph)."""

    def __init__(self, kept: collections.deque):
        super().__init__()
        self.kept = kept

    def _keep(self, t: torch.Tensor):
        return t.detach()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.kept.append(tree_map_only(torch.Tensor, self._keep, out))
        return out


class _KeepOnHost(_Keep):
    """`_Keep` whose kept outputs are host copies (the "offload:" plans)."""

    def _keep(self, t: torch.Tensor):
        return _Offloaded(t)


class _Replay(TorchDispatchMode):
    """Hand back the kept outputs in the order `_Keep` kept them (offloaded
    ones copied back to their device); views run."""

    def __init__(self, kept: collections.deque):
        super().__init__()
        self.kept = kept

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.is_view:
            return func(*args, **(kwargs or {}))
        kept = self.kept.popleft()
        return tuple(_restore(x) for x in kept) if isinstance(kept, tuple) else _restore(kept)


@contextlib.contextmanager
def _plan(names: FrozenSet[str], mode: TorchDispatchMode):
    prev = getattr(_STATE, "plan", None)
    _STATE.plan = (names, mode)
    try:
        yield
    finally:
        _STATE.plan = prev


def saving_names(names: FrozenSet[str], offload: bool = False) -> Callable[[], Tuple]:
    """`context_fn` for `torch.utils.checkpoint(use_reentrant=False)`: the
    region keeps the outputs of the ops named by a subset of `names`, in
    pinned host memory with `offload`."""

    def context_fn():
        kept: collections.deque = collections.deque()
        keep = _KeepOnHost(kept) if offload else _Keep(kept)
        return _plan(names, keep), _plan(names, _Replay(kept))

    return context_fn


@contextlib.contextmanager
def checkpoint_name(*names: Optional[str]):
    """Attach `names` to the ops issued inside; a None or empty name attaches nothing."""
    plan = getattr(_STATE, "plan", None)
    names = frozenset(n for n in names if n)
    if plan is None or not names or not names <= plan[0]:
        yield
        return
    with plan[1]:
        yield
