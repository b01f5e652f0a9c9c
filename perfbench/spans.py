"""Device time by the program's named spans, from a live profiler run.

The program names its work with `torch.profiler.record_function` ranges
whose names start with "sdlt." (sd_lora_trainer_tpu_torch/utils/profiling.py).
`attribute(prof)` gives each device kernel of the run to the innermost such
span that owns it:

1. from the kernel to the host op that launched it, by the kernel's
   `linked_correlation_id`;
2. from that op out through the ops and ranges that cover it on its own
   thread, to the first span;
3. where that walk meets an autograd backward node first (the autograd
   engine's thread holds no span of the forward), from the node to the
   forward op with the same `sequence_nr` on the node's `fwd_thread_id`,
   and on from that op. Remat's recompute re-enters the program's Python in
   the backward, so its kernels meet their spans on the engine's thread.

Kernels that reach no span count under `NONE`. With `cpu_ops=True` the
host ops that contain no other op stand in for kernels (each its own
launch): a CPU run then goes through the same chain.

Span names are read as strings: nothing of the program is imported.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterator, List, Optional, Sequence

PREFIX = "sdlt."
NONE = "(none)"
_HOST_KINDS = ("cpu_op", "user_annotation")
# the profiler's own host events (CUPTI's buffers), not ops
_OVERHEAD = frozenset({"Activity Buffer Request", "Command Buffer Full", "Buffer Flush"})


class _Host:
    """The host ops and ranges of a run, with each one's parent on its
    thread (the innermost event that covers it)."""

    def __init__(self, events: Sequence):
        self.events = events
        self.parent: List[int] = [-1] * len(events)
        threads: Dict[int, List[int]] = collections.defaultdict(list)
        for i, e in enumerate(events):
            threads[e.start_thread_id()].append(i)
        for idx in threads.values():
            idx.sort(key=lambda i: (events[i].start_ns(), -events[i].duration_ns()))
            stack: List[int] = []
            for i in idx:
                start, end = events[i].start_ns(), _end(events[i])
                while stack and _end(events[stack[-1]]) <= start:
                    stack.pop()
                # the nearest open event that covers this one whole (a host
                # event of the profiler's own may overlap an op in part)
                self.parent[i] = next((j for j in reversed(stack) if _end(events[j]) >= end), -1)
                stack.append(i)
        # forward ops by (thread, sequence_nr): the latest to start, which
        # is the one that made the autograd node when several share it
        self.forward: Dict[tuple, int] = {}
        for i, e in enumerate(events):
            if e.sequence_nr() >= 0 and e.fwd_thread_id() == 0:
                key = (e.start_thread_id(), e.sequence_nr())
                j = self.forward.get(key)
                if j is None or events[j].start_ns() <= e.start_ns():
                    self.forward[key] = i
        self._owner: Dict[int, str] = {}

    def owner(self, i: int, prefix: str) -> str:
        """The span that owns host event `i` (itself included)."""
        seen = []
        name = NONE
        while i >= 0:
            if i in self._owner:
                name = self._owner[i]
                break
            seen.append(i)
            e = self.events[i]
            if e.name().startswith(prefix):
                name = e.name()
                break
            if e.fwd_thread_id() > 0 and e.sequence_nr() >= 0:
                fwd = self.forward.get((e.fwd_thread_id(), e.sequence_nr()))
                name = self.owner(fwd, prefix) if fwd is not None else NONE
                break
            i = self.parent[i]
        for j in seen:
            self._owner[j] = name
        return name


def _end(e) -> int:
    return e.start_ns() + e.duration_ns()


def _kind(e) -> str:
    """The event's activity type; where the profiler's events do not carry
    it (torch 2.11), told from the event: a user annotation, a CUDA runtime
    or driver call (`cuda*`, `cu[A-Z]*`), the profiler's own, or an op."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return str(kind())
    name = e.name()
    if e.is_user_annotation():
        return "user_annotation"
    if name.startswith("cuda") or (name[:2] == "cu" and name[2:3].isupper()):
        return "cuda_runtime"
    return "overhead" if name in _OVERHEAD else "cpu_op"


def owners(events: Sequence, prefix: str = PREFIX, cpu_ops: bool = False) -> Iterator[tuple]:
    """(kernel event, owning span) of each kernel of a profiler run's raw
    events (`prof.profiler.kineto_results.events()`)."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    host_events = [e for e in events if e.device_type() == cpu and _kind(e) in _HOST_KINDS]
    host = _Host(host_events)
    if cpu_ops:
        has_child = set(p for i, p in enumerate(host.parent)
                        if p >= 0 and _kind(host_events[i]) == "cpu_op")
        for i, e in enumerate(host_events):
            if _kind(e) == "cpu_op" and i not in has_child:
                yield e, host.owner(i, prefix)
        return
    by_corr = {e.correlation_id(): i for i, e in enumerate(host_events)
               if _kind(e) == "cpu_op" and e.correlation_id() > 0}
    for e in events:
        if e.device_type() == cpu or e.is_user_annotation() or e.duration_ns() <= 0:
            continue
        op: Optional[int] = by_corr.get(e.linked_correlation_id())
        yield e, (host.owner(op, prefix) if op is not None else NONE)


def attribute_events(events: Sequence, prefix: str = PREFIX, cpu_ops: bool = False) -> Dict[str, float]:
    """Seconds of kernel time by owning span (see the module's docstring)."""
    out: Dict[str, float] = collections.defaultdict(float)
    for e, name in owners(events, prefix, cpu_ops):
        out[name] += e.duration_ns() / 1e9
    return dict(out)


def attribute(prof, prefix: str = PREFIX, cpu_ops: bool = False) -> Dict[str, float]:
    """`attribute_events` over a live `torch.profiler.profile`."""
    return attribute_events(list(prof.profiler.kineto_results.events()), prefix, cpu_ops)


def host_seconds(events: Sequence, name: str) -> float:
    """The host seconds of the ranges named `name`, summed."""
    return sum(e.duration_ns() for e in events if e.name() == name) / 1e9
