"""The benchmark's yardstick: the card's published peaks, the kernel
families, the flash kernels' operations and bytes, the model's attention
calls, and the reduction of a profiler trace to device intervals.

Frozen copies, so that a change to the program does not change how it is
measured:

- `FAMILY_WORDS`, `kernel_family`: copied from
  sd_lora_trainer_tpu_torch/utils/profiling.py at commit 7d8db9e;
- `flash_work`, `bound_s`: chip_smoke.py's `_work` and `_bound_ms` at
  commit 7d8db9e (forward 4 and fused backward 10 FLOPs per (query, key)
  pair and head-dim element; bytes of each tensor read or written once),
  evaluated here over the model's pairs: the real tokens' only, valid^2,
  and the tensors at the real length, so that work on padding counts as
  waste and not as work;
- `self_attention_calls`: the model's self-attentions that the program's
  kernels serve (at least 256 tokens and a head dim up to 256, the gate of
  sd_lora_trainer_tpu_torch/ops/flash_attention.py at commit 7d8db9e).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

# NVIDIA's data sheet, H100 SXM, dense: bf16 tensor cores and HBM3, at the
# 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

FAMILY_WORDS = {
    "flash": ("flash_fwd_kernel", "flash_bwd_kernel", "flash_bwd_dq_convert_kernel"),
    "conv": ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd", "cudnn"),
    "gemm": ("gemm", "nvjet", "xmma", "cutlass", "matmul"),
}
# kind: (the kernel a call launches once, the prefix of every kernel that the
# call's wrapper launches: the backward's fused kernel and dq's conversion)
FLASH_WORDS = {"fwd": ("flash_fwd_kernel", "flash_fwd"), "bwd": ("flash_bwd_kernel", "flash_bwd")}


def kernel_family(name: str) -> str:
    low = name.lower()
    return next((f for f, words in FAMILY_WORDS.items() if any(w in low for w in words)), "other")


def flash_work(kind: str, b: int, h: int, length: int, d: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one flash call over `length` tokens."""
    pairs = length * length
    mult = {"fwd": 4, "bwd": 10}[kind]
    tile = b * h * length * d * 2  # one bf16 [B, H, L, d] tensor
    rows = b * h * length * 4  # one fp32 [B, H, L] tensor
    nbytes = {"fwd": 4 * tile + rows, "bwd": 7 * tile + 2 * rows}[kind]
    return float(mult * b * h * pairs * d), float(nbytes)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card needs: the larger of the two rooflines."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def self_attention_calls(unet: dict, batch: int, height: int, width: int) -> List[Tuple[int, int, int, int]]:
    """(B, heads, tokens, head dim) of each self-attention of one UNet pass
    that the flash kernels serve, from diffusers' config keys and the
    latent size."""
    ch = list(unet["block_out_channels"])
    n = len(ch)
    per = (lambda v: list(v) if isinstance(v, (list, tuple)) else [v] * n)
    depth, n_heads = per(unet.get("transformer_layers_per_block", 1)), per(unet["attention_head_dim"])
    cross = [t.startswith("CrossAttn") for t in unet["down_block_types"]]
    lpb = unet["layers_per_block"]
    calls = []

    def add(level, count):
        tokens = (height >> level) * (width >> level)
        d = ch[level] // n_heads[level]
        if tokens >= 256 and d <= 256:
            calls.extend([(batch, n_heads[level], tokens, d)] * count)

    for level in range(n):
        if cross[level]:
            add(level, lpb * depth[level])
    add(n - 1, depth[-1])  # the mid block
    for level in reversed(range(n)):
        if cross[level]:
            add(level, (lpb + 1) * depth[level])
    return calls


def flash_roofline_pct(trace: "Trace", calls) -> Optional[float]:
    """The sum over the traced window's flash calls of each call's bound,
    over the device time of every kernel that the flash wrappers launch. A
    kind's calls (its `flash_*_kernel` launches) must be a whole number of
    passes over `calls` (the pass's self-attentions)."""
    total_bound, total_time = 0.0, 0.0
    for kind, (word, prefix) in FLASH_WORDS.items():
        launches = sum(1 for n, _, _ in trace.clipped() if word in n)
        if not launches:
            continue
        if launches % len(calls):
            return None
        passes = launches // len(calls)
        total_bound += passes * sum(bound_s(*flash_work(kind, *c)) for c in calls)
        total_time += sum(e - s for n, s, e in trace.clipped() if prefix in n)
    return 100.0 * total_bound / total_time if total_time > 0 else None


def idle_pct(trace: "Trace") -> float:
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)


@dataclasses.dataclass
class Trace:
    """A profiled block: device intervals (name, start, end) in seconds,
    host events (name, start, end), and the block's window."""

    device: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    window: Tuple[float, float]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def clipped(self) -> List[Tuple[str, float, float]]:
        a, b = self.window
        return [(n, max(s, a), min(e, b)) for n, s, e in self.device if e > a and s < b]

    def busy_s(self) -> float:
        return union_length([(s, e) for _, s, e in self.clipped()])

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n, s, e in self.clipped():
            out[n] = out.get(n, 0.0) + (e - s)
        return out

    def idle_gaps(self) -> List[Tuple[float, float]]:
        a, b = self.window
        gaps, t = [], a
        for s, e in merged([(s, e) for _, s, e in self.clipped()]):
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if b > t:
            gaps.append((t, b))
        return gaps

    def gap_causes(self) -> Dict[str, float]:
        """Idle seconds by what the host was doing: the innermost host event
        (the latest to start) that covers the gap's middle."""
        import bisect

        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        out: Dict[str, float] = {}
        for s, e in self.idle_gaps():
            mid = 0.5 * (s + e)
            name = "(no host event)"
            # back from the latest event to start before the middle; nested
            # events cover it within a few steps, so the scan is bounded
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 512, -1), -1):
                if host[j][2] >= mid:
                    name = host[j][0]
                    break
            out[name] = out.get(name, 0.0) + (e - s)
        return out


def merged(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def union_length(intervals: Sequence[Tuple[float, float]]) -> float:
    return sum(e - s for s, e in merged(intervals))


def trace_from_profiler(prof, window_name: str) -> Optional[Trace]:
    """The profiled block's device and host events, from the profiler's raw
    events; None when the block or the device left no event."""
    import torch

    device, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns() / 1e9, e.duration_ns() / 1e9
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation() and d > 0:
                device.append((e.name(), s, s + d))
        else:
            if e.name() == window_name:
                window = (s, s + d)
            host.append((e.name(), s, s + d))
    if window is None or not device:
        return None
    return Trace(device=device, host=host, window=window)
