"""Profiling and measurement helpers (counterpart of sd_lora_trainer_tpu/utils/profiling.py).

- `trace_steps(output_dir, enabled)`: a `torch.profiler` trace of a block of
  steps, written as a Chrome trace to `output_dir/profile/trace.json`
  (Perfetto or chrome://tracing open it);
- `ThroughputMeter`: images per second; it waits for the device before it
  reads the clock;
- `device_kernels` and `trace_kernels`: the device kernels of a profiler run,
  from the live profiler or from an exported trace, and
  `device_time_table`, their time by kernel family (flash, GEMM, conv,
  other), the flash kernels one by one, the top kernels, and the launches
  of each flash wrapper as the device saw them (a replayed CUDA graph's
  too);
- `count_step_flops`: the model FLOPs of one step's forward and backward,
  counted by `FlopCounterMode` (the flash ops carry their formulas,
  ops/flash_attention.py);
- the card's published peaks, by device name (`peak_bf16_flops`);
- named spans, `torch.profiler.record_function` ranges named
  `sdlt.<area>.<name>`, so that they sit in a profiler's trace beside the
  kernels, on the same clock. Three levels:
  - `span(name)`: a host range, always on (a few µs when no profiler runs);
  - `phase(name)`: a step phase, `sdlt.step.<name>`; inside `marking(marks)`
    it also records its host seconds and, where `marks` times the device,
    a CUDA timing event at its entry and exit (`external`, so that a
    captured graph holds them as event-record nodes and every replay
    records them again);
  - `layer(name)`: `sdlt.layer.<name>`, armed only inside `layer_spans()`;
    disarmed it returns one shared no-op context.

Unlike the JAX package's `trace_steps`, an exception in the traced block
comes out unchanged (the JAX version yields a second time and reports it
as a failed trace), and a profiler failure raises.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import subprocess
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch

# NVIDIA's data sheet, H100 SXM, dense: bf16 tensor cores and HBM3. Rates
# assume the 700 W power limit; a card may be set below it.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# torch.cuda.get_device_name of the cards whose peaks are known; any other
# card gets no peak (and no MFU), never a guessed one
_PEAKS = {"H100 80GB HBM3": PEAK_BF16_FLOPS}

# words in a kernel's name that place it in a family; the first match wins
FAMILY_WORDS = {
    "flash": ("flash_fwd_kernel", "flash_bwd_kernel", "flash_bwd_dq_convert_kernel"),
    "conv": ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd", "cudnn"),
    "gemm": ("gemm", "nvjet", "xmma", "cutlass", "matmul"),
}
# the word in a kernel's name that makes it one launch of a flash wrapper
# (ops/flash_attention.py); flash_bwd's dQ conversion rides on its launch
WRAPPER_KERNELS = {"flash_fwd": "flash_fwd_kernel", "flash_bwd": "flash_bwd_kernel"}
# the Chrome trace's categories of device work (kernels, copies, fills)
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


SPAN_PREFIX = "sdlt."
# the step's phases in the order the body runs them; PhaseMarks.ms() names
# the body's own marks "total" and the part of it outside these "other"
STEP_PHASES = ("conditioning", "unet_forward", "loss", "backward", "update")
_NO_SPAN = contextlib.nullcontext()
_layers_armed = False
_marks: Optional["PhaseMarks"] = None


def span(name: str):
    """The host range `sdlt.<name>`."""
    return torch.autograd.profiler.record_function(SPAN_PREFIX + name)


def layer(name: str):
    """`sdlt.layer.<name>` inside `layer_spans()`, else the shared no-op."""
    if not _layers_armed:
        return _NO_SPAN
    return torch.autograd.profiler.record_function(SPAN_PREFIX + "layer." + name)


@contextlib.contextmanager
def layer_spans() -> Iterator[None]:
    """Arm `layer(...)` for the block (every thread: remat's recompute runs
    on the autograd engine's)."""
    global _layers_armed
    armed, _layers_armed = _layers_armed, True
    try:
        yield
    finally:
        _layers_armed = armed


def timing_event() -> "torch.cuda.Event":
    return torch.cuda.Event(enable_timing=True, external=True)


class PhaseMarks:
    """One step body's phases: host seconds by phase and, when `device`,
    a pair of timing events for each phase entered (and for the body,
    "total"), on the stream that runs it. A captured body's events are
    recorded again by every replay, so `ms()` reads the latest one."""

    def __init__(self, device: bool):
        self.device = device
        self.host_s: Dict[str, float] = collections.defaultdict(float)
        self.events: List[Tuple[str, object, object]] = []

    def enter(self) -> Tuple[float, Optional[object]]:
        start = None
        if self.device:
            start = timing_event()
            start.record()
        return time.perf_counter(), start

    def exit(self, name: str, opened: Tuple[float, Optional[object]]) -> None:
        t0, start = opened
        if start is not None:
            end = timing_event()
            end.record()
            self.events.append((name, start, end))
        self.host_s[name] += time.perf_counter() - t0

    def ms(self) -> Optional[Dict[str, float]]:
        """Device ms by phase, summed over the phase's entries (the
        micro-batches), with "total" and "other"; None without events. Waits
        for the body's last event."""
        if not self.events:
            return None
        self.events[-1][2].synchronize()
        out: Dict[str, float] = collections.defaultdict(float)
        for name, start, end in self.events:
            out[name] += start.elapsed_time(end)
        out["other"] = out["total"] - sum(out[p] for p in STEP_PHASES if p in out)
        return dict(out)


@contextlib.contextmanager
def marking(marks: PhaseMarks) -> Iterator[None]:
    """Make `marks` record the phases of the block, and the block itself as
    "total"."""
    global _marks
    held, _marks = _marks, marks
    opened = marks.enter()
    try:
        yield
    finally:
        _marks = held
    marks.exit("total", opened)


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """The step phase `sdlt.step.<name>`, marked where `marking` is on."""
    marks = _marks
    with torch.autograd.profiler.record_function(SPAN_PREFIX + "step." + name):
        opened = marks.enter() if marks is not None else None
        yield
        if marks is not None:
            marks.exit(name, opened)


def peak_bf16_flops(device_name: str) -> Optional[float]:
    """The card's dense bf16 peak in FLOP/s, or None for a card not in the table."""
    return next((p for key, p in _PEAKS.items() if key in device_name), None)


def device_description(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them ("cpu" on the CPU)."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, check=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(index)}, power limit not read"


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace_steps(output_dir: str, enabled: bool = True) -> Iterator[Optional[object]]:
    """Trace the block with torch.profiler (CPU ops, and CUDA kernels where a
    card exists); yields the profiler (None when not enabled). On a normal
    exit the trace is written to `output_dir/profile/trace.json`."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    trace_dir = os.path.join(output_dir, "profile")
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


class ThroughputMeter:
    """Images per second since construction (the reference's headline
    counter); on a card it synchronizes before it reads the clock, so the
    images counted are done."""

    def __init__(self, device: Optional[torch.device] = None):
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        synchronize(self.device)
        self.start = time.perf_counter()
        self.images = 0

    def update(self, n_images: int) -> None:
        self.images += n_images

    @property
    def imgs_per_sec(self) -> float:
        synchronize(self.device)
        dt = time.perf_counter() - self.start
        return self.images / dt if dt > 0 else 0.0


Kernel = Tuple[str, float, int]  # (name, device µs in total, launches)


def device_kernels(prof) -> List[Kernel]:
    """The device work of a live profiler run, by name, from the profiler's
    raw events: `key_averages()` builds a Python object a event and takes
    tens of seconds over a bs=8 SDXL step's ~150,000. User annotations
    (e.g. Optimizer.step) span kernels and are left out. A kernel's name may
    hold '#' (PyTorch's lambda-templated elementwise and copy kernels,
    `{lambda()#1}`): such kernels count like any other."""
    us: Dict[str, float] = collections.defaultdict(float)
    count: Dict[str, int] = collections.defaultdict(int)
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation()
                and e.duration_ns() > 0):
            us[e.name()] += e.duration_ns() / 1e3
            count[e.name()] += 1
    return [(name, t, count[name]) for name, t in us.items()]


def trace_kernels(path: str) -> List[Kernel]:
    """The device work of an exported Chrome trace (`trace_steps`), by name."""
    with open(path) as f:
        events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    us: Dict[str, float] = collections.defaultdict(float)
    count: Dict[str, int] = collections.defaultdict(int)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATEGORIES:
            us[e["name"]] += float(e.get("dur", 0.0))
            count[e["name"]] += 1
    return [(name, t, count[name]) for name, t in us.items() if t > 0]


def kernel_family(name: str) -> str:
    low = name.lower()
    return next((f for f, words in FAMILY_WORDS.items() if any(w in low for w in words)), "other")


@dataclasses.dataclass
class DeviceTimeTable:
    device_s: float  # all device work
    kernels: int  # launches
    family_ms: Dict[str, float]
    flash_ms: Dict[str, float]  # each flash-family kernel
    top_ms: List[Tuple[str, float]]  # the longest kernels, by total time
    flash_launches: Dict[str, int]  # kernels a flash wrapper launches, by wrapper

    def lines(self, prefix: str = "[profile]") -> List[str]:
        return [
            f"{prefix} {self.kernels} device kernels, device time {self.device_s:.3f} s; "
            "device ms by family: " + ", ".join(f"{k} {v:.1f}" for k, v in self.family_ms.items()),
            f"{prefix} flash family by kernel (ms): "
            + "; ".join(f"{k[:60]} {ms:.1f}" for k, ms in sorted(self.flash_ms.items())),
            f"{prefix} top kernels (ms): " + "; ".join(f"{k[:60]} {ms:.1f}" for k, ms in self.top_ms),
        ]


def device_time_table(kernels: List[Kernel], top: int = 8) -> DeviceTimeTable:
    """Device time by kernel family, the flash kernels and the top kernels."""
    families = {name: 0.0 for name in (*FAMILY_WORDS, "other")}
    for name, us, _ in kernels:
        families[kernel_family(name)] += us / 1e3
    flash = {name: us / 1e3 for name, us, _ in kernels if kernel_family(name) == "flash"}
    top_ms = [(name, us / 1e3) for name, us, _ in sorted(kernels, key=lambda k: -k[1])[:top]]
    launches = {w: sum(n for name, _, n in kernels if word in name)
                for w, word in WRAPPER_KERNELS.items()}
    return DeviceTimeTable(device_s=sum(families.values()) / 1e3,
                           kernels=sum(n for _, _, n in kernels), family_ms=families,
                           flash_ms=flash, top_ms=top_ms, flash_launches=launches)


def profile_device(fn, device: torch.device) -> Tuple[float, DeviceTimeTable]:
    """Run `fn()` once under torch.profiler; (wall seconds, its device time table)."""
    from torch.profiler import ProfilerActivity, profile

    synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        synchronize(device)
        wall = time.perf_counter() - t
    return wall, device_time_table(device_kernels(prof))


def count_step_flops(sc, trainable, frozen, batch) -> int:
    """Model FLOPs of one step's forward and backward (conditioning, UNet,
    losses) on `batch` (one micro-batch, no accum dim), counted by
    FlopCounterMode with remat off: recomputation is not the model's work.
    The optimizer's update is not counted. The trainables' gradients are
    cleared after; the draws come from a generator of their own."""
    from torch.utils.flop_counter import FlopCounterMode

    from sd_lora_trainer_tpu_torch.training.optimizers import group_tensors
    from sd_lora_trainer_tpu_torch.training.step import compute_loss

    plain = dataclasses.replace(sc, remat=False, stash8="", remat_te=False)
    device = batch["latent_mean"].device
    gen = torch.Generator(device=device).manual_seed(0)
    with FlopCounterMode(display=False) as counter:
        loss, _ = compute_loss(trainable, frozen, plain, batch, 0, gen)
        loss.backward()
    for t in group_tensors(trainable):
        t.grad = None
    return int(counter.get_total_flops())
