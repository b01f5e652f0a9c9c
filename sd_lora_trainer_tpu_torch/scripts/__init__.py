"""The port's measurement and experiment tools, each run as
`python -m sd_lora_trainer_tpu_torch.scripts.<name>` (counterparts of the
JAX package's scripts/). They run on the card unless the caller passes
`--device cpu` (`BENCH_PLATFORM=cpu` for the bench-knob tools); without a
card they exit with a message, never falling back to the CPU."""

from __future__ import annotations

import os

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def resolve_device(name: str) -> torch.device:
    """The device a tool runs on; "cuda" without a card exits 1."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (torch.cuda.is_available() is false); "
                         "--device cpu runs on the CPU")
    return device
