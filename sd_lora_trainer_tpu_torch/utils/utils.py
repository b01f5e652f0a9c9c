"""Generic helpers of the CLI path (counterpart of sd_lora_trainer_tpu/utils/utils.py).

`fix_prompt` and `replace_in_string` are copies (both packages must produce
the same captions and prompts); `seed_everything` seeds the host RNGs only,
as the JAX package's: device draws come from explicit `torch.Generator`s.
`print_system_info` prints the host's RAM and disk and each CUDA device.
`kept_on_card` keeps the step's host-built constants on the card, for the
captured step (training/step.py).
"""

from __future__ import annotations

import functools
import random
import re

import numpy as np
import torch

# config.weight_type -> the models' dtype. fp16 maps to bfloat16 as in the
# JAX package: the frozen weights and the train step run in bf16.
dtype_map = {
    "fp16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "fp32": torch.float32,
}


def replace_in_string(s: str, replacements: dict) -> str:
    """Iterative regex replacement until a fixpoint."""
    while True:
        replaced = False
        for target, replacement in replacements.items():
            new_s = re.sub(target, replacement, s, flags=re.IGNORECASE)
            if new_s != s:
                s = new_s
                replaced = True
        if not replaced:
            break
    return s


def fix_prompt(prompt: str) -> str:
    """Punctuation and whitespace cleanup: collapse spaces, squash double
    commas, then normalize the spacing around commas and periods."""
    if not prompt:
        return prompt
    prompt = re.sub(r"\s+", " ", prompt)
    prompt = re.sub(r",,", ",", prompt)
    prompt = re.sub(r"\s?,\s?", ", ", prompt)
    prompt = re.sub(r"\s?\.\s?", ". ", prompt)
    return prompt.strip()


def seed_everything(seed: int) -> None:
    """Seed Python's and numpy's global RNGs (the host draws)."""
    random.seed(seed)
    np.random.seed(seed % (2**32))


def print_system_info() -> None:
    """Host RAM and disk, and each CUDA device's name and free/total memory."""
    import shutil

    try:
        import psutil

        mem = psutil.virtual_memory()
        print(f"RAM: {mem.used / 1e9:.1f} / {mem.total / 1e9:.1f} GB used")
    except ImportError:
        pass
    total, used, _ = shutil.disk_usage("/")
    print(f"Disk: {used / 1e9:.1f} / {total / 1e9:.1f} GB used")
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        print(f"Device: {torch.cuda.get_device_name(i)} (id={i})")
        print(f"  memory: {(total - free) / 1e9:.2f} / {total / 1e9:.2f} GB in use")


def kept_on_card(fn):
    """Memoize `fn(*args, device)` where the device is a card: a constant
    built on the host is copied to the card once, so that a captured step
    (training/step.py) copies nothing from the host (a capture refuses
    that copy; the step's eager first run makes the constant). Elsewhere
    `fn` runs at each call: a tensor made under a fake-tensor trace must
    not outlive it."""
    kept = functools.lru_cache(maxsize=None)(fn)

    @functools.wraps(fn)
    def constant(*args):
        device = torch.device(args[-1])
        return kept(*args[:-1], device) if device.type == "cuda" else fn(*args)

    return constant
