"""Generic helpers of the CLI path (counterpart of sd_lora_trainer_tpu/utils/utils.py).

`fix_prompt` and `replace_in_string` are copies (both packages must produce
the same captions and prompts); `seed_everything` seeds the host RNGs only,
as the JAX package's: device draws come from explicit `torch.Generator`s.
"""

from __future__ import annotations

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
