"""The port's plan_trace_check: every remat/stash8/int8 plan of the JAX
script traces one train step (loss, backward, AdamW update) under
FakeTensorMode, here at tiny width (64px bs=2); the full-width SDXL 1024px
bs=8 run is `python -m sd_lora_trainer_tpu_torch.scripts.plan_trace_check`.
The plans are the JAX script's own list, read from its source.
"""

import ast
import os

import pytest
import torch

from sd_lora_trainer_tpu_torch.scripts import plan_trace_check as ptc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _grad_mode_on():
    """Gradients need torch's grad mode, which tests/test_golden_torch.py
    switches off when imported (and pytest-xdist workers import every file)."""
    with torch.enable_grad():
        yield


def _jax_plans():
    """PLANS of scripts/plan_trace_check.py (a script that traces at import)."""
    with open(os.path.join(REPO, "scripts", "plan_trace_check.py")) as f:
        tree = ast.parse(f.read())
    node = next(n for n in tree.body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "PLANS")
    return ast.literal_eval(node.value)


def test_the_cases_are_the_jax_scripts_plans():
    want = [(r, s, "int8" if q else "none") for r, s, q in _jax_plans()]
    assert ptc.CASES[:-1] == want
    assert ptc.CASES[-1] == ("save:flash_out*,flash_lse*,xattn_out*,attn_out*", "", "int8+te")


@pytest.mark.parametrize("case", ptc.CASES, ids=lambda c: f"{c[0]}|{c[1]}|{c[2]}")
def test_plan_traces_on_fake_tensors(case):
    ptc.trace_plan(case, tiny=True, batch=2, res=64)


def test_a_plan_typo_raises():
    with pytest.raises(ValueError, match="unknown"):
        ptc.trace_plan(("sav:flash_out*", "", "none"), tiny=True, batch=2, res=64)
