"""The port's int8 activation stash (ops/stash8.py) against the JAX package's.

Float32 on the CPU, the tiny SDXL UNet of tests/test_torch_named_remat.py.
Checked:
- `quantize_rowwise` gives JAX's codes and scales bit for bit, fp32 and bf16
  inputs, and `dequantize_rowwise` JAX's values;
- the gradient passes straight through the quantizer;
- a stash without a `save:` plan raises ValueError, as in JAX;
- under `save:attn_out*` with `stash8="attn_out*"` the UNet's gradients
  equal JAX's under the same plan within 1e-3 of each tensor's largest value
  (at least 1). Unstashed, test_torch_named_remat.py holds them to 1e-4; the
  stash adds code flips: a float32 rounding difference between the two
  frameworks can put an activation on the other side of a code boundary, a
  step of 1/127 of its row's largest value (measured 1.4e-4 in 6 of 4096
  elements of one weight's gradient). The stash itself moves the gradients
  by up to 2e-2 (JAX's tests/test_stash8.py bound);
- what the plan keeps across a block for a stashed name is the int8 codes
  and their fp32 row scales, no copy of the activation; the flash output's
  stash keeps int8 too and still runs the flash op once per block.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

import sd_lora_trainer_tpu_torch.ops.attention as t_attention
import sd_lora_trainer_tpu_torch.ops.flash_attention as fa
from sd_lora_trainer_tpu.ops import stash8 as j_stash8
from sd_lora_trainer_tpu_torch.models import unet as t_unet
from sd_lora_trainer_tpu_torch.ops import checkpoint_names
from sd_lora_trainer_tpu_torch.ops import stash8 as t_stash8
from tests.test_torch_named_remat import (
    _open_gate,
    _port_loss,
    assert_grads_close,
    jax_grads,
    port_grads,
    tiny_sdxl,
)


@pytest.fixture(autouse=True)
def _grad_mode_on():
    """Gradients need torch's grad mode, which tests/test_golden_torch.py
    switches off when imported (and pytest-xdist workers import every file)."""
    with torch.enable_grad():
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU threads contend with the JAX CPU client's (8 virtual
    devices, tests/conftest.py): the tiny UNet's step takes ~10x longer."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    return tiny_sdxl()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rowwise_equals_jax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 64, 320)) * np.exp(rng.standard_normal((4, 64, 1))))
    x[0, 3] = 0.0  # an all-zero row: scale 1e-12 / 127, codes 0
    xj = jnp.asarray(x, dtype)
    xt = torch.tensor(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    qj, sj = j_stash8.quantize_rowwise(xj)
    qt, st = t_stash8.quantize_rowwise(xt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32 and st.shape == (4, 64, 1)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    back = t_stash8.dequantize_rowwise(qt, st, xt.dtype)
    want = np.asarray(j_stash8.dequantize_rowwise(qj, sj, xj.dtype).astype(jnp.float32))
    np.testing.assert_array_equal(back.float().numpy(), want)


def test_stash8_gradient_is_straight_through():
    x = torch.randn(8, 32, generator=torch.Generator().manual_seed(0), requires_grad=True)
    xq = t_stash8.stash8(x, "t")
    torch.sin(xq).sum().backward()
    # d stash8 / dx = I: the gradient is cos at the dequantized point
    torch.testing.assert_close(x.grad, torch.cos(xq.detach()), rtol=0, atol=1e-6)
    assert not torch.equal(xq, x)


def test_stash8_requires_a_save_plan(tiny):
    for remat in (True, "light", "dots"):
        with pytest.raises(ValueError, match="save"):
            _port_loss(tiny, remat, stash8="ff_hidden*")


def test_stashed_plan_gradients_match_jax(tiny):
    plan, stash = "save:attn_out*", "attn_out*"
    got = port_grads(tiny, plan, stash)
    assert_grads_close(got, jax_grads(tiny, plan, stash), 1e-3)
    unstashed = port_grads(tiny, plan)
    # the stash is the only approximation: int8 rows, ~1e-3 relative
    assert_grads_close(got, unstashed, 2e-2)
    assert any(not torch.equal(got[k], unstashed[k]) for k in got)


def _kept(tiny, monkeypatch, remat, stash8=""):
    """The tensors the selective plans keep across the blocks of one forward."""
    stores = []

    class Spy(checkpoint_names._Keep):
        def __init__(self, kept):
            super().__init__(kept)
            stores.append(kept)

    monkeypatch.setattr(checkpoint_names, "_Keep", Spy)
    loss, _ = _port_loss(tiny, remat, stash8)
    kept = [t for store in stores for entry in store for t in tree_leaves(entry)]
    loss.backward()
    return [t for t in kept if torch.is_tensor(t)]


def _is_int8_pair_member(t):
    return t.dtype == torch.int8 or (t.dtype == torch.float32 and t.shape[-1] == 1)


def test_stash_keeps_int8_codes_and_scales_only(tiny, monkeypatch):
    kept = _kept(tiny, monkeypatch, "save:attn_out*", "attn_out*")
    assert all(_is_int8_pair_member(t) for t in kept), [(t.dtype, t.shape) for t in kept]
    assert sum(t.dtype == torch.int8 for t in kept) == 10  # one per self-attention
    # unstashed, the plan keeps each self-attention's fp32 output instead
    plain = _kept(tiny, monkeypatch, "save:attn_out*")
    assert len(plain) == 10 and not any(_is_int8_pair_member(t) for t in plain)


def test_flash_output_stash_keeps_int8_and_skips_the_kernel(tiny, monkeypatch):
    monkeypatch.setattr(t_unet, "flash_attention_qualifies", _open_gate)
    monkeypatch.setattr(t_attention, "flash_attention_qualifies", _open_gate)
    calls = []
    real = fa.flash_fwd
    monkeypatch.setattr(fa, "flash_fwd", lambda *a: calls.append(1) or real(*a))
    plan = "save:flash_out*,flash_lse*"
    kept = _kept(tiny, monkeypatch, plan, "flash_out*")
    assert len(calls) == 10  # one flash op per block, none again in the backward
    int8 = [t for t in kept if t.dtype == torch.int8]
    assert len(int8) == 10 and all(t.ndim == 4 for t in int8)  # [B, H, L, d] codes
    # the rest: their row scales and the fp32 lse [B, H, L]
    assert all(t.dtype == torch.float32 and t.shape[-1] in (1, 128) for t in kept
               if t.dtype != torch.int8)
    calls.clear()
    got, exact = port_grads(tiny, plan, "flash_out*"), port_grads(tiny, plan)
    assert len(calls) == 20
    assert_grads_close(got, exact, 2e-2)
