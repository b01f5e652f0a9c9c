"""The port's remat plans (models/unet.py) against full remat and the JAX package.

Tiny SDXL UNet in float32 on the CPU, the JAX package's weights through
`from_jax_params`, loss = sum(out**2), gradients with respect to every base
parameter. Checked, as tests/test_named_remat.py checks the JAX plans:
- every plan gives full remat's gradients (atol 3e-5 of each tensor's
  largest value, at least 1: the JAX test's tolerance) and JAX's (atol 1e-4
  of it: two frameworks' summation orders, as
  tests/test_torch_unet_conditioning.py holds the LoRA gradients). JAX's
  gradient is taken once, under full remat: tests/test_named_remat.py holds
  each JAX plan to it within 3e-5, and one compile of the JAX UNet's
  gradient takes ~20 s here;
- saving names removes real work from the backward: fewer matmuls run in it
  under `save:attn_out*,ff_hidden*` than under full remat, and the flash op
  runs once per block under `save:flash_out*,flash_lse*` (twice under full
  remat), counted with the flash gate opened for CPU tensors;
- `offload:` is not ported and raises NotImplementedError; an unknown plan
  raises ValueError.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import sd_lora_trainer_tpu_torch.ops.attention as t_attention
import sd_lora_trainer_tpu_torch.ops.flash_attention as fa
from sd_lora_trainer_tpu.models import unet as j_unet
from sd_lora_trainer_tpu_torch.interop import from_jax_params
from sd_lora_trainer_tpu_torch.models import unet as t_unet

MATMULS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
           torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default}


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


def tiny_sdxl(seed=0):
    """(JAX config, JAX-layout numpy params, JAX inputs, port inputs, port
    added_cond) of the tiny SDXL UNet: the init tree's shapes filled from a
    numpy seed (random biases, unit norm scales), a [2, 16, 16, 4] batch."""
    cfg = j_unet.TINY_SDXL_UNET_CONFIG
    shapes = jax.eval_shape(lambda: j_unet.init_unet_params(jax.random.PRNGKey(0), cfg,
                                                            dtype=jnp.float32))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if getattr(path[-1], "key", None) == "scale":
            return np.ones(leaf.shape, np.float32)
        return (rng.standard_normal(leaf.shape) * 0.02).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    lat = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.asarray([3, 700], np.int32)
    ctx = rng.standard_normal((2, 77, cfg.cross_attention_dim)).astype(np.float32)
    added = {"text_embeds": rng.standard_normal((2, cfg.addition_pooled_dim)).astype(np.float32),
             "time_ids": np.tile(np.asarray([[128, 128, 0, 0, 128, 128]], np.float32), (2, 1))}
    inputs = [torch.tensor(x) for x in (lat, t, ctx)]
    return (cfg, params, (lat, t, ctx, added), inputs,
            {k: torch.tensor(v) for k, v in added.items()})


@pytest.fixture(scope="module")
def tiny():
    return tiny_sdxl()


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}{k}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def _port_loss(tiny, remat, stash8=""):
    cfg, np_params, _, (lat, t, ctx), added = tiny
    params = from_jax_params(np_params, device="cpu", requires_grad=True)
    # grad mode on here too: the module-scoped fixtures below run before the
    # function-scoped `_grad_mode_on`
    with torch.enable_grad():
        out, _ = t_unet.unet_forward(params, lat, t, ctx, t_unet.UNetConfig(**cfg.__dict__),
                                     added_cond=added, use_flash=True, remat=remat,
                                     stash8=stash8)
        return (out**2).sum(), params


def port_grads(tiny, remat, stash8=""):
    loss, params = _port_loss(tiny, remat, stash8)
    loss.backward()
    return {k: v.grad for k, v in _flat(params).items()}


def jax_grads(tiny, remat, stash8=""):
    cfg, np_params, (lat, t, ctx, added), _, _ = tiny

    def loss(p):
        out, _ = j_unet.unet_forward(p, lat, t, ctx, cfg, added_cond=added, use_flash=False,
                                     remat=remat, stash8=stash8)
        return (out**2).sum()

    return _flat(from_jax_params(jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(np_params)),
                                 device="cpu"))


def assert_grads_close(got, want, atol):
    assert sorted(got) == sorted(want)
    for k in want:
        scale = max(float(want[k].abs().max()), 1.0)
        np.testing.assert_allclose(got[k].numpy() / scale, want[k].numpy() / scale,
                                   rtol=0, atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def full_remat_grads(tiny):
    return port_grads(tiny, True)


@pytest.fixture(scope="module")
def jax_full_remat_grads(tiny):
    return jax_grads(tiny, True)


@pytest.mark.parametrize("mode", [False, True, "save:ff_hidden*", "save:attn_out*,ff_hidden*",
                                  "light+save:attn_out*", "save:xattn_out*", "light", "dots"])
def test_plan_matches_full_remat_and_jax(tiny, full_remat_grads, jax_full_remat_grads, mode):
    got = port_grads(tiny, mode)
    assert_grads_close(got, full_remat_grads, 3e-5)
    assert_grads_close(got, jax_full_remat_grads, 1e-4)


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in MATMULS
        return func(*args, **(kwargs or {}))


def _backward_matmuls(tiny, remat):
    loss, _ = _port_loss(tiny, remat)
    with _CountMatmuls() as count:
        loss.backward()
    return count.n


def test_named_save_elides_recompute(tiny):
    """Fewer matmuls run in the backward when attn_out and ff_hidden are
    kept: their producers (probabilities times V, the GEGLU projection) are
    not run again. An identity after the producer would elide nothing."""
    n_full = _backward_matmuls(tiny, True)
    n_named = _backward_matmuls(tiny, "save:attn_out*,ff_hidden*")
    n_dots = _backward_matmuls(tiny, "dots")
    assert n_named < n_full and n_dots < n_named, (n_full, n_named, n_dots)


def _open_gate(q_shape, k_shape, heads, device):
    """The flash path (its plain version on the CPU) at the tiny widths."""
    return q_shape[1] == k_shape[1] and q_shape[1] >= 16


def test_saved_flash_residuals_skip_the_forward_kernel(tiny, full_remat_grads, monkeypatch):
    """With flash_out/flash_lse kept, the flash op runs once per transformer
    block (10 in the tiny SDXL UNet); full remat runs it again in the
    backward, and so does a plan that keeps o without lse."""
    monkeypatch.setattr(t_unet, "flash_attention_qualifies", _open_gate)
    monkeypatch.setattr(t_attention, "flash_attention_qualifies", _open_gate)
    calls = []
    real = fa.flash_fwd
    monkeypatch.setattr(fa, "flash_fwd", lambda *a: calls.append(1) or real(*a))
    counts, grads = {}, {}
    for plan in (True, "save:flash_out*,flash_lse*", "save:flash_out*"):
        calls.clear()
        grads[plan] = port_grads(tiny, plan)
        counts[plan] = len(calls)
    assert counts == {True: 20, "save:flash_out*,flash_lse*": 10, "save:flash_out*": 20}
    # the flash path pads 16 and 64 tokens to 128 and masks; same gradients
    assert_grads_close(grads["save:flash_out*,flash_lse*"], grads[True], 3e-5)
    assert_grads_close(grads[True], full_remat_grads, 3e-5)


@pytest.mark.parametrize("remat,error", [
    ("offload:flash_out*", NotImplementedError), ("light+offload:ff_hidden*", NotImplementedError),
    ("save", ValueError), ("heavy", ValueError), ("light+keep:ff_hidden*", ValueError),
])
def test_offload_and_unknown_plans_raise(tiny, remat, error):
    with pytest.raises(error):
        _port_loss(tiny, remat)
