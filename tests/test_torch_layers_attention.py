"""The port's layer primitives and plain attention against the JAX package's.

Same numpy inputs and weights (JAX layouts, converted by `from_jax_params`)
through both; float32 on the CPU. Tolerance atol 1e-5 on values and 2e-5 on
gradients: the two sides run the same float32 algebra in another summation
order, on O(1) activations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd_lora_trainer_tpu.models import layers as jl
from sd_lora_trainer_tpu.models.lora import LoraAlpha as JaxLoraAlpha
from sd_lora_trainer_tpu.ops import attention as ja
from sd_lora_trainer_tpu_torch.interop import from_jax_params
from sd_lora_trainer_tpu_torch.models import layers as tl
from sd_lora_trainer_tpu_torch.ops import attention as ta

ATOL, ATOL_GRAD = 1e-5, 2e-5


@pytest.fixture(autouse=True)
def _grad_mode_on():
    """Gradients need torch's grad mode, which tests/test_golden_torch.py
    switches off when imported (and pytest-xdist workers import every file)."""
    with torch.enable_grad():
        yield


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=0)


def _dense_params(rng, n_in, n_out, lora=None, bias=True):
    p = {"kernel": rng.standard_normal((n_in, n_out), np.float32) * 0.2}
    if bias:
        p["bias"] = rng.standard_normal(n_out).astype(np.float32) * 0.1
    if lora:
        r = 4
        p["lora"] = {
            "a": rng.standard_normal((n_in, r), np.float32) * 0.3,
            "b": rng.standard_normal((r, n_out), np.float32) * 0.3,
            "alpha": JaxLoraAlpha(8.0),
        }
        if lora == "dora":
            p["lora"]["magnitude"] = np.abs(rng.standard_normal(n_out)).astype(np.float32) + 0.5
    return p


def _jax_grads(fn, jparams, x):
    """Gradients of sum(sin(fn(p, x))) w.r.t. the lora leaves and x."""
    lora = jparams["lora"]
    leaves = {k: v for k, v in lora.items() if k != "alpha"}

    def loss(leaves, x):
        p = dict(jparams)
        p["lora"] = dict(lora, **leaves)
        return jnp.sum(jnp.sin(fn(p, x)))

    return jax.grad(loss, argnums=(0, 1))(leaves, x)


@pytest.mark.parametrize("lora", [None, "lora", "dora"])
def test_dense_with_lora_and_dora(lora):
    rng = _rng(1)
    jp = _dense_params(rng, 12, 10, lora)
    x = rng.standard_normal((3, 5, 12), np.float32)
    tp = from_jax_params(jp, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    yt = tl.dense(tp, xt)
    _close(yt, jl.dense(jp, x))
    if not lora:
        return
    torch.sin(yt).sum().backward()
    g_leaves, g_x = _jax_grads(jl.dense, jp, x)
    _close(xt.grad, g_x, ATOL_GRAD)
    _close(tp["lora"]["a"].grad.T, g_leaves["a"], ATOL_GRAD)
    _close(tp["lora"]["b"].grad.T, g_leaves["b"], ATOL_GRAD)
    if lora == "dora":
        _close(tp["lora"]["magnitude"].grad, g_leaves["magnitude"], ATOL_GRAD)


@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 1), (1, "VALID")])
def test_conv2d_with_conv_lora(stride, padding):
    rng = _rng(2)
    ks = 1 if padding == "VALID" else 3
    jp = {
        "kernel": rng.standard_normal((ks, ks, 6, 8), np.float32) * 0.2,
        "bias": rng.standard_normal(8).astype(np.float32) * 0.1,
        "lora": {
            "a": rng.standard_normal((ks, ks, 6, 4), np.float32) * 0.3,
            "b": rng.standard_normal((1, 1, 4, 8), np.float32) * 0.3,
            "alpha": JaxLoraAlpha(4.0),
        },
    }
    x = rng.standard_normal((2, 8, 8, 6), np.float32)

    def jfn(p, x):
        return jl.conv2d(p, x, stride=stride, padding=padding)

    tp = from_jax_params(jp, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    yt = tl.conv2d(tp, xt, stride=stride, padding=padding)
    _close(yt, jfn(jp, x))
    torch.sin(yt).sum().backward()
    g_leaves, g_x = _jax_grads(jfn, jp, x)
    _close(xt.grad, g_x, ATOL_GRAD)
    _close(tp["lora"]["a"].grad.permute(2, 3, 1, 0), g_leaves["a"], ATOL_GRAD)
    _close(tp["lora"]["b"].grad.permute(2, 3, 1, 0), g_leaves["b"], ATOL_GRAD)


def test_norms_activations_and_embeddings():
    rng = _rng(3)
    x = rng.standard_normal((2, 4, 6, 16), np.float32) * 3 + 1
    norm = {"scale": rng.standard_normal(16).astype(np.float32),
            "bias": rng.standard_normal(16).astype(np.float32)}
    tn = from_jax_params(norm)
    xt = torch.tensor(x)
    _close(tl.group_norm(tn, xt, 4), jl.group_norm(norm, x, 4), 2e-5)
    _close(tl.layer_norm(tn, xt), jl.layer_norm(norm, x), 2e-5)
    for name in ("silu", "gelu", "quick_gelu"):
        _close(getattr(tl, name)(xt), getattr(jl, name)(x))
    _close(tl.upsample_nearest_2x(xt), jl.upsample_nearest_2x(x))
    t = np.asarray([0, 1, 17, 500, 999], np.int32)
    # sin/cos of arguments up to ~1e3 in float32: the argument's own rounding
    # (1e3 * 2^-24 ~ 6e-5) bounds the agreement
    _close(tl.timestep_embedding(torch.tensor(t), 32), jl.timestep_embedding(jnp.asarray(t), 32),
           1e-4)


@pytest.mark.parametrize("capture,with_mask", [(True, False), (False, True)])
def test_multihead_attention_scores_and_grads(capture, with_mask):
    rng = _rng(4)
    q = rng.standard_normal((2, 10, 16), np.float32)
    k = rng.standard_normal((2, 7, 16), np.float32)
    v = rng.standard_normal((2, 7, 16), np.float32)
    mask = np.asarray(ja.make_causal_mask(7))[:, :, :7, :7] if with_mask else None
    if with_mask:
        q = q[:, :7]
    out_j, scores_j = ja.multihead_attention(q, k, v, 4, mask=mask, capture_scores=capture)
    tm = ta.make_causal_mask(7) if with_mask else None
    np.testing.assert_array_equal(tm.numpy() if with_mask else 0, mask if with_mask else 0)
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out_t, scores_t = ta.multihead_attention(qt, kt, vt, 4, mask=tm, capture_scores=capture)
    _close(out_t, out_j)
    loss_t = torch.sin(out_t).sum()
    if capture:
        _close(scores_t, scores_j)
        loss_t = loss_t + torch.cos(scores_t).sum()
    loss_t.backward()

    def loss_j(q, k, v):
        o, s = ja.multihead_attention(q, k, v, 4, mask=mask, capture_scores=capture)
        return jnp.sum(jnp.sin(o)) + (jnp.sum(jnp.cos(s)) if capture else 0.0)

    for gt, gj in zip((qt.grad, kt.grad, vt.grad), jax.grad(loss_j, argnums=(0, 1, 2))(q, k, v)):
        _close(gt, gj, ATOL_GRAD)


def test_self_attention_pre_padded_key_mask():
    """The plain path on a pre-padded sequence masks the pad keys: real rows
    equal the unpadded attention, in both packages."""
    rng = _rng(5)
    q, k, v = (rng.standard_normal((1, 40, 16), np.float32) for _ in range(3))
    pad = ((0, 0), (0, 24), (0, 0))
    qp, kp, vp = (np.pad(a, pad) for a in (q, k, v))
    out_j = ja.self_attention(qp, kp, vp, 2, pre_padded=40)
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (qp, kp, vp))
    out_t = ta.self_attention(qt, kt, vt, 2, use_flash=True, pre_padded=40)  # CPU: plain path
    _close(out_t, out_j)
    unpadded = ta.self_attention(*(torch.tensor(a) for a in (q, k, v)), 2)
    _close(out_t[:, :40], unpadded.numpy())
    torch.sin(out_t[:, :40]).sum().backward()
    g_j = jax.grad(
        lambda q, k, v: jnp.sum(jnp.sin(ja.self_attention(q, k, v, 2, pre_padded=40)[:, :40])),
        argnums=(0, 1, 2),
    )(qp, kp, vp)
    for gt, gj in zip((qt.grad, kt.grad, vt.grad), g_j):
        _close(gt, gj, ATOL_GRAD)
