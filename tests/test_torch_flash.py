"""The port's flash attention against the JAX package's Pallas kernels.

The same numpy inputs go through the JAX `flash_mha` (its Pallas TPU kernels
run in interpret mode on the CPU, as tests/test_flash_padded.py runs them)
and through the port's `flash_mha`, whose autograd.Function takes the plain
PyTorch versions of K1-K3 for CPU tensors. Tolerances are the JAX test's own
(atol 2e-5 on outputs, 5e-5 on gradients, float32): both sides compute the
same float32 algebra and differ only in summation order. The CUDA kernels
themselves are held against these plain versions on the card by
tests/test_torch_kernels_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd_lora_trainer_tpu.ops.flash_attention import _pad_plan as jax_pad_plan
from sd_lora_trainer_tpu.ops.flash_attention import flash_mha as jax_flash_mha
from sd_lora_trainer_tpu_torch.ops import flash_attention as fa

ATOL_OUT, ATOL_GRAD = 2e-5, 5e-5


@pytest.fixture(autouse=True)
def _grad_mode_on():
    """Gradients need torch's grad mode, which tests/test_golden_torch.py
    switches off when imported (and pytest-xdist workers import every file)."""
    with torch.enable_grad():
        yield


def _qkv(seed, length, width):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, length, width), dtype=np.float32) for _ in range(3)]


def _interpret():
    from jax.experimental.pallas.tpu import force_tpu_interpret_mode

    return force_tpu_interpret_mode()


@pytest.mark.parametrize("length", [4096, 256, 3952, 4032, 300, 3840, 960, 640, 512, 988])
def test_pad_plan_matches_jax(length):
    assert fa._pad_plan(length) == jax_pad_plan(length)


def _jax_lse(q, k, heads, valid, lp):
    """lse = m + log(l) from the library forward kernel's residuals."""
    from jax.experimental.pallas.ops.tpu.flash_attention import (
        BlockSizes, SegmentIds, _flash_attention,
    )

    b, length, d = q.shape
    hd = d // heads
    padded = hd if hd <= 128 else 256  # the JAX package pads d=160 to 256

    def split(x):
        x = jnp.pad(jnp.asarray(x), ((0, 0), (0, lp - length), (0, 0)))
        x = x.reshape(b, lp, heads, hd).transpose(0, 2, 1, 3)
        return jnp.pad(x, ((0, 0), (0, 0), (0, 0), (0, padded - hd)))

    seg = None
    if valid:
        ids = jnp.broadcast_to((jnp.arange(lp) < valid).astype(jnp.int32)[None], (b, lp))
        seg = SegmentIds(q=ids, kv=ids)
    _, blk_q, blk_k = jax_pad_plan(length)
    sizes = BlockSizes(
        block_q=blk_q, block_k_major=blk_k, block_k=blk_k, block_b=1,
        block_q_major_dkv=blk_q, block_k_major_dkv=blk_k, block_k_dkv=blk_k,
        block_q_dkv=blk_q, block_k_major_dq=blk_k, block_k_dq=blk_k, block_q_dq=blk_q,
    )
    qh, kh = split(q), split(k)
    _, l, m = _flash_attention(qh, kh, kh, None, seg, True, False, hd**-0.5, sizes, False)
    return np.asarray(m + jnp.log(l))


@pytest.mark.parametrize("head_dim", [40, 64, 80, 160])
@pytest.mark.parametrize("mode", ["exact256", "padded300", "prepadded300"])
def test_flash_mha_matches_jax_kernels(head_dim, mode):
    heads = 2
    length = 256 if mode == "exact256" else 300
    lp = fa._pad_plan(length)[0]
    q, k, v = _qkv(head_dim, length, heads * head_dim)
    w = np.random.default_rng(7).standard_normal((1, length, heads * head_dim), np.float32)

    def pad(x):
        return jnp.pad(x, ((0, 0), (0, lp - length), (0, 0)))

    def jax_fwd(q, k, v):
        if mode == "prepadded300":
            return jax_flash_mha(pad(q), pad(k), pad(v), heads, pre_padded=length)[:, :length]
        return jax_flash_mha(q, k, v, heads)

    def jax_fwd_bwd(q, k, v):
        o, vjp = jax.vjp(jax_fwd, q, k, v)
        return o, vjp(jnp.cos(o) * w)  # cotangent of sum(sin(o) * w)

    with _interpret():
        o_j, g_j = jax.jit(jax_fwd_bwd)(q, k, v)

    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    if mode == "prepadded300":
        def tpad(x):
            return torch.nn.functional.pad(x, (0, 0, 0, lp - length))
        o_t = fa.flash_mha(tpad(qt), tpad(kt), tpad(vt), heads, pre_padded=length)
        assert o_t.shape == (1, lp, heads * head_dim)  # the padded length is kept
        o_t = o_t[:, :length]
    else:
        o_t = fa.flash_mha(qt, kt, vt, heads)
    (torch.sin(o_t) * torch.tensor(w)).sum().backward()

    np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j), atol=ATOL_OUT, rtol=0)
    for gt, gj in zip((qt.grad, kt.grad, vt.grad), g_j):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=ATOL_GRAD, rtol=0)

    def split(x):
        x = torch.nn.functional.pad(torch.tensor(x), (0, 0, 0, lp - length))
        return x.unflatten(-1, (heads, head_dim)).transpose(1, 2)

    if mode != "prepadded300":  # the same kernel call as padded300
        valid = length if lp != length else 0
        with _interpret():
            lse_j = _jax_lse(q, k, heads, valid, lp)
        _, lse_t = fa.flash_fwd(split(q), split(k), split(v), head_dim**-0.5, valid)
        np.testing.assert_allclose(lse_t.numpy(), lse_j, atol=ATOL_OUT, rtol=0)


def test_bwd_refs_match_library_bwd_kernels():
    """flash_bwd_dkv_ref / flash_bwd_dq_ref against the library's
    _flash_attention_bwd_dkv / _flash_attention_bwd_dq (segment-masked,
    L = 300 padded to 384), fed the same l, m, dO and di."""
    from jax.experimental.pallas.ops.tpu.flash_attention import (
        DEFAULT_MASK_VALUE, BlockSizes, SegmentIds, _flash_attention,
        _flash_attention_bwd_dkv, _flash_attention_bwd_dq,
    )

    b, h, lp, d, valid = 1, 2, 384, 64, 300
    rng = np.random.default_rng(3)
    q, k, v, do = (rng.standard_normal((b, h, lp, d), dtype=np.float32) for _ in range(4))
    ids = jnp.broadcast_to((jnp.arange(lp) < valid).astype(jnp.int32)[None], (b, lp))
    seg = SegmentIds(q=ids, kv=ids)
    sc = d**-0.5
    blk = 384
    sizes = BlockSizes(
        block_q=blk, block_k_major=blk, block_k=blk, block_b=1, block_q_major_dkv=blk,
        block_k_major_dkv=blk, block_k_dkv=blk, block_q_dkv=blk, block_k_major_dq=blk,
        block_k_dq=blk, block_q_dq=blk,
    )
    with _interpret():
        o, l, m = _flash_attention(q, k, v, None, seg, True, False, sc, sizes, False)
        di = jnp.sum(o * do, axis=-1)
        dk_j, dv_j = _flash_attention_bwd_dkv(
            q, k, v, None, seg, l, m, do, di, block_q_major=blk, block_k_major=blk,
            block_k=blk, block_q=blk, sm_scale=sc, causal=False,
            mask_value=DEFAULT_MASK_VALUE, debug=False,
        )
        dq_j, _ = _flash_attention_bwd_dq(
            q, k, v, None, seg, l, m, do, di, block_q_major=blk, block_k_major=blk,
            block_k=blk, sm_scale=sc, causal=False, mask_value=DEFAULT_MASK_VALUE, debug=False,
        )
    lse = torch.tensor(np.asarray(m + jnp.log(l)))
    tq, tk, tv, tdo = (torch.tensor(x) for x in (q, k, v, do))
    tdi = torch.tensor(np.asarray(di))
    dk_t, dv_t = fa.flash_bwd_dkv_ref(tq, tk, tv, tdo, lse, tdi, sc, valid)
    dq_t = fa.flash_bwd_dq_ref(tq, tk, tv, tdo, lse, tdi, sc, valid)
    for t, j in ((dk_t, dk_j), (dv_t, dv_j), (dq_t, dq_j)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL_GRAD, rtol=0)
    assert np.isfinite(dq_t.numpy()).all()


def test_qualifies_gate():
    assert not fa.flash_attention_qualifies((2, 4096, 640), (2, 4096, 640), 10, "cpu")
    assert fa.flash_attention_qualifies((2, 4096, 640), (2, 4096, 640), 10, "cuda")
    assert fa.flash_attention_qualifies((2, 3952, 640), (2, 3952, 640), 10, "cuda")
    assert fa.flash_attention_qualifies((2, 256, 1280), (2, 256, 1280), 8, "cuda")  # d=160
    assert not fa.flash_attention_qualifies((2, 100, 640), (2, 100, 640), 10, "cuda")
    assert not fa.flash_attention_qualifies((2, 4096, 640), (2, 77, 640), 10, "cuda")
    assert not fa.flash_attention_qualifies((2, 4096, 512), (2, 4096, 512), 1, "cuda")  # d=512
    # as the JAX gate: every head dim up to 256, also those no kernel is built
    # for (the wrappers then raise instead of falling back to plain attention)
    assert fa.flash_attention_qualifies((2, 1024, 64), (2, 1024, 64), 2, "cuda")  # d=32
    assert fa.flash_attention_qualifies((2, 1024, 256), (2, 1024, 256), 1, "cuda")  # d=256


@pytest.mark.parametrize("head_dim", [32, 96, 128, 36])
def test_kernel_input_check_refuses_head_dims_without_a_kernel(head_dim):
    """The CUDA wrappers' input check raises for a head dim the kernels are
    not built for; it runs before any launch, so it is testable on the CPU."""
    assert not fa.kernel_takes_head_dim(head_dim)
    q = torch.zeros(1, 2, 256, head_dim)
    with pytest.raises(ValueError, match="no flash kernel"):
        fa._check_inputs(q, q, q)


def test_cpu_wrappers_take_the_plain_version_and_count_no_launch():
    fa.reset_launch_counts()
    q, k, v = (torch.tensor(x).view(1, 256, 2, 64).transpose(1, 2) for x in _qkv(0, 256, 128))
    o, lse = fa.flash_fwd(q, k, v, 0.125)
    o_r, lse_r = fa.flash_fwd_ref(q, k, v, 0.125)
    assert torch.equal(o, o_r) and torch.equal(lse, lse_r)
    assert fa.LAUNCHES == {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}
