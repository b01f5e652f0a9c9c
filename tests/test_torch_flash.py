"""The port's flash attention against the JAX package's Pallas kernels.

The same numpy inputs go through the JAX `flash_mha` (its Pallas TPU kernels
run in interpret mode on the CPU, as tests/test_flash_padded.py runs them)
and through the port's `flash_mha`, whose autograd.Function takes the plain
PyTorch versions of its kernels (flash_fwd, the fused flash_bwd) for CPU
tensors. Tolerances are the JAX test's own (atol 2e-5 on outputs, 5e-5 on
gradients, float32): both sides compute the same float32 algebra and differ
only in summation order. The CUDA kernels
themselves are held against these plain versions on the card by
tests/test_torch_kernels_cuda.py.
"""

from pathlib import Path

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
    padded = hd if hd <= 128 else 256  # the JAX package pads d > 128 to 256

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


# SD's head dims in every mode; the rest of the JAX gate's range (the tiny
# UNets' 16 and 32, 36 off a multiple of 8, 96 and 128, and 192 and 256,
# which the JAX package pads to 256) whole and ragged
_MHA_CASES = ([(d, m) for m in ("exact256", "padded300", "prepadded300") for d in (40, 64, 80, 160)]
              + [(d, m) for m in ("exact256", "padded300") for d in (16, 32, 36, 96, 128, 192, 256)])


@pytest.mark.parametrize("head_dim, mode", _MHA_CASES, ids=[f"{m}-{d}" for d, m in _MHA_CASES])
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


@pytest.fixture(scope="module")
def library_bwd():
    """The library's _flash_attention_bwd_dkv / _flash_attention_bwd_dq
    (segment-masked, L = 300 padded to 384) on seeded inputs, with the l, m,
    dO and di they were fed: (inputs, (dk, dv, dq))."""
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
    inputs = (tq, tk, tv, tdo, lse, torch.tensor(np.asarray(di)), sc, valid)
    return inputs, tuple(np.asarray(x) for x in (dk_j, dv_j, dq_j))


def _split_refs(*args):
    dk, dv = fa.flash_bwd_dkv_ref(*args)
    return dk, dv, fa.flash_bwd_dq_ref(*args)


def _fused_wrapper(*args):
    fa.reset_launch_counts()
    dq, dk, dv = fa.flash_bwd(*args)  # CPU tensors: the plain version, no launch
    assert fa.LAUNCHES["flash_bwd"] == 0
    return dk, dv, dq


@pytest.mark.parametrize("backward", [_split_refs, _fused_wrapper], ids=["refs", "flash_bwd"])
def test_bwd_refs_match_library_bwd_kernels(library_bwd, backward):
    """The plain dK/dV and dQ versions, and the CPU path of the fused
    flash_bwd wrapper, against the library's two backward kernels fed the
    same l, m, dO and di."""
    inputs, want = library_bwd
    got = backward(*inputs)
    for t, j in zip(got, want):
        np.testing.assert_allclose(t.numpy(), j, atol=ATOL_GRAD, rtol=0)
    assert np.isfinite(got[2].numpy()).all()


def test_qualifies_gate():
    assert not fa.flash_attention_qualifies((2, 4096, 640), (2, 4096, 640), 10, "cpu")
    assert fa.flash_attention_qualifies((2, 4096, 640), (2, 4096, 640), 10, "cuda")
    assert fa.flash_attention_qualifies((2, 3952, 640), (2, 3952, 640), 10, "cuda")
    assert fa.flash_attention_qualifies((2, 256, 1280), (2, 256, 1280), 8, "cuda")  # d=160
    assert not fa.flash_attention_qualifies((2, 100, 640), (2, 100, 640), 10, "cuda")
    assert not fa.flash_attention_qualifies((2, 4096, 640), (2, 77, 640), 10, "cuda")
    assert not fa.flash_attention_qualifies((2, 4096, 512), (2, 4096, 512), 1, "cuda")  # d=512
    # as the JAX gate: every head dim up to 256, each with a kernel
    assert fa.flash_attention_qualifies((2, 1024, 64), (2, 1024, 64), 2, "cuda")  # d=32
    assert fa.flash_attention_qualifies((2, 1024, 256), (2, 1024, 256), 1, "cuda")  # d=256


@pytest.mark.parametrize("head_dim", [32, 96, 128, 36, 1, 255, 256])
def test_kernel_input_check_refuses_head_dims_without_a_kernel(head_dim):
    """The CUDA wrappers' input check (it runs before any launch, so it is
    testable on the CPU) takes every head dim the JAX gate admits, 1-256,
    and refuses the first one past it and lengths off the 128-row tile."""
    assert all(fa.kernel_takes_head_dim(d) for d in range(1, 257))
    assert fa.kernel_takes_head_dim(head_dim)
    q = torch.zeros(1, 2, 256, head_dim)
    fa._check_inputs(q, q, q)
    assert not fa.kernel_takes_head_dim(head_dim + 256)
    q = torch.zeros(1, 2, 256, head_dim + 256)  # 264 at 8: no kernel
    with pytest.raises(ValueError, match="no flash kernel"):
        fa._check_inputs(q, q, q)
    q = torch.zeros(1, 2, 320, head_dim)
    with pytest.raises(ValueError, match="L a multiple of 128"):
        fa._check_inputs(q, q, q)


@pytest.mark.parametrize("head_dim", [36, 100, 7])
def test_kernel_path_pads_head_dims_off_a_multiple_of_8_and_slices_back(head_dim):
    """The CUDA wrappers hand the kernels q, k, v (and dO) zero-padded to a
    head dim that is a multiple of 8, and slice o, dq, dk and dv back; lse
    and di pass as they are. Through the same `_at_kernel_head_dim` with the
    plain versions standing in for the kernels, on CPU tensors: what comes
    back equals the unpadded plain result, at the real head dim."""
    d8 = -(-head_dim // 8) * 8
    rng = np.random.default_rng(head_dim)
    q, k, v, do = (torch.tensor(rng.standard_normal((1, 2, 384, head_dim), dtype=np.float32))
                   for _ in range(4))
    sc, valid = head_dim**-0.5, 300
    seen = []

    def kernel(ref):
        def run(*args):
            tensors = [a for a in args if torch.is_tensor(a)]
            seen.append([tuple(t.shape) for t in tensors])
            for t in tensors:
                if t.dim() == 4:  # padded to d8 with zero columns
                    assert t.shape[-1] == d8 and not t[..., head_dim:].any()
            return ref(*args)
        return run

    o, lse = fa._at_kernel_head_dim(kernel(fa.flash_fwd_ref), (q, k, v), sc, valid)
    o_r, lse_r = fa.flash_fwd_ref(q, k, v, sc, valid)
    assert o.shape == o_r.shape and lse.shape == lse_r.shape
    torch.testing.assert_close(o, o_r, atol=1e-6, rtol=0)
    torch.testing.assert_close(lse, lse_r, atol=1e-6, rtol=0)
    di = (o_r * do).sum(-1)
    got = fa._at_kernel_head_dim(kernel(fa.flash_bwd_ref), (q, k, v, do, lse_r, di), sc, valid)
    want = fa.flash_bwd_ref(q, k, v, do, lse_r, di, sc, valid)
    for t, r in zip(got, want):
        assert t.shape == r.shape == q.shape
        torch.testing.assert_close(t, r, atol=1e-5, rtol=0)
    assert seen == [[(1, 2, 384, d8)] * 3, [(1, 2, 384, d8)] * 4 + [(1, 2, 384)] * 2]


def test_cpu_wrappers_take_the_plain_version_and_count_no_launch():
    fa.reset_launch_counts()
    q, k, v = (torch.tensor(x).view(1, 256, 2, 64).transpose(1, 2) for x in _qkv(0, 256, 128))
    o, lse = fa.flash_fwd(q, k, v, 0.125)
    o_r, lse_r = fa.flash_fwd_ref(q, k, v, 0.125)
    assert torch.equal(o, o_r) and torch.equal(lse, lse_r)
    do = torch.ones_like(q)
    di = (o * do).sum(-1)
    got = fa.flash_bwd(q, k, v, do, lse, di, 0.125)
    want = fa.flash_bwd_ref(q, k, v, do, lse, di, 0.125)
    assert all(torch.equal(x, r) for x, r in zip(got, want))
    assert fa.LAUNCHES == {"flash_fwd": 0, "flash_bwd": 0}


def _chip_smoke():
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("shape", [(4, 10, 4096, 0, 64), (4, 20, 384, 300, 64),
                                   (4, 8, 4096, 3952, 40), (2, 8, 9216, 0, 40),
                                   (4, 8, 3072, 2304, 80), (4, 8, 1024, 576, 160),
                                   (2, 4, 1024, 0, 16), (2, 4, 1024, 0, 256),
                                   (2, 4, 1024, 1000, 256)])
@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd"])
def test_chip_smoke_counts_the_kernel_work(kernel, shape):
    """chip_smoke's bound, over the (query, key) pairs the segment mask leaves:
    flash_fwd does 4 flops per pair and head-dim column (S, P V) and moves 4
    bf16 [B, H, L, d] tiles (q, k, v in; o out) and 1 fp32 [B, H, L] row
    (lse); the fused flash_bwd does 10 (S, dP, dV, dK, dQ) and moves 7 tiles
    (q, k, v, dO in; dq, dk, dv out) and 2 rows (lse, di)."""
    b, h, lp, valid, d = shape
    pairs = valid**2 + (lp - valid) ** 2 if valid else lp**2
    flops, nbytes = _chip_smoke()._work(kernel, b, h, lp, valid, d)
    mult, tiles, rows = {"flash_fwd": (4, 4, 1), "flash_bwd": (10, 7, 2)}[kernel]
    assert flops == mult * b * h * pairs * d
    assert nbytes == tiles * (b * h * lp * d * 2) + rows * (b * h * lp * 4)


def test_kernel_input_check_refuses_lengths_off_the_128_row_tile():
    """Both kernels tile L at 128 rows: 320 (a multiple of 64) is refused
    before any launch, 384 is taken."""
    q = torch.zeros(1, 2, 320, 64)
    with pytest.raises(ValueError, match="L a multiple of 128"):
        fa._check_inputs(q, q, q)
    q = torch.zeros(1, 2, 384, 64)
    fa._check_inputs(q, q, q)


def test_flash_fwd_on_fp32_cpu_tensors_returns_fp32_from_the_plain_version():
    fa.reset_launch_counts()
    q, k, v = (torch.tensor(x).view(1, 384, 2, 40).transpose(1, 2) for x in _qkv(5, 384, 80))
    o, lse = fa.flash_fwd(q, k, v, 40**-0.5, 300)
    o_r, lse_r = fa.flash_fwd_ref(q, k, v, 40**-0.5, 300)
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    assert torch.equal(o, o_r) and torch.equal(lse, lse_r)
    assert fa.LAUNCHES["flash_fwd"] == 0


_PTXAS_REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z16flash_fwd_kernelI13__nv_bfloat16Li48EEv14CUtensorMap_stS1_S1_9FwdParams' for 'sm_90a'
ptxas info    : Function properties for _Z16flash_fwd_kernelI13__nv_bfloat16Li48EEv14CUtensorMap_stS1_S1_9FwdParams
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 1536 bytes cmem[0]
ptxas info    : Compiling entry function '_Z16flash_fwd_kernelIfLi48EEv14CUtensorMap_stS1_S1_9FwdParams' for 'sm_90a'
ptxas info    : Function properties for _Z16flash_fwd_kernelIfLi48EEv14CUtensorMap_stS1_S1_9FwdParams
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 1536 bytes cmem[0]
ptxas info    : Compiling entry function '_Z16flash_bwd_kernelI13__nv_bfloat16Li160EEv14CUtensorMap_stS1_S1_S1_9BwdParams' for 'sm_90a'
ptxas info    : Function properties for _Z16flash_bwd_kernelI13__nv_bfloat16Li160EEv14CUtensorMap_stS1_S1_S1_9BwdParams
    96 bytes stack frame, 100 bytes spill stores, 100 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 1536 bytes cmem[0]
ptxas info    : Compiling entry function '_Z27flash_bwd_dq_convert_kernelI13__nv_bfloat16Li64EEvPKfPT_12FlashStridesiiifx' for 'sm_90a'
ptxas info    : Function properties for _Z27flash_bwd_dq_convert_kernelI13__nv_bfloat16Li64EEvPKfPT_12FlashStridesiiifx
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 26 registers, 400 bytes cmem[0]
"""


def test_ptxas_summary_reads_registers_and_spills_of_both_kernels():
    """chip_smoke's [device] line: one entry per bf16 instance (fp32 ones
    match them), with its registers and spill stores."""
    from sd_lora_trainer_tpu_torch.ops.kernels import ptxas_summary

    assert ptxas_summary(_PTXAS_REPORT) == [
        "flash_bwd_dq_convert_kernel<bf16, 64>: 26 registers, 0 bytes spilled",
        "flash_bwd_kernel<bf16, 160>: 255 registers, 100 bytes spilled",
        "flash_fwd_kernel<bf16, 48>: 168 registers, 0 bytes spilled",
    ]
