"""The port's CUDA flash kernels against their plain PyTorch versions, on a card.

Every test here is marked `cuda` and skips without a card: the kernels have no
CPU mode. The file imports neither jax nor the JAX package, so it runs on a
machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda -q

(`--noconftest` skips tests/conftest.py, which sets up JAX.) Tolerance: max
|kernel - plain| <= 2e-2 of the largest plain value in bf16, because the
kernels round P and dS to bf16 for the tensor cores and sum in another order
than the plain versions; lse, fp32 end to end, within 1e-3. Between two
launches on the same inputs both kernels agree bit for bit: flash_bwd adds
each q tile's dq parts in a fixed order.
"""

import pytest
import torch

from sd_lora_trainer_tpu_torch.ops import flash_attention as fa

REL_TOL, LSE_TOL = 2e-2, 1e-3


@pytest.fixture(autouse=True)
def _grad_mode_on():
    """Gradients need torch's grad mode, which tests/test_golden_torch.py
    switches off when imported (and pytest-xdist workers import every file)."""
    with torch.enable_grad():
        yield


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels have no CPU mode")
    return torch.device("cuda")


def _close(x, ref):
    assert torch.isfinite(x.float()).all()
    assert (x.float() - ref.float()).abs().max() <= REL_TOL * ref.float().abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", [(1, 2, 256, 64, 0), (1, 2, 384, 40, 300),
                                   (1, 2, 1024, 80, 988), (2, 3, 512, 80, 448),
                                   (1, 2, 256, 160, 0), (1, 2, 384, 160, 300)])
def test_cuda_kernels_match_plain_versions(cuda_device, shape, dtype):
    """flash_fwd and the fused flash_bwd against their plain versions. fp32
    inputs are rounded to bf16 by the wrappers before TMA, and the outputs
    keep the caller's dtype."""
    b, h, length, d, valid = shape
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v, do = (torch.randn(b, length, h, d, generator=g, device=cuda_device)
                   .bfloat16().to(dtype).transpose(1, 2) for _ in range(4))
    sc = d**-0.5
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_fwd(q, k, v, sc, valid)
    o_r, lse_r = fa.flash_fwd_ref(q, k, v, sc, valid)
    di = (o_r.float() * do.float()).sum(-1).contiguous()
    got = fa.flash_bwd(q, k, v, do, lse_r, di, sc, valid)
    want = fa.flash_bwd_ref(q, k, v, do, lse_r, di, sc, valid)
    torch.cuda.synchronize()
    for x, r in zip((o,) + got, (o_r,) + want):
        assert x.dtype == dtype and x.shape == r.shape
        _close(x, r)
    assert (lse - lse_r).abs().max() <= LSE_TOL
    assert all(fa.LAUNCHES[n] == before[n] + 1 for n in fa.LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 3, 1024, 64, 0), (1, 2, 384, 40, 300),
                                   (1, 2, 1024, 80, 988), (1, 2, 384, 160, 300)])
def test_flash_fwd_gives_the_same_bits_on_every_launch(cuda_device, shape):
    """The forward has no atomics: two launches on the same inputs agree
    bitwise in o and lse."""
    b, h, length, d, valid = shape
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = (torch.randn(b, h, length, d, generator=g, device=cuda_device).bfloat16()
               for _ in range(3))
    o, lse = fa.flash_fwd(q, k, v, d**-0.5, valid)
    o2, lse2 = fa.flash_fwd(q, k, v, d**-0.5, valid)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 4, 2048, 64, 0), (2, 4, 1024, 160, 0),
                                   (2, 4, 1024, 256, 0), (2, 4, 4096, 64, 3952)],
                         ids=["d64", "d160", "d256", "d64_ragged"])
def test_flash_bwd_gives_the_same_bits_on_every_launch(cuda_device, shape):
    """dq, dk and dv bit-equal over launches on the same inputs, in each of
    the backward's tiers (two warpgroups of keys at d 64, one at 160, the
    column split at 256) and at a ragged length, where the segment mask
    leaves some (key tile, q tile) pairs out of dq's ordered adds."""
    b, h, length, d, valid = shape
    g = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v, do = (torch.randn(b, length, h, d, generator=g, device=cuda_device).bfloat16()
                   .transpose(1, 2) for _ in range(4))
    sc = d**-0.5
    o, lse = fa.flash_fwd(q, k, v, sc, valid)
    di = (o.float() * do.float()).sum(-1).contiguous()
    first = fa.flash_bwd(q, k, v, do, lse, di, sc, valid)
    for _ in range(4):
        again = fa.flash_bwd(q, k, v, do, lse, di, sc, valid)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(first, again))


@pytest.mark.cuda
def test_flash_mha_on_cuda_never_takes_the_plain_version(cuda_device, monkeypatch):
    """flash_mha forward and backward on CUDA tensors go through flash_fwd
    and the fused flash_bwd once each, and agree with the same call on the
    CPU."""
    heads, length, width = 2, 300, 128  # padded to 384, segment-masked
    g = torch.Generator().manual_seed(1)
    q, k, v, w = (torch.randn(1, length, width, generator=g) for _ in range(4))

    def run(device):
        leaves = [x.to(device).bfloat16().requires_grad_() for x in (q, k, v)]
        out = fa.flash_mha(*leaves, heads)
        (out.float() * w.to(device)).sum().backward()
        return [out] + [x.grad for x in leaves]

    want = run("cpu")

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in ("flash_fwd_ref", "flash_bwd_ref", "flash_bwd_dkv_ref", "flash_bwd_dq_ref"):
        monkeypatch.setattr(fa, name, refuse)
    before = dict(fa.LAUNCHES)
    got = run(cuda_device)
    torch.cuda.synchronize()
    assert all(fa.LAUNCHES[n] == before[n] + 1 for n in fa.LAUNCHES)
    for x, r in zip(got, want):
        _close(x.cpu(), r)


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [16, 32, 36, 128, 192, 256])
@pytest.mark.parametrize("valid", [0, 300])
def test_cuda_kernels_match_plain_versions_at_every_head_dim_tier(cuda_device, head_dim, valid):
    """The head dims the JAX gate admits beyond SD's: the narrow tiles (16,
    32), a head dim off a multiple of 8 (36: padded to 40 in device memory
    and sliced back), the forward's and backward's middle tier (128) and
    their wide tiers (192, 256: the forward's 64-key steps and the
    backward's column split), whole and segment-masked."""
    length = 384 if valid else 512
    g = torch.Generator(device=cuda_device).manual_seed(head_dim)
    q, k, v, do = (torch.randn(2, length, 3, head_dim, generator=g, device=cuda_device)
                   .bfloat16().transpose(1, 2) for _ in range(4))
    sc = head_dim**-0.5
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_fwd(q, k, v, sc, valid)
    o_r, lse_r = fa.flash_fwd_ref(q, k, v, sc, valid)
    di = (o_r.float() * do.float()).sum(-1).contiguous()
    got = fa.flash_bwd(q, k, v, do, lse_r, di, sc, valid)
    want = fa.flash_bwd_ref(q, k, v, do, lse_r, di, sc, valid)
    torch.cuda.synchronize()
    for x, r in zip((o,) + got, (o_r,) + want):
        assert x.shape == r.shape
        _close(x, r)
    assert (lse - lse_r).abs().max() <= LSE_TOL
    assert all(fa.LAUNCHES[n] == before[n] + 1 for n in fa.LAUNCHES)


@pytest.mark.cuda
def test_self_attention_on_cuda_takes_the_kernels_at_the_tiny_unets_head_dim(cuda_device):
    """A qualifying self-attention (L >= 256) at head dim 32, the JAX
    package's tiny UNets', goes through both kernels and agrees with the same
    call on the CPU."""
    from sd_lora_trainer_tpu_torch.ops.attention import self_attention

    x = torch.randn(1, 256, 64, generator=torch.Generator().manual_seed(4))  # 2 heads of 32

    def run(device):
        leaf = x.to(device).bfloat16().requires_grad_()
        out = self_attention(leaf, leaf, leaf, heads=2, use_flash=True)
        (out.float() ** 2).sum().backward()
        return out, leaf.grad

    want = run("cpu")
    fa.reset_launch_counts()
    got = run(cuda_device)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_fwd": 1, "flash_bwd": 1}
    for t, r in zip(got, want):
        _close(t.cpu(), r)


@pytest.mark.cuda
def test_named_plan_launches_the_forward_kernel_once(cuda_device):
    """Under `save:flash_out*,flash_lse*` the flash op's outputs are kept, so
    its forward kernel runs once per block; full remat runs it again in the
    backward. The gradients are equal bit for bit: both kernels give the
    same bits on every launch."""
    from sd_lora_trainer_tpu_torch.models import unet as t_unet

    g = torch.Generator(device=cuda_device).manual_seed(2)
    x, w = (torch.randn(*shape, generator=g, device=cuda_device) for shape in ((2, 300, 128),
                                                                              (128, 384)))
    x, w = x.bfloat16(), (w * 0.1).bfloat16()

    def block(x, w):
        q, k, v = (x @ w).chunk(3, dim=-1)
        return fa.flash_mha(q, k, v, 2, name_tag="_c128")

    wraps = {"full": t_unet._remat_wrappers(True, t_unet.SDXL_UNET_CONFIG)[0],
             "named": t_unet._remat_wrappers("save:flash_out_c128,flash_lse_c128",
                                             t_unet.SDXL_UNET_CONFIG)[0]}
    grads = {}
    for name, wrap in wraps.items():
        leaf = w.detach().requires_grad_()
        fa.reset_launch_counts()
        out = wrap(block)(x, leaf)
        (out.float() ** 2).sum().backward()
        torch.cuda.synchronize()
        want = {"flash_fwd": 2 if name == "full" else 1, "flash_bwd": 1}
        assert fa.LAUNCHES == want, (name, fa.LAUNCHES)
        grads[name] = leaf.grad
    assert torch.equal(grads["named"], grads["full"])
