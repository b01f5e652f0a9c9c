"""The port's CUDA flash kernels against their plain PyTorch versions, on a card.

Every test here is marked `cuda` and skips without a card: the kernels have no
CPU mode. The file imports neither jax nor the JAX package, so it runs on a
machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda -q

(`--noconftest` skips tests/conftest.py, which sets up JAX.) Tolerance: max
|kernel - plain| <= 2e-2 of the largest plain value in bf16, because the
kernels round P and dS to bf16 for the tensor cores; lse, fp32 end to end,
within 1e-3.
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
@pytest.mark.parametrize("shape", [(1, 2, 256, 64, 0), (1, 2, 384, 40, 300),
                                   (1, 2, 1024, 80, 988), (1, 2, 256, 160, 0)])
def test_cuda_kernels_match_plain_versions(cuda_device, shape):
    b, h, length, d, valid = shape
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v, do = (torch.randn(b, length, h, d, generator=g, device=cuda_device)
                   .bfloat16().transpose(1, 2) for _ in range(4))
    sc = d**-0.5
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_fwd(q, k, v, sc, valid)
    o_r, lse_r = fa.flash_fwd_ref(q, k, v, sc, valid)
    di = (o_r.float() * do.float()).sum(-1).contiguous()
    got = fa.flash_bwd_dkv(q, k, v, do, lse_r, di, sc, valid) + (
        fa.flash_bwd_dq(q, k, v, do, lse_r, di, sc, valid),)
    want = fa.flash_bwd_dkv_ref(q, k, v, do, lse_r, di, sc, valid) + (
        fa.flash_bwd_dq_ref(q, k, v, do, lse_r, di, sc, valid),)
    torch.cuda.synchronize()
    for x, r in zip((o,) + got, (o_r,) + want):
        _close(x, r)
    assert (lse - lse_r).abs().max() <= LSE_TOL
    assert all(fa.LAUNCHES[n] == before[n] + 1 for n in fa.LAUNCHES)


@pytest.mark.cuda
def test_flash_mha_on_cuda_never_takes_the_plain_version(cuda_device, monkeypatch):
    """flash_mha forward and backward on CUDA tensors go through the three
    kernels once each, and agree with the same call on the CPU."""
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

    for name in ("flash_fwd_ref", "flash_bwd_dkv_ref", "flash_bwd_dq_ref"):
        monkeypatch.setattr(fa, name, refuse)
    before = dict(fa.LAUNCHES)
    got = run(cuda_device)
    torch.cuda.synchronize()
    assert all(fa.LAUNCHES[n] == before[n] + 1 for n in fa.LAUNCHES)
    for x, r in zip(got, want):
        _close(x.cpu(), r)


@pytest.mark.cuda
def test_self_attention_on_cuda_raises_for_a_head_dim_without_a_kernel(cuda_device):
    """A qualifying self-attention (L >= 256, head_dim <= 256) whose head dim
    has no kernel raises on CUDA; it never returns a plain result."""
    from sd_lora_trainer_tpu_torch.ops.attention import self_attention

    x = torch.randn(1, 256, 64, device=cuda_device).bfloat16()  # 2 heads of 32
    fa.reset_launch_counts()
    with pytest.raises(ValueError, match="no flash kernel"):
        self_attention(x, x, x, heads=2, use_flash=True)
    assert fa.LAUNCHES == {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}
