"""The norm layer's kernels (ops/norms.py, csrc/norm.cu) and their plain versions.

On the CPU: the wrappers take the plain versions, which are the formulas the
layer always ran (bit for bit); the `torch.autograd.Function`'s backward
algebra (the kernels' own, in plain PyTorch) against autograd through the
plain chain; the tile plans; the ctypes mirror of the kernels' argument
struct; the launch counts.

The `cuda`-marked tests run the kernels against the plain versions on a card
and skip elsewhere. The file imports neither jax nor the JAX package, so it
runs on a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_norm_kernels.py -m cuda -q

Tolerances on the card: the kernels and the plain versions both compute in
fp32 from the same inputs and round once to the output's dtype, the plain
fused form twice (the norm, then the SiLU); so in bf16 the outputs and dx
agree within 2e-2 of the largest plain value (a bf16 rounding or two), and in
fp32 within 1e-4 (sums in another order; the SiLU's fast exp). The statistics
are fp32 both ways: within 1e-4 relative.
"""

import ctypes
import re

import pytest
import torch
import torch.nn.functional as F

from sd_lora_trainer_tpu_torch.models import layers
from sd_lora_trainer_tpu_torch.ops import flash_attention as fa
from sd_lora_trainer_tpu_torch.ops import kernels, norms


@pytest.fixture(autouse=True)
def _grad_mode_on():
    """Gradients need torch's grad mode, which tests/test_golden_torch.py
    switches off when imported (and pytest-xdist workers import every file)."""
    with torch.enable_grad():
        yield


def _inputs(shape, dtype=torch.float32, seed=0, device="cpu", shift=0.0):
    g = torch.Generator().manual_seed(seed)
    c = shape[-1]
    x = (torch.randn(shape, generator=g) * 2 + shift).to(dtype)
    w = (1 + 0.3 * torch.randn(c, generator=g)).to(dtype)
    b = (0.2 * torch.randn(c, generator=g)).to(dtype)
    dy = torch.randn(shape, generator=g).to(dtype)
    return tuple(t.to(device) for t in (x, w, b, dy))


# the formulas of models/layers.py before the kernels, kept here as the yardstick
def _old_group_norm(p, x, groups, eps):
    b, h, w, c = x.shape
    xf = x.float().reshape(b, h * w, groups, c // groups)
    var, mean = torch.var_mean(xf, dim=(1, 3), keepdim=True, correction=0)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    return (xf * p["weight"].float() + p["bias"].float()).to(x.dtype)


def _old_layer_norm(p, x, eps):
    out = F.layer_norm(x.float(), (x.shape[-1],), p["weight"].float(), p["bias"].float(), eps)
    return out.to(x.dtype)


GN_SHAPES = [(2, 4, 4, 32, 8), (1, 6, 5, 64, 32), (3, 2, 2, 36, 4), (2, 8, 8, 40, 4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", GN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_group_norm_is_the_layers_old_formula_bit_for_bit(shape, dtype):
    *xs, groups = shape
    x, w, b, _ = _inputs(tuple(xs), dtype)
    p = {"weight": w, "bias": b}
    for eps in (1e-5, 1e-6):
        want = _old_group_norm(p, x, groups, eps)
        assert torch.equal(norms.group_norm_ref(x, w, b, groups, eps), want)
        assert torch.equal(layers.group_norm(p, x, groups, eps), want)
        # the fused form's plain version is silu(group_norm(...)), exactly
        assert torch.equal(norms.group_norm_ref(x, w, b, groups, eps, silu=True), F.silu(want))
        assert torch.equal(layers.group_norm(p, x, groups, eps, silu=True), F.silu(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 7, 32), (3, 77, 48), (5, 36), (1, 4, 9, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_plain_layer_norm_is_the_layers_old_formula_bit_for_bit(shape, dtype):
    x, w, b, _ = _inputs(shape, dtype, seed=1)
    p = {"weight": w, "bias": b}
    want = _old_layer_norm(p, x, 1e-5)
    assert torch.equal(norms.layer_norm_ref(x, w, b, 1e-5), want)
    assert torch.equal(layers.layer_norm(p, x), want)
    out, mean, rstd = norms.layer_norm_fwd_ref(x, w, b, 1e-5)
    assert torch.equal(out, want) and mean.shape == rstd.shape == (x.numel() // shape[-1],)


def test_the_wrappers_take_the_plain_versions_off_the_card(monkeypatch):
    """A CPU tensor never reaches the autograd.Function or the library."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the kernels")

    monkeypatch.setattr(norms._GroupNorm, "apply", refuse)
    monkeypatch.setattr(norms._LayerNorm, "apply", refuse)
    monkeypatch.setattr(norms, "kernel_lib", refuse)
    x, w, b, _ = _inputs((2, 4, 4, 32))
    before = norms.launch_counts()
    assert torch.equal(norms.group_norm(x, w, b, 8, 1e-5, True),
                       norms.group_norm_ref(x, w, b, 8, 1e-5, True))
    assert torch.equal(norms.layer_norm(x, w, b, 1e-5), norms.layer_norm_ref(x, w, b, 1e-5))
    meta = torch.empty(2, 4, 4, 32, device="meta")
    assert norms.group_norm(meta, w.to("meta"), b.to("meta"), 8, 1e-5).shape == meta.shape
    assert norms.launch_counts() == before


def _plain_grads(fn, x, w, b, dy):
    leaves = [t.detach().clone().requires_grad_() for t in (x, w, b)]
    out = fn(*leaves)
    out.backward(dy)
    return [out.detach()] + [t.grad for t in leaves]


def _function_grads(apply, x, w, b, dy, need=(True, True, True)):
    leaves = [t.detach().clone().requires_grad_(n) for t, n in zip((x, w, b), need)]
    out = apply(*leaves)
    out.backward(dy)
    return [out.detach()] + [t.grad for t in leaves]


@pytest.mark.parametrize("silu", [False, True], ids=["gn", "gn_silu"])
@pytest.mark.parametrize("shape", GN_SHAPES + [(2, 16, 16, 32, 32)],
                         ids=lambda s: "x".join(map(str, s)))
def test_group_norm_function_matches_autograd_through_the_plain_chain(shape, silu):
    """The Function's backward on the CPU (the kernels' algebra: x̂ from the
    kept statistics, the SiLU recomputed, g = dy' γ, dx = rstd (g - mean(g) -
    x̂ mean(g x̂)), dγ and dβ summed) against autograd, fp32. A mean far from
    0 checks that the statistics do not cancel."""
    *xs, groups = shape
    for shift in (0.0, 30.0):
        x, w, b, dy = _inputs(tuple(xs), seed=2, shift=shift)
        want = _plain_grads(lambda *t: norms.group_norm_ref(*t, groups, 1e-5, silu), x, w, b, dy)
        got = _function_grads(lambda *t: norms._GroupNorm.apply(*t, groups, 1e-5, silu),
                              x, w, b, dy)
        assert torch.equal(got[0], want[0])
        for g, r in zip(got[1:], want[1:]):
            torch.testing.assert_close(g, r, rtol=2e-5, atol=2e-5 * float(r.abs().max()))


@pytest.mark.parametrize("shape", [(2, 7, 32), (3, 77, 48), (4, 36), (2, 3, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_layer_norm_function_matches_autograd_through_the_plain_chain(shape):
    for shift in (0.0, 30.0):
        x, w, b, dy = _inputs(shape, seed=3, shift=shift)
        want = _plain_grads(lambda *t: norms.layer_norm_ref(*t, 1e-5), x, w, b, dy)
        got = _function_grads(lambda *t: norms._LayerNorm.apply(*t, 1e-5), x, w, b, dy)
        assert torch.equal(got[0], want[0])
        for g, r in zip(got[1:], want[1:]):
            torch.testing.assert_close(g, r, rtol=2e-5, atol=2e-5 * float(r.abs().max()))


def test_the_function_skips_the_affine_gradients_nobody_asks_for():
    """Frozen γ and β (every LoRA run): the backward gives them no gradient."""
    x, w, b, dy = _inputs((2, 4, 4, 32), seed=4)
    got = _function_grads(lambda *t: norms._GroupNorm.apply(*t, 8, 1e-5, True), x, w, b, dy,
                          need=(True, False, False))
    assert got[1] is not None and got[2] is None and got[3] is None
    got = _function_grads(lambda *t: norms._LayerNorm.apply(*t, 1e-5), x, w, b, dy,
                          need=(True, False, False))
    assert got[1] is not None and got[2] is None and got[3] is None


# the norms of the cells' shapes: (batch, rows, channels) of the GroupNorms and
# (rows, channels) of the LayerNorms
GROUP_CASES = {
    "sdxl_128_320": (4, 128 * 128, 320), "sdxl_64_640": (4, 64 * 64, 640),
    "sdxl_32_1280": (4, 32 * 32, 1280), "sd15_face_96_320": (4, 96 * 96, 320),
    "render_128_320": (12, 128 * 128, 320), "vae_512_256": (1, 512 * 512, 256),
    "vae_1024_128": (1, 1024 * 1024, 128), "tiny_cg4": (2, 8 * 8, 32),
    "odd_36": (3, 4, 36),
}
LAYER_CASES = {
    "sdxl_4096_640": (4 * 4096, 640), "sdxl_1024_1280": (4 * 1024, 1280),
    "sd15_3072_640": (4 * 3072, 640), "clip_l": (2 * 77, 768), "clip_g": (2 * 77, 1280),
    "tiny": (2 * 64, 32),
}


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_group_plan_covers_each_sample_in_tiles_the_kernel_takes(case, itemsize):
    batch, rows, c = GROUP_CASES[case]
    vec, cols, rpi, tile, tiles = norms.group_plan(batch, rows, c, itemsize)
    assert vec in (1, 16 // itemsize) and cols * vec == c
    assert (vec == 1) == (c % (16 // itemsize) != 0)
    assert cols * rpi <= norms.GROUP_MAX_THREADS and tile % rpi == 0
    assert (tiles - 1) * tile < rows <= tiles * tile and tiles <= 65535
    # enough blocks to fill the card where the rows allow it, and not many more
    assert batch * tiles <= 2 * norms.GROUP_BLOCKS
    assert batch * tiles >= min(norms.GROUP_BLOCKS // 2, batch * (rows // rpi))


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_plan_holds_a_row_in_a_warps_registers(case):
    rows, c = LAYER_CASES[case]
    for itemsize in (2, 4):
        nv, blocks = norms.layer_plan(rows, c, itemsize, affine=False)
        vec = 16 // itemsize
        assert nv in norms.LAYER_VECTORS and 32 * vec * (nv - 1) < c <= 32 * vec * nv
        assert blocks * norms.LAYER_WARPS >= rows
        assert norms.layer_plan(rows, c, itemsize, affine=True)[1] <= norms.AFFINE_BLOCKS


def test_layer_plan_hands_rows_that_do_not_fit_to_the_group_kernels():
    assert norms.layer_plan(10, 36, 2, False) is None  # not a 16-byte multiple
    assert norms.layer_plan(10, 2560, 4, False) is None  # beyond 10 vectors a lane
    assert norms.layer_plan(10, 2560, 2, False) == (10, 2)
    with pytest.raises(ValueError):
        norms.group_plan(1, 4, 4097 * 8, 2)


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "float*": ctypes.c_void_p,
            "unsigned long long*": ctypes.c_void_p, "long long": ctypes.c_longlong,
            "int": ctypes.c_int, "float": ctypes.c_float}


def test_norm_args_mirror_the_kernels_struct():
    """kernels.NormArgs lists csrc/norm.cu's `struct NormArgs` field for
    field, with the same types (ctypes lays them out as the compiler does)."""
    src = (kernels.CSRC / "norm.cu").read_text()
    body = re.search(r"struct NormArgs \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"^\s*([\w ]+?\*?)\s*(\w+);", body, re.M)
    assert [(n, _C_TYPES[t]) for t, n in fields] == list(kernels.NormArgs._fields_)
    assert kernels.EXPORTS["norm"][1] is kernels.NormArgs
    for fn in kernels.EXPORTS["norm"][0]:
        assert f'extern "C" int {fn}(const NormArgs* a, void* stream)' in src


def test_launch_counts_carry_the_norm_kernels():
    """The norms count their own launches, apart from flash's; the CLI's
    summary reports both."""
    from sd_lora_trainer_tpu_torch import main as tmain

    norms.reset_launch_counts()
    assert norms.launch_counts() == {"norm_fwd": 0, "norm_bwd": 0}
    norms.LAUNCHES["norm_fwd"] += 3
    assert norms.launch_counts()["norm_fwd"] == 3
    assert set(fa.launch_counts()) == {"flash_fwd", "flash_bwd"}
    assert tmain._launches() == {**fa.launch_counts(), "norm_fwd": 3, "norm_bwd": 0}
    norms.reset_launch_counts()
    assert norms.launch_counts()["norm_fwd"] == 0


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the norm kernels have no CPU mode")
    return torch.device("cuda")


def _tol(dtype):
    return 2e-2 if dtype == torch.bfloat16 else 1e-4


def _close(x, ref, tol):
    assert x.shape == ref.shape and x.dtype == ref.dtype
    assert torch.isfinite(x.float()).all()
    err = float((x.float() - ref.float()).abs().max())
    assert err <= tol * float(ref.float().abs().max()), err


def _card_inputs(shape, dtype, device, wdtype=None, seed=0):
    x, w, b, dy = _inputs(shape, torch.float32, seed=seed)
    wdtype = wdtype or dtype
    return (x.to(device, dtype), w.to(device, wdtype), b.to(device, wdtype), dy.to(device, dtype))


CARD_GROUP = [("sdxl_128_320", (4, 128 * 128, 320), 32, 1e-5),
              ("sdxl_64_640", (4, 64 * 64, 640), 32, 1e-5),
              ("sdxl_32_1280", (4, 32 * 32, 1280), 32, 1e-5),
              ("sd15_face_96_320", (4, 96 * 96, 320), 32, 1e-5),
              ("sd15_face_24_1280", (4, 24 * 24, 1280), 32, 1e-5),
              ("vae_512_256", (1, 512 * 512, 256), 32, 1e-6),
              ("tiny_cg4", (2, 8 * 8, 32), 8, 1e-5),
              ("odd_36", (3, 5 * 5, 36), 4, 1e-5)]


@pytest.mark.cuda
@pytest.mark.parametrize("silu", [False, True], ids=["gn", "gn_silu"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", CARD_GROUP, ids=[c[0] for c in CARD_GROUP])
def test_group_norm_kernels_match_the_plain_version(cuda_device, case, dtype, silu):
    _, shape, groups, eps = case
    x, w, b, dy = _card_inputs(shape, dtype, cuda_device)
    want = _plain_grads(lambda *t: norms.group_norm_ref(*t, groups, eps, silu), x, w, b, dy)
    before = norms.launch_counts()
    got = _function_grads(lambda *t: norms._GroupNorm.apply(*t, groups, eps, silu), x, w, b, dy)
    torch.cuda.synchronize()
    now = norms.launch_counts()
    assert now["norm_fwd"] == before["norm_fwd"] + 1 and now["norm_bwd"] == before["norm_bwd"] + 1
    tol = _tol(dtype)
    _close(got[0], want[0], tol)
    _close(got[1], want[1], tol)
    # dγ and dβ: sums over a sample's rows, fp32 both ways
    _close(got[2], want[2], tol)
    _close(got[3], want[3], tol)
    _, mean, rstd = norms.group_norm_fwd_kernel(x, w, b, groups, eps, silu)
    _, mean_r, rstd_r = norms.group_norm_fwd_ref(x, w, b, groups, eps, silu)
    _close(mean, mean_r, 1e-4)
    _close(rstd, rstd_r, 1e-4)


CARD_LAYER = [("sdxl_4096_640", (4, 4096, 640)), ("sdxl_1024_1280", (4, 1024, 1280)),
              ("sd15_9216_320", (4, 9216, 320)), ("sd15_ragged_3072_640", (4, 3072, 640)),
              ("clip_l", (3, 77, 768)), ("clip_g", (3, 77, 1280)), ("tiny", (2, 64, 32)),
              ("odd_36", (2, 9, 36)), ("wide_1600", (2, 16, 1600))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", CARD_LAYER, ids=[c[0] for c in CARD_LAYER])
def test_layer_norm_kernels_match_the_plain_version(cuda_device, case, dtype):
    name, shape = case
    x, w, b, dy = _card_inputs(shape, dtype, cuda_device, seed=1)
    if name.startswith("sd15_ragged"):  # the padded rows of a 2304-token level are zeros
        x[:, 2304:] = 0
    want = _plain_grads(lambda *t: norms.layer_norm_ref(*t, 1e-5), x, w, b, dy)
    got = _function_grads(lambda *t: norms._LayerNorm.apply(*t, 1e-5), x, w, b, dy)
    torch.cuda.synchronize()
    tol = _tol(dtype)
    for g, r in zip(got, want):
        _close(g, r, tol)


@pytest.mark.cuda
def test_the_kernels_take_gamma_and_beta_in_either_dtype(cuda_device):
    """bf16 activations with fp32 γ and β (a full finetune's fp32 master
    weights), and the gradients of γ and β in their own dtype."""
    for shape, fn, ref in (((2, 256, 320), lambda *t: norms._GroupNorm.apply(*t, 32, 1e-5, True),
                            lambda *t: norms.group_norm_ref(*t, 32, 1e-5, True)),
                           ((2, 77, 768), lambda *t: norms._LayerNorm.apply(*t, 1e-5),
                            lambda *t: norms.layer_norm_ref(*t, 1e-5))):
        x, w, b, dy = _card_inputs(shape, torch.bfloat16, cuda_device, wdtype=torch.float32)
        got, want = _function_grads(fn, x, w, b, dy), _plain_grads(ref, x, w, b, dy)
        torch.cuda.synchronize()
        for g, r in zip(got, want):
            _close(g, r, 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["group", "group_silu", "layer", "layer_affine"])
def test_every_launch_gives_the_same_bits(cuda_device, kind):
    """No float atomics: forward and backward (dγ and dβ too) repeat bit for bit."""
    if kind.startswith("group"):
        x, w, b, dy = _card_inputs((4, 64 * 64, 640), torch.bfloat16, cuda_device, seed=5)
        def run():
            return _function_grads(
                lambda *t: norms._GroupNorm.apply(*t, 32, 1e-5, kind == "group_silu"), x, w, b, dy)
    else:
        x, w, b, dy = _card_inputs((4, 1024, 1280), torch.bfloat16, cuda_device, seed=5)
        need = (True, kind == "layer_affine", kind == "layer_affine")
        def run():
            return _function_grads(lambda *t: norms._LayerNorm.apply(*t, 1e-5), x, w, b, dy, need)
    first = run()
    for _ in range(3):
        again = run()
        torch.cuda.synchronize()
        assert all((a is None and f is None) or torch.equal(a, f) for a, f in zip(again, first))


@pytest.mark.cuda
def test_layers_on_the_card_never_take_the_plain_versions(cuda_device, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in ("group_norm_ref", "group_norm_fwd_ref", "group_norm_bwd_ref", "layer_norm_ref",
                 "layer_norm_fwd_ref", "layer_norm_bwd_ref"):
        monkeypatch.setattr(norms, name, refuse)
    x, w, b, dy = _card_inputs((2, 16, 16, 320), torch.bfloat16, cuda_device)
    p = {"weight": w, "bias": b}
    leaf = x.detach().requires_grad_()
    norms.reset_launch_counts()
    out = layers.layer_norm(p, layers.group_norm(p, leaf, 32, silu=True))
    out.backward(dy)
    torch.cuda.synchronize()
    counts = norms.launch_counts()
    assert counts["norm_fwd"] == 2 and counts["norm_bwd"] == 2 and leaf.grad is not None


@pytest.mark.cuda
def test_graph_replays_count_the_launches_they_recorded(cuda_device):
    """Captured, a norm's launch is counted by the kernel on the device:
    each replay advances launch_counts() by the launches recorded."""
    x, w, b, dy = _card_inputs((4, 32 * 32, 640), torch.bfloat16, cuda_device)
    leaf = x.detach().requires_grad_()

    def body():
        out = norms.layer_norm(norms.group_norm(leaf, w, b, 32, 1e-5, True), w, b, 1e-5)
        (out.float() * dy.float()).sum().backward()

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        body()  # warm up off the capture
    torch.cuda.current_stream().wait_stream(stream)
    norms.prepare_graph_counts(cuda_device)
    norms.reset_launch_counts()
    recorded = dict(norms.RECORDED)
    graph = torch.cuda.CUDAGraph()
    leaf.grad = None
    with torch.cuda.graph(graph):
        body()
    per_replay = {k: norms.RECORDED[k] - recorded[k] for k in recorded}
    assert per_replay == {"norm_fwd": 2, "norm_bwd": 2}
    assert norms.launch_counts()["norm_fwd"] == 0  # a capture runs nothing
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    counts = norms.launch_counts()
    assert counts["norm_fwd"] == 6 and counts["norm_bwd"] == 6
    assert norms.LAUNCHES == {"norm_fwd": 0, "norm_bwd": 0}
