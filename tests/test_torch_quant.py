"""The port's int8 frozen base (models/quant.py) against the JAX package's.

Float32 on the CPU. Checked:
- `quantize_kernel`'s codes and scales equal JAX's bit for bit on the same
  weights (transposed: the port's output channel is axis 0), dense and conv;
- which leaves `quantize_base_weights` quantizes (the tiny SDXL UNet and
  both text encoders), idempotency, and `quantized_bytes_saved`, as JAX;
- `QTensor` dequantizes as JAX's astype chain, bit for bit, in one kernel;
- a fused qkv/kv QTensor equals the concatenation of the dequantized
  projections, and JAX's fused QTensor;
- the tiny SDXL `unet_forward` on the int8 base equals JAX's on the same
  codes within atol 5e-5 (tests/test_torch_unet_conditioning.py's);
- `merge_lora` over an int8 base equals JAX's (1e-6: the same float32
  products, transposed);
- `quantize_frozen` replaces the UNet's (and for "int8+te" the encoders')
  weights and reports the bytes it freed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd_lora_trainer_tpu.models import clip as j_clip
from sd_lora_trainer_tpu.models import fuse as j_fuse
from sd_lora_trainer_tpu.models import lora as j_lora
from sd_lora_trainer_tpu.models import quant as jq
from sd_lora_trainer_tpu.models import synthesize as j_synth
from sd_lora_trainer_tpu.models import unet as j_unet
from sd_lora_trainer_tpu_torch.interop import from_jax_params
from sd_lora_trainer_tpu_torch.models import quant as tq
from sd_lora_trainer_tpu_torch.models import unet as t_unet
from sd_lora_trainer_tpu_torch.models.fuse import fuse_attention_projections
from sd_lora_trainer_tpu_torch.models.lora import merge_lora
from tests.test_torch_named_remat import _flat, tiny_sdxl


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU threads contend with the JAX CPU client's (8 virtual
    devices, tests/conftest.py): the tiny UNet's step takes ~10x longer."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    return from_jax_params(_np(tree), device="cpu")


@pytest.mark.parametrize("shape", [(64, 96), (3, 3, 16, 24), (8, 5)], ids=["dense", "conv", "zero"])
def test_quantize_kernel_codes_and_scales_equal_jax(shape):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal(shape) * np.exp(rng.standard_normal(shape[-1]))).astype(np.float32)
    if shape == (8, 5):
        w[:, 2] = 0.0  # an all-zero output channel: scale 1, codes 0
    want = _port({"kernel": jq.quantize_kernel(jnp.asarray(w))})["weight"]
    got = tq.quantize_kernel(_port({"kernel": w})["weight"])
    assert isinstance(want, tq.QTensor) and got.q.dtype == torch.int8
    assert torch.equal(got.q, want.q) and torch.equal(got.s, want.s)
    assert got.s.shape == (shape[-1],) + (1,) * (len(shape) - 1)
    assert got.shape == got.q.shape and got.ndim == len(shape) and got.dtype == torch.float32


def test_qtensor_dequantizes_like_jax_in_one_kernel():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((48, 32)).astype(np.float32)
    qt = tq.quantize_kernel(torch.tensor(w), dtype=torch.bfloat16)
    want = (qt.q.float() * qt.s).to(torch.bfloat16)
    assert qt.dtype == torch.bfloat16 and qt.device == torch.device("cpu")
    assert torch.equal(qt.to(torch.bfloat16), want)
    assert torch.equal(qt.float(), qt.q.float() * qt.s)
    jw = np.asarray(jq.QTensor(jnp.asarray(qt.q.numpy().T), jnp.asarray(qt.s.numpy().T))
                    .astype(jnp.float32))
    np.testing.assert_array_equal(qt.float().numpy(), jw.T)


@pytest.fixture(scope="module")
def tiny():
    return tiny_sdxl()


def test_quantize_base_weights_leaves_and_bytes_match_jax(tiny):
    cfg, params, _, _, _ = tiny
    te = _np(jax.jit(j_clip.init_clip_params, static_argnums=1)(jax.random.PRNGKey(3),
                                                                 j_synth.TINY_CLIP_G_CONFIG))
    for tree in (params, te):
        # eager, as the JAX quantizer's own tests run it: under jit XLA may
        # take amax / 127 as amax * (1 / 127), one ulp off in some scales
        jqt = jq.quantize_base_weights(jax.tree.map(jnp.asarray, tree))
        want = _flat(_port(jqt))
        got = tq.quantize_base_weights(_port(tree))
        flat = _flat(got)
        assert sorted(flat) == sorted(want)
        n_q = 0
        for k, w in want.items():
            assert isinstance(flat[k], tq.QTensor) == isinstance(w, tq.QTensor), k
            if isinstance(w, tq.QTensor):
                n_q += 1
                assert torch.equal(flat[k].q, w.q) and torch.equal(flat[k].s, w.s), k
            else:
                assert torch.equal(flat[k], w), k
        assert n_q > 10
        assert tq.quantized_bytes_saved(got) == jq.quantized_bytes_saved(jqt)
        again = tq.quantize_base_weights(got)
        assert all(again_leaf is flat[k] for k, again_leaf in _flat(again).items())
    skipped = _flat(tq.quantize_base_weights(_port(params)))
    assert not isinstance(skipped["conv_in.weight"], tq.QTensor)
    assert not isinstance(skipped["conv_out.weight"], tq.QTensor)


def test_fused_qtensor_equals_concat_of_dequants_and_jax(tiny):
    _, params, _, _, _ = tiny
    got = fuse_attention_projections(tq.quantize_base_weights(_port(params)))
    want = _port(j_fuse.fuse_attention_projections(
        jq.quantize_base_weights(jax.tree.map(jnp.asarray, params))))
    tb = got["down_blocks"][1]["attentions"][0]["transformer_blocks"][0]
    tb_j = want["down_blocks"][1]["attentions"][0]["transformer_blocks"][0]
    unfused = _port(params)["down_blocks"][1]["attentions"][0]["transformer_blocks"][0]
    for attn, key, names in (("attn1", "qkv", ("to_q", "to_k", "to_v")),
                             ("attn2", "kv", ("to_k", "to_v"))):
        fused = tb[attn][key]["weight"]
        assert isinstance(fused, tq.QTensor)
        parts = [tq.quantize_kernel(unfused[attn][n]["weight"]).float() for n in names]
        assert torch.equal(fused.float(), torch.cat(parts, dim=0))
        assert torch.equal(fused.q, tb_j[attn][key]["weight"].q)
        assert torch.equal(fused.s, tb_j[attn][key]["weight"].s)


def test_unet_forward_on_int8_base_matches_jax(tiny):
    cfg, params, (lat, t, ctx, added), (tlat, tt, tctx), tadded = tiny
    jqp = jax.jit(jq.quantize_base_weights)(params)
    out_j, _ = jax.jit(lambda p: j_unet.unet_forward(
        p, lat, t, ctx, cfg, added_cond=added, use_flash=False, remat=False))(jqp)
    tcfg = t_unet.UNetConfig(**cfg.__dict__)
    base = _port(jqp)  # JAX's codes and scales
    for p in (base, fuse_attention_projections(base)):
        out_t, _ = t_unet.unet_forward(p, tlat, tt, tctx, tcfg, added_cond=tadded,
                                       remat="light+save:flash_out*,flash_lse*")
        np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=5e-5, rtol=0)
    # and the int8 base moved the output (the codes are not the weights)
    out_f, _ = t_unet.unet_forward(_port(params), tlat, tt, tctx, tcfg, added_cond=tadded)
    assert float((out_f - out_t).abs().max()) > 1e-4


def test_merge_lora_over_int8_base_matches_jax(tiny):
    _, params, _, _, _ = tiny
    jp = jax.tree.map(jnp.asarray, params)
    lora = j_lora.create_lora_params(jax.random.PRNGKey(1), jp, rank=4)
    lora = jax.tree.map(lambda x: x + 0.01 if hasattr(x, "ndim") and x.ndim in (2, 4) else x, lora)
    want = _flat(_port(j_lora.merge_lora(jax.jit(jq.quantize_base_weights)(jp), lora, scale=0.8)))
    got = _flat(merge_lora(tq.quantize_base_weights(_port(params)), _port(lora), scale=0.8))
    assert sorted(got) == sorted(want)
    n_merged = 0
    for k, w in want.items():
        if isinstance(w, tq.QTensor):  # untargeted: stays int8
            assert isinstance(got[k], tq.QTensor) and torch.equal(got[k].q, w.q), k
            continue
        n_merged += k.endswith(("to_q.weight", "conv2.weight"))
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0, atol=1e-6, err_msg=k)
    assert n_merged > 0


@dataclasses.dataclass
class _Frozen:
    unet_params: dict
    te1_params: dict
    te2_params: object


@pytest.mark.parametrize("mode", ["none", "int8", "int8+te"])
def test_quantize_frozen_replaces_weights_and_counts_bytes(tiny, mode):
    _, params, _, _, _ = tiny
    te = _port(jax.jit(j_clip.init_clip_params, static_argnums=1)(jax.random.PRNGKey(4),
                                                                  j_synth.TINY_CLIP_L_CONFIG))
    frozen = _Frozen(_port(params), te, None)
    unet_before = frozen.unet_params
    freed = tq.quantize_frozen(frozen, mode)
    n_q = {name: sum(isinstance(v, tq.QTensor) for v in _flat(getattr(frozen, name)).values())
           for name in ("unet_params", "te1_params")}
    assert (n_q["unet_params"] > 0) == (mode != "none")
    assert (n_q["te1_params"] > 0) == (mode == "int8+te")
    # float32 -> int8 codes and one fp32 scale per output channel
    want = 0
    for name in ("unet_params", "te1_params"):
        for k, v in _flat(getattr(frozen, name)).items():
            if isinstance(v, tq.QTensor):
                want += 3 * v.q.numel() - 4 * v.s.numel()
    assert freed == pytest.approx(want / 2**30, rel=1e-12)
    assert (frozen.unet_params is unet_before) == (mode == "none")
    assert isinstance(_flat(frozen.te1_params)["text_model.embeddings.token_embedding.weight"],
                      torch.Tensor)
    with pytest.raises(ValueError):
        tq.quantize_frozen(frozen, "int4")
