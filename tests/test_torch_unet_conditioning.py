"""The port's UNet forward and text conditioning against the JAX package's.

Tiny SDXL and SD1.5 configs, float32 on the CPU, the JAX package's random
weights and LoRA trees passed through `from_jax_params` (LoRA B is made
nonzero so every adapter gets a gradient). Compared: the noise prediction,
the DAAM scores, the gradients with respect to every LoRA matrix, and the
SDXL/SD1.5 conditioning with TI rows and their gradients.

Tolerances: atol 5e-5 on the prediction and conditioning, 5e-4 on the DAAM
scores (sums over heads of unnormalized logits, as tests/test_module_pad.py
holds them), and 1e-4 + 1e-3 relative on the LoRA gradients (sums over every
pixel of the batch through ~20 layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sd_lora_trainer_tpu_torch.models.unet as t_unet
import sd_lora_trainer_tpu_torch.ops.attention as t_attention
from sd_lora_trainer_tpu.models import clip as j_clip
from sd_lora_trainer_tpu.models import conditioning as j_cond
from sd_lora_trainer_tpu.models import fuse as j_fuse
from sd_lora_trainer_tpu.models import lora as j_lora
from sd_lora_trainer_tpu.models import synthesize as j_synth
from sd_lora_trainer_tpu.models import unet as j_unet
from sd_lora_trainer_tpu_torch.interop import from_jax_params
from sd_lora_trainer_tpu_torch.models import clip as t_clip
from sd_lora_trainer_tpu_torch.models import conditioning as t_cond
from sd_lora_trainer_tpu_torch.models.fuse import fuse_attention_projections
from sd_lora_trainer_tpu_torch.models.lora import inject_lora, iter_lora_leaves


@pytest.fixture(autouse=True)
def _grad_mode_on():
    """Gradients need torch's grad mode, which tests/test_golden_torch.py
    switches off when imported (and pytest-xdist workers import every file)."""
    with torch.enable_grad():
        yield


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _nonzero_b(lora_tree, seed):
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict) and "a" in node:
            out = dict(node)
            out["b"] = (rng.standard_normal(np.shape(node["b"])) * 0.05).astype(np.float32)
            return out
        return {k: walk(v) for k, v in node.items()} if isinstance(node, dict) else node

    return walk(lora_tree)


def _unet_inputs(cfg, h, w, seed=1):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((2, h, w, 4), np.float32)
    t = np.asarray([10, 700], np.int32)
    ctx = rng.standard_normal((2, 77, cfg.cross_attention_dim), np.float32)
    added = None
    if cfg.addition_embed_dim is not None:
        added = {
            "text_embeds": rng.standard_normal((2, cfg.addition_pooled_dim), np.float32),
            "time_ids": np.tile(np.asarray([[1024, 1024, 0, 0, 8 * h, 8 * w]], np.float32), (2, 1)),
        }
    return lat, t, ctx, added


def _forced_gate(q_shape, k_shape, heads, device):
    """Take the flash path (its plain version on the CPU) at the tiny widths."""
    return q_shape[1] == k_shape[1] and q_shape[1] >= 64


@pytest.mark.parametrize("case", ["sdxl", "sdxl_fused_ragged_flash", "sd15_remat"])
def test_unet_forward_scores_and_lora_grads_match_jax(case, monkeypatch):
    version = case.split("_")[0]
    jcfg = j_unet.TINY_SDXL_UNET_CONFIG if version == "sdxl" else j_unet.TINY_SD15_UNET_CONFIG
    tcfg = t_unet.TINY_SDXL_UNET_CONFIG if version == "sdxl" else t_unet.TINY_SD15_UNET_CONFIG
    assert tcfg == t_unet.UNetConfig(**jcfg.__dict__)
    h, w = (16, 20) if "ragged" in case else (16, 16)

    base = j_unet.init_unet_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    lora = _nonzero_b(j_lora.create_lora_params(jax.random.PRNGKey(1), base, rank=4), 2)
    lat, t, ctx, added = _unet_inputs(jcfg, h, w)

    def jax_fwd(lora_tree):
        out, scores = j_unet.unet_forward(
            j_lora.inject_lora(base, lora_tree), lat, t, ctx, jcfg, added_cond=added,
            capture_attn=True, use_flash=True, remat=False,
        )
        return out, scores

    def jax_loss(lora_tree):
        out, scores = jax_fwd(lora_tree)
        loss = jnp.sum(jnp.sin(out)) + sum(jnp.sum(jnp.tanh(s)) for s in scores.values())
        return loss, (out, scores)

    (_, (out_j, scores_j)), grads_j = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(lora)
    grads_j = from_jax_params(_np_tree(grads_j))

    tbase = from_jax_params(_np_tree(base))
    tlora = from_jax_params(_np_tree(lora), requires_grad=True)
    if "fused" in case:
        tbase = fuse_attention_projections(tbase)
    if "flash" in case:
        monkeypatch.setattr(t_unet, "flash_attention_qualifies", _forced_gate)
        monkeypatch.setattr(t_attention, "flash_attention_qualifies", _forced_gate)
    tadded = {k: torch.tensor(v) for k, v in added.items()} if added else None
    out_t, scores_t = t_unet.unet_forward(
        inject_lora(tbase, tlora), torch.tensor(lat), torch.tensor(t), torch.tensor(ctx), tcfg,
        added_cond=tadded, capture_attn=True, use_flash=True, remat="remat" in case,
    )
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=5e-5, rtol=0)
    assert sorted(scores_t) == sorted(scores_j) and scores_t
    for name in scores_j:
        np.testing.assert_allclose(scores_t[name].detach().numpy(), np.asarray(scores_j[name]),
                                   atol=5e-4, rtol=0)
    loss_t = torch.sin(out_t).sum() + sum(torch.tanh(s).sum() for s in scores_t.values())
    loss_t.backward()
    leaves_t = dict(iter_lora_leaves(tlora))
    leaves_j = dict(iter_lora_leaves(grads_j))
    assert sorted(leaves_t) == sorted(leaves_j)
    for path, entry in leaves_t.items():
        for m in ("a", "b"):
            np.testing.assert_allclose(entry[m].grad.numpy(), leaves_j[path][m].numpy(),
                                       atol=1e-4, rtol=1e-3, err_msg=f"{path}.{m}")


def _ids(seed, vocab, n_ti=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab - 2, (2, 77)).astype(np.int32)
    ids[:, 0] = vocab - 2
    ids[:, 2:2 + n_ti] = vocab + np.arange(n_ti)  # TI ids appended to the table
    ids[0, 8:] = vocab - 1  # EOS then padding
    ids[1, 20:] = vocab - 1
    return ids


def test_sdxl_conditioning_with_ti_rows_matches_jax():
    c1, c2 = j_synth.TINY_CLIP_L_CONFIG, j_synth.TINY_CLIP_G_CONFIG
    assert t_clip.TINY_CLIP_L_CONFIG == t_clip.CLIPTextConfig(**c1.__dict__)
    assert t_clip.TINY_CLIP_G_CONFIG == t_clip.CLIPTextConfig(**c2.__dict__)
    te1 = j_clip.init_clip_params(jax.random.PRNGKey(3), c1)
    te2 = j_clip.init_clip_params(jax.random.PRNGKey(4), c2)
    rng = np.random.default_rng(5)
    ti1, ti2 = (rng.standard_normal((3, 32), np.float32) * 0.02 for _ in range(2))
    ids1, ids2 = _ids(6, c1.vocab_size), _ids(7, c2.vocab_size)

    def jax_cond(ti1, ti2):
        return j_cond.sdxl_conditioning(te1, te2, ids1, ids2, c1, c2, (64, 48), ti1, ti2,
                                        dtype=jnp.float32)

    pe_j, pooled_j, tid_j = jax_cond(ti1, ti2)
    g_j = jax.grad(lambda a, b: sum(jnp.sum(jnp.sin(x)) for x in jax_cond(a, b)[:2]),
                   argnums=(0, 1))(ti1, ti2)

    tti1, tti2 = (torch.tensor(x, requires_grad=True) for x in (ti1, ti2))
    pe_t, pooled_t, tid_t = t_cond.sdxl_conditioning(
        from_jax_params(_np_tree(te1)), from_jax_params(_np_tree(te2)), torch.tensor(ids1),
        torch.tensor(ids2), t_clip.TINY_CLIP_L_CONFIG, t_clip.TINY_CLIP_G_CONFIG, (64, 48),
        tti1, tti2, dtype=torch.float32,
    )
    for t, j in ((pe_t, pe_j), (pooled_t, pooled_j), (tid_t, tid_j)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=5e-5, rtol=0)
    (torch.sin(pe_t).sum() + torch.sin(pooled_t).sum()).backward()
    np.testing.assert_allclose(tti1.grad.numpy(), np.asarray(g_j[0]), atol=5e-5, rtol=0)
    np.testing.assert_allclose(tti2.grad.numpy(), np.asarray(g_j[1]), atol=5e-5, rtol=0)
    assert np.abs(tti1.grad.numpy()).sum() > 0


def test_sd15_conditioning_with_ti_rows_matches_jax():
    c1 = j_synth.TINY_CLIP_L_CONFIG
    te1 = j_clip.init_clip_params(jax.random.PRNGKey(8), c1)
    ti = np.random.default_rng(9).standard_normal((3, 32)).astype(np.float32) * 0.02
    ids = _ids(10, c1.vocab_size)
    pe_j, _, _ = j_cond.sd15_conditioning(te1, ids, c1, ti, dtype=jnp.float32)
    g_j = jax.grad(lambda r: jnp.sum(jnp.sin(
        j_cond.sd15_conditioning(te1, ids, c1, r, dtype=jnp.float32)[0])))(ti)
    tti = torch.tensor(ti, requires_grad=True)
    pe_t, none1, none2 = t_cond.sd15_conditioning(
        from_jax_params(_np_tree(te1)), torch.tensor(ids), t_clip.TINY_CLIP_L_CONFIG, tti,
        dtype=torch.float32,
    )
    assert none1 is None and none2 is None
    np.testing.assert_allclose(pe_t.detach().numpy(), np.asarray(pe_j), atol=5e-5, rtol=0)
    torch.sin(pe_t).sum().backward()
    np.testing.assert_allclose(tti.grad.numpy(), np.asarray(g_j), atol=5e-5, rtol=0)


def test_fused_projections_match_jax_layout():
    base = j_unet.init_unet_params(jax.random.PRNGKey(11), j_unet.TINY_SDXL_UNET_CONFIG,
                                   dtype=jnp.float32)
    fused_j = from_jax_params(_np_tree(j_fuse.fuse_attention_projections(base)))
    fused_t = fuse_attention_projections(from_jax_params(_np_tree(base)))
    tb_j = fused_j["down_blocks"][1]["attentions"][0]["transformer_blocks"][0]
    tb_t = fused_t["down_blocks"][1]["attentions"][0]["transformer_blocks"][0]
    for attn, key in (("attn1", "qkv"), ("attn2", "kv")):
        assert torch.equal(tb_t[attn][key]["weight"], tb_j[attn][key]["weight"])
        assert "weight" not in tb_t[attn]["to_k"]
