"""The port's sampler and validation render against the JAX package's.

Float32 on the CPU, tolerances with their reasons:
- Euler timesteps: equal (integers); sigmas within 1e-6 relative on the
  same alphas_cumprod table (a float32 sqrt and division, a couple of ulp
  apart) and within 3e-6 on each package's own table (the tables' float32
  linspace and cumprod differ by up to 1.5e-6 relative);
- one Euler step and the input scaling: 1e-6 relative (a few ulp);
- the prompt policy (`prepare_prompt_for_lora`, `compute_token_scale`) and
  the render prompts drawn from the seed: equal;
- a tiny SDXL render with a LoRA merged at 0.75 and TI rows, fed the JAX
  package's initial latents: the conditionings within 1e-5 relative, the
  sampled latents within 1e-4 relative, and the decoded images (in [0, 1])
  within 1e-3 max abs (float32 through 5 CFG Euler steps of the UNet and
  the VAE decoder in another summation order).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd_lora_trainer_tpu import inference as ji
from sd_lora_trainer_tpu.diffusion.schedulers import DDPMSchedule as JSchedule
from sd_lora_trainer_tpu.diffusion.schedulers import EulerDiscreteSampler as JEuler
from sd_lora_trainer_tpu.models import tokenizer as jt
from sd_lora_trainer_tpu.models import weights as jw
from sd_lora_trainer_tpu.models.lora import create_lora_params as j_create_lora
from sd_lora_trainer_tpu.models.vae import vae_decode_batched as j_decode
from sd_lora_trainer_tpu_torch import inference as ti
from sd_lora_trainer_tpu_torch.diffusion.schedulers import DDPMSchedule as TSchedule
from sd_lora_trainer_tpu_torch.diffusion.schedulers import EulerDiscreteSampler as TEuler
from sd_lora_trainer_tpu_torch.interop import from_jax_params
from sd_lora_trainer_tpu_torch.models import synthesize as ts
from sd_lora_trainer_tpu_torch.models import tokenizer as tt
from sd_lora_trainer_tpu_torch.models import weights as tw
from sd_lora_trainer_tpu_torch.models.unet import TINY_SDXL_UNET_CONFIG
from sd_lora_trainer_tpu_torch.models.vae import vae_decode_batched as t_decode


@pytest.fixture(autouse=True)
def _grad_mode_on():
    """Gradients need torch's grad mode, which tests/test_golden_torch.py
    switches off when imported (and pytest-xdist workers import every file)."""
    with torch.enable_grad():
        yield


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tiny models run faster so, and the tier-1
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("n_steps", [5, 25, 30])
def test_euler_schedule_and_step_match_jax(n_steps):
    js, ts_ = JEuler(JSchedule.create()), TEuler(TSchedule.create(device="cpu"))
    j_sig, j_t = js.sigmas_and_timesteps(n_steps)
    t_sig, t_t = ts_.sigmas_and_timesteps(n_steps)
    np.testing.assert_array_equal(t_t.numpy(), np.asarray(j_t))
    np.testing.assert_allclose(t_sig.numpy(), np.asarray(j_sig), rtol=3e-6, atol=0)
    same_table = TEuler(TSchedule(torch.tensor(np.asarray(js.schedule.alphas_cumprod)), 1000,
                                  "epsilon"))
    np.testing.assert_allclose(same_table.sigmas_and_timesteps(n_steps)[0].numpy(),
                               np.asarray(j_sig), rtol=1e-6, atol=0)
    np.testing.assert_allclose(ts_.init_noise_sigma(n_steps).numpy(),
                               np.asarray(js.init_noise_sigma(n_steps)), rtol=3e-6)
    rs = np.random.RandomState(n_steps)
    x, eps = (rs.randn(2, 8, 8, 4).astype(np.float32) for _ in range(2))
    i = n_steps // 2
    j_next = js.step(jnp.asarray(eps), j_sig[i], j_sig[i + 1], jnp.asarray(x))
    t_next = ts_.step(torch.from_numpy(eps), t_sig[i], t_sig[i + 1], torch.from_numpy(x))
    assert _rel(t_next, j_next) <= 1e-6
    assert _rel(ts_.scale_model_input(torch.from_numpy(x), t_sig[i]),
                JEuler.scale_model_input(jnp.asarray(x), j_sig[i])) <= 1e-6


def _lora_dir(path, mode, name="myconcept"):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "special_params.json"), "w") as f:
        json.dump({"TOK": "<s0><s1><s2>"}, f)
    with open(os.path.join(path, "training_args.json"), "w") as f:
        json.dump({"name": name, "concept_mode": mode,
                   "training_attributes": {"trigger_text": "TOK, "}}, f)
    return str(path)


@pytest.mark.parametrize("mode", ["style", "object", "face"])
def test_prompt_policy_matches_jax(mode, tmp_path):
    path = _lora_dir(tmp_path / mode, mode)
    for prompt in ("<concept>", "", "a photo of <concept> on a beach", "in the style of myconcept",
                   "<myconcept> and <concepts> dog", "TOK,, at night . "):
        assert ti.prepare_prompt_for_lora(prompt, path) == ji.prepare_prompt_for_lora(prompt, path)
    for s in (0.0, 0.3, 0.75, 1.0):
        assert ti.compute_token_scale(s) == ji.compute_token_scale(s)


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    root = tmp_path_factory.mktemp("render")
    path = str(root / "tiny.safetensors")
    ts.synthesize_checkpoint(path, "sdxl", TINY_SDXL_UNET_CONFIG, ts.TINY_VAE_CONFIG,
                             ts.TINY_CLIP_L_CONFIG, ts.TINY_CLIP_G_CONFIG, seed=5, device="cpu")
    jm = jw.load_models_from_checkpoint(path, dtype=jnp.float32)
    tm = tw.load_models_from_checkpoint(path, dtype=torch.float32, device="cpu")
    vocab, merges = jt.build_sized_test_vocab(256, extra_words=["photo", "style", "the"])
    toks = {}
    for name, mod in (("jax", jt), ("port", tt)):
        toks[name] = [mod.CLIPTokenizer(vocab, merges), mod.CLIPTokenizer(vocab, merges,
                                                                           pad_token_id=0)]
        for tok in toks[name]:
            tok.add_special_tokens(["<s0>", "<s1>", "<s2>"])
    rows = [np.random.RandomState(i).randn(3, 32).astype(np.float32) * 0.02 for i in (0, 1)]
    lora = j_create_lora(jax.random.PRNGKey(0), jm.unet, rank=2)
    lora = jax.tree.map(lambda x: x + 0.05 if hasattr(x, "shape") and x.ndim > 0 else x, lora)
    common = dict(version="sdxl", unet_config=None, te1_config=None, te2_config=None,
                  vae_config=None)
    jp = ji.InferencePipeline(
        **{**common, "unet_config": jm.unet_config, "te1_config": jm.text_encoder_config,
           "te2_config": jm.text_encoder_2_config, "vae_config": jm.vae_config},
        unet_params=jm.unet, te1_params=jm.text_encoder, te2_params=jm.text_encoder_2,
        vae_params=jm.vae, tokenizer_1=toks["jax"][0], tokenizer_2=toks["jax"][1],
        schedule=JSchedule.create(), ti_rows=[jnp.asarray(r) for r in rows])
    tp = ti.InferencePipeline(
        **{**common, "unet_config": tm.unet_config, "te1_config": tm.text_encoder_config,
           "te2_config": tm.text_encoder_2_config, "vae_config": tm.vae_config},
        unet_params=tm.unet, te1_params=tm.text_encoder, te2_params=tm.text_encoder_2,
        vae_params=tm.vae, tokenizer_1=toks["port"][0], tokenizer_2=toks["port"][1],
        schedule=TSchedule.create(device="cpu"), ti_rows=[torch.from_numpy(r) for r in rows])
    return jp, tp, lora, from_jax_params(lora, device="cpu"), root


def test_tiny_render_matches_jax(pipes):
    from sd_lora_trainer_tpu.models.lora import merge_lora as j_merge
    from sd_lora_trainer_tpu_torch.models.lora import merge_lora as t_merge

    jp, tp, jlora, tlora, root = pipes
    lora_path = _lora_dir(root / "ckpt", "style")
    size, n, n_steps, seed = (64, 64), 2, 5, 3
    # the JAX render's initial latents: one split of the seed's key per prompt
    key, draws = jax.random.PRNGKey(seed), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.normal(sub, (1, 32, 32, 4), jnp.float32)))
    latents = np.concatenate(draws)

    kw = dict(render_size=size, lora_path=lora_path, train_step=0, seed=seed, lora_scale=0.75,
              n_imgs=n, n_steps=n_steps, precision="fp32")
    j_prompts = ji.render_images(jp, unet_lora=jlora, **kw)
    t_prompts = ti.render_images(tp, unet_lora=tlora, latents=torch.from_numpy(latents), **kw)
    assert t_prompts == j_prompts and j_prompts[0] == ""
    assert sorted(os.listdir(lora_path)) == ["img_0000_0.jpg", "img_0000_1.jpg",
                                             "special_params.json", "training_args.json"]

    # the same render, piece by piece, in float32
    jc, tc = [], []
    j_neg, t_neg = ji._encode(jp, [ji.NEGATIVE_PROMPT], size), ti._encode(tp, [ti.NEGATIVE_PROMPT], size)
    for prompt in j_prompts:
        jc.append(ji.encode_prompt_advanced(jp, lora_path, prompt, ji.NEGATIVE_PROMPT, 0.75, size,
                                            concept_mode="style", negative_cache=j_neg[:2]))
        tc.append(ti.encode_prompt_advanced(tp, lora_path, prompt, ti.NEGATIVE_PROMPT, 0.75, size,
                                            concept_mode="style", negative_cache=t_neg[:2]))
        for a, b in zip(tc[-1], jc[-1]):
            assert _rel(a, b) <= 1e-5
    junet = j_merge(jp.unet_params, jlora, scale=0.75)
    tunet = t_merge(tp.unet_params, tlora, scale=0.75)

    def stack(parts, i, tile):
        return [p[i] for p in parts] if not tile else [p[i] for p in parts[:1]] * n

    j_args = [jnp.concatenate(stack(jc, i, i in (1, 3))) for i in range(5)]
    t_args = [torch.cat(stack(tc, i, i in (1, 3))) for i in range(5)]
    zj = ji._sample((jp.unet_config, "sdxl", None), junet, jnp.asarray(latents), *j_args,
                    n_steps, 8.0, compute_dtype=jnp.float32, use_flash=False)
    zt = ti._sample(tp, tunet, torch.from_numpy(latents), *t_args, n_steps, 8.0,
                    compute_dtype=torch.float32, use_flash=False)
    assert _rel(zt, zj) <= 1e-4
    img_j = (np.clip(np.asarray(j_decode(jp.vae_params, zj, jp.vae_config)), -1, 1) + 1) / 2
    with torch.no_grad():
        img_t = (torch.clamp(t_decode(tp.vae_params, zt, tp.vae_config), -1, 1) + 1) / 2
    assert img_t.shape == (n, 64, 64, 3)
    assert float(np.abs(img_t.numpy() - img_j).max()) <= 1e-3


def test_render_keeps_no_flash_residuals():
    """The render runs under no_grad: the flash op returns a tensor without
    a graph, so it saves nothing for a backward."""
    from sd_lora_trainer_tpu_torch.ops.flash_attention import flash_attention

    q, k, v = (torch.randn(1, 2, 256, 64, requires_grad=True) for _ in range(3))
    with torch.no_grad():
        o, lse = flash_attention(q, k, v, 0.125, 0)
    assert o.grad_fn is None and lse.grad_fn is None
    o, _ = flash_attention(q, k, v, 0.125, 0)
    assert o.grad_fn is not None
