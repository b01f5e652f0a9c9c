"""How far an int8 frozen base moves the LoRA-B gradients, in both packages.

chip_smoke.py's reference phase holds the int8 base's LoRA-B gradients
against the unquantized base's with the JAX package's int8 bound (3e-2,
tests/test_quant.py), which that package sets on the UNet's output, not on
gradients. Here the same gap is measured with the JAX package's
`compute_loss` and `quantize_base_weights` and with the port's, on the
reference phase's topology and inputs: JAX's tiny SDXL UNet (head dim 32)
and tiny CLIP encoders, float32, a batch of 2 at 512px (64x64 latents),
rank-4 LoRA (B = 0, so its gradients carry every attention and resnet
product), 3 TI rows an encoder, the style SDXL config's loss terms under
its resolved default plan, the base quantized before the qkv fusion, as
both CLIs do. Weights and draws are JAX's, handed to the port.

Gate: the port's gap equals JAX's within float32 rounding of the
gradients it is made of, 1e-3 of the gap (the two packages' gradients
agree to ~1e-5 relative, tests/test_torch_step.py), so the int8 base moves
the port's gradients exactly as far as JAX's own int8 base moves JAX's.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd_lora_trainer_tpu.config import TrainingConfig as JConfig
from sd_lora_trainer_tpu.diffusion import losses as jl
from sd_lora_trainer_tpu.diffusion.schedulers import DDPMSchedule as JSchedule
from sd_lora_trainer_tpu.models import quant as jq
from sd_lora_trainer_tpu.models.clip import init_clip_params as j_init_clip
from sd_lora_trainer_tpu.models.fuse import fuse_attention_projections as j_fuse
from sd_lora_trainer_tpu.models.lora import create_lora_params as j_create_lora
from sd_lora_trainer_tpu.models.synthesize import TINY_CLIP_G_CONFIG, TINY_CLIP_L_CONFIG
from sd_lora_trainer_tpu.models.unet import TINY_SDXL_UNET_CONFIG, init_unet_params
from sd_lora_trainer_tpu.training import step as js
from sd_lora_trainer_tpu_torch.config import TrainingConfig as TConfig
from sd_lora_trainer_tpu_torch.diffusion import losses as tl
from sd_lora_trainer_tpu_torch.diffusion.schedulers import DDPMSchedule as TSchedule
from sd_lora_trainer_tpu_torch.interop import from_jax_params
from sd_lora_trainer_tpu_torch.models import clip as t_clip
from sd_lora_trainer_tpu_torch.models import unet as t_unet
from sd_lora_trainer_tpu_torch.models.fuse import fuse_attention_projections as t_fuse
from sd_lora_trainer_tpu_torch.models.lora import iter_lora_leaves
from sd_lora_trainer_tpu_torch.models.quant import quantize_base_weights as t_quantize
from sd_lora_trainer_tpu_torch.training import step as ts
from tests.test_torch_step import _jax_draws

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GAP_RTOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU threads contend with the JAX CPU client's and the other
    tier-1 workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _grad_mode_on():
    """Gradients need torch's grad mode, which tests/test_golden_torch.py
    switches off when imported (and pytest-xdist workers import every file)."""
    with torch.enable_grad():
        yield


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _configs():
    with open(os.path.join(ROOT, "train_configs", "training_args_style_sdxl.json")) as f:
        kw = json.load(f)
    kw.update(lora_training_urls="x", lora_rank=4, resolution=512, train_batch_size=2,
              _testing_no_output_dir=True)
    return JConfig(**kw), TConfig(**kw)


def test_int8_gradient_gap_matches_jax():
    jcfg, tcfg = _configs()
    assert jcfg.resolve_quantize_base() == tcfg.resolve_quantize_base() == "int8"
    jsc = dataclasses.replace(js.StepConfig.from_config(jcfg, 1.0), use_flash=False)
    tsc = ts.StepConfig.from_config(tcfg, 1.0)
    assert tsc.remat == jsc.remat == "light+save:flash_out*,flash_lse*"

    ks = jax.random.split(jax.random.PRNGKey(0), 8)
    unet = init_unet_params(ks[0], TINY_SDXL_UNET_CONFIG, dtype=jnp.float32)
    te1 = j_init_clip(ks[1], TINY_CLIP_L_CONFIG, dtype=jnp.float32)
    te2 = j_init_clip(ks[2], TINY_CLIP_G_CONFIG, dtype=jnp.float32)
    tables = [t["text_model"]["embeddings"]["token_embedding"]["weight"] for t in (te1, te2)]
    trainable = {"unet": j_create_lora(ks[3], unet, rank=4),
                 "ti": {"te1": jax.random.normal(ks[4], (3, 32)) * 0.01,
                        "te2": jax.random.normal(ks[5], (3, 32)) * 0.01}}
    vocab = TINY_CLIP_L_CONFIG.vocab_size
    ids = np.full((2, 77), TINY_CLIP_L_CONFIG.eos_token_id, np.int32)
    ids[:, 0] = vocab - 2
    ids[:, 1:4] = np.arange(vocab, vocab + 3)  # the TI tokens appended to the table
    ids[:, 4:7] = np.asarray([320, 1125, 539]) % vocab
    rng = np.random.default_rng(1)
    mb = {
        "latent_mean": rng.standard_normal((2, 64, 64, 4), np.float32),
        "latent_logvar": (rng.standard_normal((2, 64, 64, 4)) * 0.1 - 6).astype(np.float32),
        "latent_scale": np.asarray(0.13025, np.float32),
        "mask": np.ones((2, 64, 64, 1), np.float32),
        "input_ids": ids, "input_ids_2": ids,
        "caption_token_lengths": np.full((2,), 8, np.int32),
        "ti_token_positions": np.tile(np.asarray([[1, 2, 3]], np.int32), (2, 1)),
    }
    key = jax.random.PRNGKey(2)
    draws = _jax_draws(key, mb)

    def jax_b_grads(unet_params):
        frozen = js.FrozenModels(
            unet_params=j_fuse(unet_params), unet_config=TINY_SDXL_UNET_CONFIG,
            te1_params=te1, te1_config=TINY_CLIP_L_CONFIG, te2_params=te2,
            te2_config=TINY_CLIP_G_CONFIG, schedule=JSchedule.create(), version="sdxl",
            resolution=(512, 512),
            distribution_targets={f"te{i + 1}": jl.DistributionLossTargets.from_embeddings(t)
                                  for i, t in enumerate(tables)})
        grads = jax.grad(lambda t: js.compute_loss(t, frozen, jsc, mb, key, jnp.asarray(0))[0])(
            trainable)
        leaves = iter_lora_leaves(from_jax_params(_np_tree(grads["unet"]), device="cpu"))
        return torch.cat([e["b"].flatten() for _, e in leaves])

    tbase = from_jax_params(_np_tree(unet), device="cpu")

    def port_b_grads(unet_params):
        frozen = ts.FrozenModels(
            unet_params=t_fuse(unet_params),
            te1_params=from_jax_params(_np_tree(te1), device="cpu"),
            te2_params=from_jax_params(_np_tree(te2), device="cpu"),
            schedule=TSchedule.create(device="cpu"),
            distribution_targets={f"te{i + 1}": tl.DistributionLossTargets.from_embeddings(
                torch.tensor(np.asarray(t))) for i, t in enumerate(tables)},
            unet_config=t_unet.TINY_SDXL_UNET_CONFIG, te1_config=t_clip.TINY_CLIP_L_CONFIG,
            te2_config=t_clip.TINY_CLIP_G_CONFIG, version="sdxl", resolution=(512, 512))
        ttrain = from_jax_params(_np_tree(trainable), device="cpu", requires_grad=True)
        loss, _ = ts.compute_loss(ttrain, frozen, tsc, {k: torch.tensor(v) for k, v in mb.items()},
                                  0, **draws)
        loss.backward()
        return torch.cat([e["b"].grad.flatten() for _, e in iter_lora_leaves(ttrain["unet"])])

    def gap(int8, full):
        return float((int8 - full).norm() / full.norm())

    j_full, j_int8 = jax_b_grads(unet), jax_b_grads(jq.quantize_base_weights(unet))
    t_full, t_int8 = port_b_grads(tbase), port_b_grads(t_quantize(tbase))
    # the two packages' gradients on each base agree (the LoRA-B layouts
    # differ, transposed, so the sums of squares are compared)
    for a, b in ((t_full, j_full), (t_int8, j_int8)):
        assert abs(float(a.norm() / b.norm()) - 1) < 1e-4
    gap_j, gap_t = gap(j_int8, j_full), gap(t_int8, t_full)
    print(f"int8 vs float32 base, all LoRA-B gradients rel L2: JAX {gap_j:.6e}, port {gap_t:.6e} "
          f"over {t_full.numel()} values")
    assert gap_j > 1e-3  # the int8 codes moved the gradients
    assert abs(gap_t - gap_j) <= GAP_RTOL * gap_j, (gap_t, gap_j)
