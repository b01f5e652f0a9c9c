"""The port's diffusion math, loss terms and train step against the JAX package's.

Float32 on the CPU. The JAX package's draws (latent eps, noise, offset noise,
timesteps: `jax.random` streams torch cannot replay) are computed here and
handed to the port explicitly. Tolerances, each with its reason:

- schedule tables and loss terms: 1e-6 relative or 1e-6 absolute on O(1)
  samples (the same float32 formulas, a few ulp apart);
- one tiny-SDXL `compute_loss`: 1e-5 relative on the loss and aux terms;
  gradients 1e-3 relative + 1e-6 absolute per element and, per tensor,
  within 1e-4 of its largest element (summation order through ~20 layers;
  measured about 6e-6). That is tight enough to see the
  L1 penalty's subgradient at LoRA-B = 0, which is 4.6e-7 per element here;
- the same step on an int8 frozen base (both packages on JAX's codes) under
  `light+save:attn_out*`: the same tolerances;
- the 3-step AdamW trajectory: every metric 1e-4 relative, the TI rows 1e-6
  and the LoRA tensors 1e-5 absolute. Adam's first steps divide each
  gradient by its own magnitude, so a rounding difference in a gradient near
  zero moves that element by a fraction of the learning rate (5e-5); the
  measured worst case is 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd_lora_trainer_tpu.config import TrainingConfig as JConfig
from sd_lora_trainer_tpu.diffusion import losses as jl
from sd_lora_trainer_tpu.diffusion.schedulers import DDPMSchedule as JSchedule
from sd_lora_trainer_tpu.models.clip import init_clip_params as j_init_clip
from sd_lora_trainer_tpu.models import quant as jq
from sd_lora_trainer_tpu.models.lora import create_lora_params as j_create_lora
from sd_lora_trainer_tpu.models.synthesize import TINY_CLIP_G_CONFIG, TINY_CLIP_L_CONFIG
from sd_lora_trainer_tpu.models.unet import TINY_SDXL_UNET_CONFIG, init_unet_params
from sd_lora_trainer_tpu.training import step as js
from sd_lora_trainer_tpu.training.optimizers import build_optimizer
from sd_lora_trainer_tpu_torch.config import TrainingConfig as TConfig
from sd_lora_trainer_tpu_torch.diffusion import losses as tl
from sd_lora_trainer_tpu_torch.diffusion.schedulers import DDPMSchedule as TSchedule
from sd_lora_trainer_tpu_torch.interop import from_jax_params
from sd_lora_trainer_tpu_torch.models import clip as t_clip
from sd_lora_trainer_tpu_torch.models import unet as t_unet
from sd_lora_trainer_tpu_torch.models.lora import iter_lora_leaves
from sd_lora_trainer_tpu_torch.models.quant import QTensor, quantize_frozen
from sd_lora_trainer_tpu_torch.training import step as ts
from sd_lora_trainer_tpu_torch.training.optimizers import GroupOptimizer


@pytest.fixture(autouse=True)
def _grad_mode_on():
    """Gradients need torch's grad mode, which tests/test_golden_torch.py
    switches off when imported (and pytest-xdist workers import every file)."""
    with torch.enable_grad():
        yield


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(t, j, rtol=1e-6, atol=1e-7):
    np.testing.assert_allclose(np.asarray(t.detach() if torch.is_tensor(t) else t),
                               np.asarray(j), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# Schedule and loss terms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_schedule_and_diffusion_loss(prediction_type):
    js_ = JSchedule.create(prediction_type=prediction_type)
    ts_ = TSchedule.create(prediction_type=prediction_type, device="cpu")
    _close(ts_.alphas_cumprod, js_.alphas_cumprod)
    rng = np.random.default_rng(0)
    x0, eps, pred = (rng.standard_normal((3, 4, 5, 4), np.float32) for _ in range(3))
    mask = (rng.random((3, 4, 5, 1)) > 0.3).astype(np.float32)
    t = np.asarray([3, 400, 999], np.int32)
    tt = torch.tensor(t)
    # O(1) samples: one float32 ulp of the sqrt(abar) coefficients is ~1e-7
    _close(ts_.add_noise(torch.tensor(x0), torch.tensor(eps), tt), js_.add_noise(x0, eps, t),
           atol=1e-6)
    _close(ts_.get_velocity(torch.tensor(x0), torch.tensor(eps), tt), js_.get_velocity(x0, eps, t),
           atol=1e-6)
    _close(ts_.compute_snr(tt), js_.compute_snr(t), rtol=1e-5)
    noisy = np.asarray(js_.add_noise(x0, eps, t))

    pt = torch.tensor(pred, requires_grad=True)
    lt = tl.diffusion_loss(pt, torch.tensor(eps), torch.tensor(noisy), torch.tensor(x0),
                           torch.tensor(mask), ts_, tt, 5.0)
    lj, gj = jax.value_and_grad(
        lambda p: jl.diffusion_loss(p, eps, noisy, x0, mask, js_, t, 5.0))(pred)
    lt.backward()
    _close(lt, lj, rtol=1e-5)
    _close(pt.grad, gj, rtol=1e-5, atol=1e-8)


def test_regularizers_values_and_grads():
    rng = np.random.default_rng(1)
    table = rng.standard_normal((50, 16), np.float32) * 0.02
    rows = rng.standard_normal((3, 16), np.float32) * 0.03
    embeds = rng.standard_normal((2, 77, 16), np.float32) * 4
    # the zero matrix is LoRA-B at init: the L1 subgradient there is +1 in JAX
    mats = [rng.standard_normal((5, 4), np.float32), rng.standard_normal((4, 3), np.float32),
            np.zeros((3, 2), np.float32)]

    tj = jl.DistributionLossTargets.from_embeddings(table)
    tt = tl.DistributionLossTargets.from_embeddings(torch.tensor(table))
    _close(tt.target_cov, tj.target_cov, rtol=1e-5, atol=1e-9)
    _close(tt.target_stds_mean, tj.target_stds_mean, rtol=1e-5)
    _close(tt.target_stds_var, tj.target_stds_var, rtol=1e-4)

    r = torch.tensor(rows, requires_grad=True)
    e = torch.tensor(embeds, requires_grad=True)
    m = [torch.tensor(x, requires_grad=True) for x in mats]
    reg_t, obs_t = tl.prompt_norm_regularization(e, 34.5)
    terms_t = [tt.covariance_loss(r), tt.std_loss(r), reg_t, tl.lora_l1_penalty(m)]
    sum(terms_t).backward()

    def terms_j(rows, embeds, mats):
        reg, _ = jl.prompt_norm_regularization(embeds, 34.5)
        return [tj.covariance_loss(rows), tj.std_loss(rows), reg, jl.lora_l1_penalty(mats)]

    vals = terms_j(rows, embeds, mats)
    for a, b in zip(terms_t, vals):
        _close(a, b, rtol=2e-5)
    _close(obs_t, jl.prompt_norm_regularization(embeds, 34.5)[1], rtol=1e-5)
    g = jax.grad(lambda *a: sum(terms_j(*a)), argnums=(0, 1, 2))(rows, embeds, mats)
    _close(r.grad, g[0], rtol=1e-4, atol=1e-9)
    _close(e.grad, g[1], rtol=1e-4, atol=1e-9)
    for a, b in zip(m, g[2]):
        _close(a.grad, b, rtol=1e-5)


@pytest.mark.parametrize("img_ratio,shapes", [(1.0, [(8, 8), (4, 4), (8, 8)]),
                                              (1.25, [(8, 10), (4, 5)])])
def test_token_attention_loss_values_and_grads(img_ratio, shapes):
    rng = np.random.default_rng(2)
    scores = {f"layer{i}": rng.standard_normal((3, h * w, 77)).astype(np.float32) * 4
              for i, (h, w) in enumerate(shapes)}
    mask = (rng.random((3, 16, 8 * shapes[0][1] // shapes[0][0] * 2, 1)) > 0.5).astype(np.float32)
    lengths = np.asarray([6, 9, 12], np.int32)
    pos = np.asarray([[2, 3, 4], [1, 5, 7], [-1, 2, 3]], np.int32)  # sample 2 lost a TI token

    st = {k: torch.tensor(v, requires_grad=True) for k, v in scores.items()}
    lt = tl.token_attention_loss(st, torch.tensor(mask), img_ratio, torch.tensor(lengths),
                                 torch.tensor(pos))
    lt.backward()
    lj, gj = jax.value_and_grad(
        lambda s: jl.token_attention_loss(s, mask, img_ratio, lengths, pos))(scores)
    _close(lt, lj, rtol=1e-5)
    for k in scores:
        _close(st[k].grad, gj[k], rtol=1e-4, atol=1e-9)


# ---------------------------------------------------------------------------
# The tiny SDXL step
# ---------------------------------------------------------------------------


def _configs():
    kw = dict(lora_training_urls="x", concept_mode="style", sd_model_version="sdxl",
              max_train_steps=50, lora_rank=4, _testing_no_output_dir=True, resolution=16,
              unet_lr=1e-3, cond_reg_w=1e-5, tok_cov_reg_w=1e-5, quantize_base="none")
    return JConfig(**kw), TConfig(**kw)


@pytest.fixture(scope="module")
def tiny():
    """JAX and port frozen models, the trainable trees and one batch."""
    ks = jax.random.split(jax.random.PRNGKey(0), 8)
    unet = init_unet_params(ks[0], TINY_SDXL_UNET_CONFIG, dtype=jnp.float32)
    te1 = j_init_clip(ks[1], TINY_CLIP_L_CONFIG, dtype=jnp.float32)
    te2 = j_init_clip(ks[2], TINY_CLIP_G_CONFIG, dtype=jnp.float32)
    tables = [t["text_model"]["embeddings"]["token_embedding"]["weight"] for t in (te1, te2)]
    jfrozen = js.FrozenModels(
        unet_params=unet, unet_config=TINY_SDXL_UNET_CONFIG, te1_params=te1,
        te1_config=TINY_CLIP_L_CONFIG, te2_params=te2, te2_config=TINY_CLIP_G_CONFIG,
        schedule=JSchedule.create(), version="sdxl", resolution=(16, 16),
        distribution_targets={f"te{i + 1}": jl.DistributionLossTargets.from_embeddings(t)
                              for i, t in enumerate(tables)},
    )
    tfrozen = ts.FrozenModels(
        unet_params=from_jax_params(_np_tree(unet), device="cpu"),
        te1_params=from_jax_params(_np_tree(te1), device="cpu"),
        te2_params=from_jax_params(_np_tree(te2), device="cpu"),
        schedule=TSchedule.create(device="cpu"),
        distribution_targets={f"te{i + 1}": tl.DistributionLossTargets.from_embeddings(
            torch.tensor(np.asarray(t))) for i, t in enumerate(tables)},
        unet_config=t_unet.TINY_SDXL_UNET_CONFIG, te1_config=t_clip.TINY_CLIP_L_CONFIG,
        te2_config=t_clip.TINY_CLIP_G_CONFIG, version="sdxl", resolution=(16, 16),
    )
    lora = j_create_lora(ks[3], unet, rank=4)
    trainable = {"unet": lora, "ti": {"te1": jax.random.normal(ks[4], (3, 32)) * 0.01,
                                      "te2": jax.random.normal(ks[5], (3, 32)) * 0.01}}
    rng = np.random.default_rng(42)
    ids = np.full((1, 2, 77), 255, np.int32)
    ids[..., 0], ids[..., 1] = 254, 5
    ids[..., 2:5] = [256, 257, 258]
    batch = {
        "latent_mean": rng.standard_normal((1, 2, 16, 16, 4), np.float32),
        "latent_logvar": np.full((1, 2, 16, 16, 4), -6.0, np.float32),
        "latent_scale": np.asarray(0.13025, np.float32),
        "mask": (rng.random((1, 2, 16, 16, 1)) > 0.2).astype(np.float32),
        "input_ids": ids, "input_ids_2": ids,
        "caption_token_lengths": np.full((1, 2), 6, np.int32),
        "ti_token_positions": np.tile(np.asarray([[[2, 3, 4]]], np.int32), (1, 2, 1)),
    }
    return jfrozen, tfrozen, trainable, batch


def _jax_draws(key, batch):
    """The draws JAX compute_loss makes from `key` (training/step.py:191-253)."""
    k_latent, k_noise, k_offset, k_t = jax.random.split(key, 4)
    shape = batch["latent_mean"].shape
    return {
        "latent_eps": torch.tensor(np.asarray(jax.random.normal(k_latent, shape))),
        "noise": torch.tensor(np.asarray(jax.random.normal(k_noise, shape, jnp.float32))),
        "offset_noise": torch.tensor(np.asarray(
            jax.random.normal(k_offset, (shape[0], 1, 1, shape[-1]), jnp.float32))),
        "timesteps": torch.tensor(np.asarray(jax.random.randint(k_t, (shape[0],), 0, 1000))),
    }


def _step_configs():
    jcfg, tcfg = _configs()
    jsc = js.StepConfig.from_config(jcfg, 1.0)
    tsc = ts.StepConfig.from_config(tcfg, 1.0)
    # "auto" with a bf16 base: full remat keeping the flash residuals, which
    # the tiny widths do not reach (their attention is plain)
    assert tsc.remat == jsc.remat == "save:flash_out*,flash_lse*"
    return jcfg, tcfg, dataclasses.replace(jsc, remat=False), tsc


def test_compute_loss_terms_and_grads_match_jax(tiny):
    jfrozen, tfrozen, trainable, batch = tiny
    _, _, jsc, tsc = _step_configs()
    _check_loss_and_grads(jfrozen, tfrozen, jsc, tsc, trainable, batch)


def _check_loss_and_grads(jfrozen, tfrozen, jsc, tsc, trainable, batch):
    mb = {k: (v[0] if v.ndim > 0 else v) for k, v in batch.items()}
    key = jax.random.PRNGKey(2)
    (loss_j, aux_j), grads_j = jax.jit(jax.value_and_grad(
        lambda t: js.compute_loss(t, jfrozen, jsc, mb, key, jnp.asarray(0)), has_aux=True,
    ))(trainable)
    ttrain = from_jax_params(_np_tree(trainable), device="cpu", requires_grad=True)
    tmb = {k: torch.tensor(v) for k, v in mb.items()}
    loss_t, aux_t = ts.compute_loss(ttrain, tfrozen, tsc, tmb, 0, **_jax_draws(key, mb))
    loss_t.backward()

    assert sorted(aux_t) == sorted(aux_j)
    for k in aux_j:
        _close(aux_t[k], aux_j[k], rtol=1e-5, atol=1e-9)
    _close(loss_t, loss_j, rtol=1e-5)
    gj = from_jax_params(_np_tree(grads_j), device="cpu")

    def close_to_largest(t, j, what):
        _close(t, j, rtol=1e-3, atol=1e-6)
        err, scale = float((t - j).abs().max()), float(j.abs().max())
        assert err <= 1e-4 * scale, (what, err, scale)

    for which in ("te1", "te2"):
        close_to_largest(ttrain["ti"][which].grad, gj["ti"][which], which)
    leaves_j = dict(iter_lora_leaves(gj["unet"]))
    n = 0
    for path, entry in iter_lora_leaves(ttrain["unet"]):
        for m in ("a", "b"):
            close_to_largest(entry[m].grad, leaves_j[path][m], (path, m))
            n += 1
    assert n == 2 * len(leaves_j) > 0


def test_int8_base_step_matches_jax(tiny):
    """One step's loss and LoRA/TI gradients on an int8 frozen base under
    `light+save:attn_out*`, both packages on JAX's codes and scales."""
    jfrozen, tfrozen, trainable, batch = tiny
    _, _, jsc, tsc = _step_configs()
    jq_unet = jq.quantize_base_weights(jfrozen.unet_params)
    jfrozen_q = dataclasses.replace(jfrozen, unet_params=jq_unet)
    tfrozen_q = dataclasses.replace(tfrozen, unet_params=from_jax_params(_np_tree(jq_unet),
                                                                         device="cpu"))
    assert isinstance(tfrozen_q.unet_params["mid_block"]["resnets"][0]["conv1"]["weight"],
                      QTensor)
    plan = "light+save:attn_out*"
    _check_loss_and_grads(jfrozen_q, tfrozen_q, dataclasses.replace(jsc, remat=plan),
                          dataclasses.replace(tsc, remat=plan), trainable, batch)


def test_remat_te_moves_the_ti_rows(tiny):
    """quantize_base "int8+te": int8 text encoders, the conditioning
    recomputed in the backward (`remat_te`): the same gradients as without
    the recompute, and the TI rows train through it."""
    _, tfrozen, trainable, batch = tiny
    tcfg = _configs()[1]
    tcfg.quantize_base = "int8+te"
    sc = ts.StepConfig.from_config(tcfg, 1.0)
    assert sc.remat_te and sc.remat == "light+save:flash_out*,flash_lse*"
    frozen = dataclasses.replace(tfrozen)
    assert quantize_frozen(frozen, "int8+te") > 0
    assert isinstance(frozen.te2_params["text_model"]["encoder"]["layers"][0]["mlp"]["fc1"]["weight"],
                      QTensor)
    mb = {k: torch.tensor(v[0] if v.ndim > 0 else v) for k, v in batch.items()}
    draws = _jax_draws(jax.random.PRNGKey(4), {k: np.asarray(v) for k, v in mb.items()})
    grads = {}
    for remat_te in (True, False):
        ttrain = from_jax_params(_np_tree(trainable), device="cpu", requires_grad=True)
        loss, _ = ts.compute_loss(ttrain, frozen, dataclasses.replace(sc, remat_te=remat_te), mb,
                                  0, **draws)
        loss.backward()
        grads[remat_te] = [ttrain["ti"][w].grad for w in ("te1", "te2")]
    for a, b in zip(grads[True], grads[False]):
        assert torch.equal(a, b) and a.abs().sum() > 0
    ttrain = from_jax_params(_np_tree(trainable), device="cpu", requires_grad=True)
    before = [ttrain["ti"][w].detach().clone() for w in ("te1", "te2")]
    state = ts.TrainState(step=0, trainable=ttrain, optimizer=GroupOptimizer(tcfg, ttrain),
                          generator=torch.Generator().manual_seed(0))
    ts.make_train_step(sc)(state, {k: torch.tensor(v) for k, v in batch.items()}, frozen)
    for w, b in zip(("te1", "te2"), before):
        assert (ttrain["ti"][w].detach() - b).abs().max() > 0, w


_GRID = {
    "sd15_512": dict(sd_model_version="sd15", resolution=512),
    "sd15_1024": dict(sd_model_version="sd15", resolution=1024),
    "sd15_512_bs32": dict(sd_model_version="sd15", resolution=512, train_batch_size=32),
    "sdxl": dict(sd_model_version="sdxl", resolution=1024),
    "sdxl_full_finetune": dict(sd_model_version="sdxl", resolution=1024, is_lora=False),
    "sdxl_tp": dict(sd_model_version="sdxl", resolution=1024, sharding_mode="tp"),
}


@pytest.mark.parametrize("quantize_base", ["auto", "none", "int8", "int8+te"])
@pytest.mark.parametrize("case", sorted(_GRID))
def test_step_config_resolves_like_jax(case, quantize_base):
    kw = dict(lora_training_urls="x", concept_mode="style", _testing_no_output_dir=True,
              quantize_base=quantize_base, remat_stash8="", **_GRID[case])
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    assert tcfg.resolve_quantize_base() == jcfg.resolve_quantize_base()
    j, t = js.StepConfig.from_config(jcfg, 1.0), ts.StepConfig.from_config(tcfg, 1.0)
    assert (t.remat, t.stash8, t.remat_te) == (j.remat, j.stash8, j.remat_te)
    explicit = dict(kw, remat="save:attn_out*,ff_hidden*", remat_stash8="ff_hidden*")
    j = js.StepConfig.from_config(JConfig(**explicit), 1.0)
    t = ts.StepConfig.from_config(TConfig(**explicit), 1.0)
    assert (t.remat, t.stash8, t.remat_te) == (j.remat, j.stash8, j.remat_te)


def test_three_step_adamw_trajectory_matches_jax(tiny):
    jfrozen, tfrozen, trainable, batch = tiny
    jcfg, tcfg, jsc, tsc = _step_configs()
    opt = build_optimizer(jcfg, trainable)
    state = js.TrainState(step=jnp.zeros((), jnp.int32), trainable=trainable,
                          opt_state=opt.init(trainable), key=jax.random.PRNGKey(3))
    step_j = jax.jit(js.make_train_step(jsc, opt))

    ttrain = from_jax_params(_np_tree(trainable), device="cpu", requires_grad=True)
    ti_init = ttrain["ti"]["te1"].detach().clone()
    tstate = ts.TrainState(step=0, trainable=ttrain, optimizer=GroupOptimizer(tcfg, ttrain),
                           generator=torch.Generator().manual_seed(0))
    step_t = ts.make_train_step(tsc)
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    mb0 = {k: (v[0] if v.ndim > 0 else v) for k, v in batch.items()}
    for i in range(3):
        micro_key = jax.random.fold_in(jax.random.fold_in(state.key, state.step), 0)
        state, m_j = step_j(state, batch, jfrozen)
        m_t = step_t(tstate, tbatch, tfrozen, draws=[_jax_draws(micro_key, mb0)])
        assert sorted(m_t) == sorted(m_j)
        for k in m_j:
            _close(m_t[k], m_j[k], rtol=1e-4, atol=1e-9)
    assert tstate.step == 3 and int(state.step) == 3

    final_j = from_jax_params(_np_tree(state.trainable), device="cpu")
    for w in ("te1", "te2"):
        _close(ttrain["ti"][w], final_j["ti"][w], rtol=0, atol=1e-6)
    leaves_j = dict(iter_lora_leaves(final_j["unet"]))
    for path, entry in iter_lora_leaves(ttrain["unet"]):
        for m in "ab":
            assert (entry[m].detach() - leaves_j[path][m]).abs().max() <= 1e-5, (path, m)
    assert (ttrain["ti"]["te1"].detach() - ti_init).abs().max() > 1e-4  # the rows trained


def test_run_steps_takes_steps_per_call_batches():
    """The host loop of one steps_per_call group: K steps over the first K
    batches, in order, and fewer when the batches run out."""
    def fake_step(state, batch, frozen):
        state.step += 1
        return {"batch": batch}

    state = ts.TrainState(step=0, trainable={}, optimizer=None, generator=None)
    metrics = ts.run_steps(fake_step, state, iter(range(10)), None, steps_per_call=4)
    assert [m["batch"] for m in metrics] == [0, 1, 2, 3] and state.step == 4
    assert len(ts.run_steps(fake_step, state, iter(range(2)), None, steps_per_call=4)) == 2
