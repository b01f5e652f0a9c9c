"""The port's CLI trainer against the JAX package's `train`, value for value.

Both packages' `train` run in-process on the CPU on the tiny synthesized
checkpoints and images of tests/test_torch_main.py, under one config: 3
steps at 64px, batch 2, `n_sample_imgs` 1, `weight_type` fp32. What a user
gets from the run is compared: each step's loss, every tensor of the
exported LoRA (or finetuned UNet) and TI embeddings, and
special_params.json.

What the two runs share without help: the config; the preprocessing (crops,
masks, captions); the host's draws (`np.random.RandomState(seed)` batches,
caption dropout, the epoch sampler); the LR and TI-freeze cadence; the
export. The device draws cannot be shared, so the test carries JAX's random
state into the port by monkeypatching functions of both packages (neither
package is edited):

- the initial adapters and TI rows: JAX's `create_lora_params` results and
  TI rows are recorded (its trainable tree as `build_optimizer` receives
  it) and handed to the port's `create_lora_params` call sites and its TI
  init (`starting_rows`) through `interop.from_jax_params`;
- each step's draws: JAX's keys are rebuilt as its `train` builds them
  (`fold_in(PRNGKey(seed), 2)`, then `fold_in(key, step)` and
  `fold_in(key, micro_batch)`, then the four-way split of `compute_loss`,
  tests/test_torch_step.py `_jax_draws`) and given to the port's step
  through `TrainStep.__call__(..., draws=...)`.

The validation renders are replaced by a stub in both packages: they read
the trained adapters after the last step and write only images, which are
not compared, and each would cost a UNet compile and 25 denoising steps.

Cases, each one parametrized case: SDXL LoRA+TI under AdamW (the product
default; quantize_base "auto" is int8 on both sides), SD1.5 LoRA+TI in face
mode (the face-detection mask chain, offline), SDXL LoRA+TI under Prodigy
(UNet and TI; JAX's run without buffer donation, `_JaxWithoutDonation`),
SDXL DoRA with TE-LoRA, each under a minute on one worker, and, in
tests/test_torch_cli_parity_finetune.py, the SDXL full finetune under
AdamW8bit (~3 minutes, most of it JAX's compile).

Tolerances: each step's loss 1e-4 relative (JAX's compiled step and the
port's eager one sum in other orders through ~20 layers; measured <= 1.2e-6);
each exported group's move from its initial value within 5e-3 of JAX's,
relative L2 over the group's tensors (measured: <= 6.1e-5 for the adapters
and TI rows, 5.3e-4 for the AdamW8bit full finetune, where a rounding-level
gradient difference can move a moment to the next 8-bit code; a third of
tests/test_torch_step.py's 3-step trajectory bound, 2e-2, so that one
step's caption dropout skipped in the port, which moves the Prodigy case's
groups by ~1e-2, fails); every alpha and special_params.json exactly.

Left out, with the JAX faults that keep them out (ROADMAP.md Queue C):

- the TI warmup: JAX's `preprocess` overwrites a supplied concept
  description with None (sd_lora_trainer_tpu/data/preprocess.py:417), so
  JAX's CLI never runs the warmup offline;
- aspect buckets: JAX's loop bakes one global `daam_img_ratio` into every
  bucket's step (sd_lora_trainer_tpu/main.py:365). Preprocessing crops
  every image to the train aspect, so the CLI runs one bucket either way.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from sd_lora_trainer_tpu import main as jmain
from sd_lora_trainer_tpu.checkpoint import save_checkpoint as j_save_checkpoint
from sd_lora_trainer_tpu.config import TrainingConfig as JConfig
from sd_lora_trainer_tpu_torch import main as tmain
from sd_lora_trainer_tpu_torch.config import TrainingConfig as TConfig
from sd_lora_trainer_tpu_torch.interop import from_jax_params
from sd_lora_trainer_tpu_torch.utils.safetensors_io import load_safetensors
from tests.test_torch_main import _cfg, _run, env  # noqa: F401  (env is a fixture)
from tests.test_torch_step import _jax_draws

LOSS_RTOL = 1e-4
MOVE_RTOL = 5e-3

CASES = {
    "sdxl_lora_ti_adamw": {},
    "sd15_face_lora_ti": {"sd_model_version": "sd15", "concept_mode": "face",
                          "use_face_detection_instead": True},
    # caption dropout at 0.5, so that some of the 6 captions drop
    "sdxl_prodigy": {"unet_optimizer_type": "prodigy", "ti_optimizer": "prodigy",
                     "caption_dropout": 0.5},
    "sdxl_full_finetune_adamw8bit": {"is_lora": False, "unet_optimizer_type": "AdamW8bit",
                                     "sharding_mode": "fsdp"},
    "sdxl_dora_te_lora": {"use_dora": True, "text_encoder_lora_optimizer": "adamw",
                          "text_encoder_lora_lr": 1e-3, "txt_encoders_lr_warmup_steps": 1},
}


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


def _no_render(module, monkeypatch):
    """Stub the validation render of one package's `train`: no images, an
    empty grid file for the loop to copy."""
    def render_images(*args, n_imgs=1, **kw):
        return [""] * n_imgs

    def make_validation_img_grid(save_dir):
        path = os.path.join(save_dir, "validation_grid.jpg")
        open(path, "wb").close()
        return path

    monkeypatch.setattr(module, "render_images", render_images)
    monkeypatch.setattr(module, "make_validation_img_grid", make_validation_img_grid)


class _JaxWithoutDonation:
    """The `jax` module as sd_lora_trainer_tpu/main.py sees it, but for a
    `jit` that donates no argument. Under Prodigy JAX's optimizer state
    aliases the float32 trainables (`p0`, sd_lora_trainer_tpu/training/
    prodigy.py:58, an `astype` to their own dtype), so the loop's step,
    which donates its state, raises on its first call ("donate the same
    buffer twice"). Donation changes no value."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fn, donate_argnums=(), **kw):
        return jax.jit(fn, **kw)


def _run_jax(cfg, monkeypatch):
    """JAX's `train`; returns (config, save dir, its initial trainable tree
    as numpy)."""
    _no_render(jmain, monkeypatch)
    if "prodigy" in (cfg.get("unet_optimizer_type"), cfg.get("ti_optimizer")):
        monkeypatch.setattr(jmain, "jax", _JaxWithoutDonation())
    seen = {}
    real = jmain.build_optimizer

    def build_optimizer(config, trainable):
        seen["trainable"] = jax.tree.map(np.asarray, trainable)
        return real(config, trainable)

    monkeypatch.setattr(jmain, "build_optimizer", build_optimizer)
    gen = jmain.train(JConfig(**cfg))
    while True:
        try:
            next(gen)
        except StopIteration as stop:
            config, save_dir = stop.value
            return config, save_dir, seen["trainable"]


def _run_port(cfg, init, monkeypatch):
    """The port's `train` on JAX's initial adapters, TI rows and per-step
    draws; returns (config, save dir, the draws' step counts)."""
    _no_render(tmain, monkeypatch)
    unet_and_tes = [init.get("unet")] + [init.get("te_lora", {}).get(w) for w in ("te1", "te2")]
    adapters = iter(t for t in unet_and_tes if t is not None)

    def create_lora_params(*args, **kw):
        return from_jax_params(next(adapters), device="cpu", requires_grad=True)

    real_init = tmain.TokenEmbeddingsHandler.initialize_new_tokens
    rows = [init.get("ti", {}).get(w) for w in ("te1", "te2")]

    def initialize_new_tokens(self, tables, tokens, generator, starting_rows=None):
        return real_init(self, tables, tokens, generator, starting_rows=rows)

    state_key = jax.random.fold_in(jax.random.PRNGKey(cfg["seed"]), 2)
    real_make = tmain.make_train_step
    steps_drawn = []

    def make_train_step(sc, *args, **kw):
        step_fn = real_make(sc, *args, **kw)

        def with_jax_draws(state, batch, frozen, draws=None):
            key = jax.random.fold_in(state_key, state.step)
            steps_drawn.append(state.step)
            draws = [_jax_draws(jax.random.fold_in(key, i),
                                {"latent_mean": batch["latent_mean"][i]})
                     for i in range(batch["latent_mean"].shape[0])]
            return step_fn(state, batch, frozen, draws=draws)

        return with_jax_draws

    monkeypatch.setattr(tmain, "create_lora_params", create_lora_params)
    monkeypatch.setattr(tmain.TokenEmbeddingsHandler, "initialize_new_tokens",
                        initialize_new_tokens)
    monkeypatch.setattr(tmain, "make_train_step", make_train_step)
    config, save_dir = _run(TConfig(**cfg))
    return config, save_dir, steps_drawn


def _init_export(tmp_path, jconfig, init, version):
    """The initial adapters, TI rows or UNet, through the JAX package's own
    export: each exported tensor's starting value."""
    out = str(tmp_path / "init_export")
    ti = init.get("ti", {})
    te = init.get("te_lora", {})
    j_save_checkpoint(out, 0, jconfig.name, version, jconfig.token_dict, jconfig.is_lora,
                      ti_rows=[ti.get("te1"), ti.get("te2")], unet_lora=init.get("unet"),
                      te_loras=[te.get("te1"), te.get("te2")],
                      unet_params=None if jconfig.is_lora else init["unet"],
                      unet_config=None if jconfig.is_lora else
                      jmain.load_models_from_checkpoint(jconfig.ckpt_path).unet_config)
    return out


def _group(key: str) -> str:
    """The trainable group an exported tensor belongs to."""
    for prefix in ("lora_unet_", "lora_te1_", "lora_te2_"):
        if key.startswith(prefix):
            return prefix[:-1]
    return key  # a TI row table (clip_l, clip_g)


# the cases of this file; tests/test_torch_cli_parity_finetune.py runs the
# full finetune, whose JAX run alone takes ~2.5 minutes (one file takes one
# xdist worker, and all five cases take over 4 minutes)
HERE = ("sdxl_lora_ti_adamw", "sd15_face_lora_ti", "sdxl_prodigy", "sdxl_dora_te_lora")


@pytest.mark.parametrize("case", HERE)
def test_cli_matches_jax_train(env, tmp_path, monkeypatch, case):  # noqa: F811
    check_case(env, tmp_path, monkeypatch, case)


def check_case(env, tmp_path, monkeypatch, case):  # noqa: F811
    """Run both packages' CLI on one case and compare what they export."""
    version = CASES[case].get("sd_model_version", "sdxl")
    ckpt = env["ckpt"] if version == "sdxl" else env["ckpt_sd15"]
    cfg = _cfg(env, name="parity", weight_type="fp32", ckpt_path=ckpt, **CASES[case])
    jconfig, jdir, init = _run_jax(dict(cfg, output_dir=str(tmp_path / "jax")), monkeypatch)
    tconfig, tdir, steps_drawn = _run_port(
        dict(cfg, output_dir=str(tmp_path / "port"), device="cpu"), init, monkeypatch)
    assert steps_drawn == [0, 1, 2]

    j_losses = jconfig.training_attributes["final_losses"]["tot_loss"]
    t_losses = tconfig.training_attributes["final_losses"]["tot_loss"]
    assert len(t_losses) == len(j_losses) == 3
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_RTOL)

    files = sorted(f for f in os.listdir(jdir) if f.endswith(".safetensors"))
    assert files == sorted(f for f in os.listdir(tdir) if f.endswith(".safetensors"))
    assert len(files) == 2  # the adapters (or the finetuned UNet) and the TI rows
    with open(os.path.join(jdir, "special_params.json")) as f, \
            open(os.path.join(tdir, "special_params.json")) as g:
        assert json.load(f) == json.load(g)

    start_dir = _init_export(tmp_path, jconfig, init, version)
    moves = {}  # group: [|port - jax|^2, |jax - start|^2]
    for fname in files:
        want, got, start = (load_safetensors(os.path.join(d, fname))
                            for d in (jdir, tdir, start_dir))
        assert sorted(got) == sorted(want) == sorted(start), fname
        for k in want:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
            if k.endswith(".alpha"):
                assert torch.equal(got[k], want[k]), k
                continue
            group = "unet" if fname == "unet_finetuned.safetensors" else _group(k)
            sums = moves.setdefault(group, [0.0, 0.0])
            sums[0] += float(((got[k] - want[k]).double() ** 2).sum())
            sums[1] += float(((want[k] - start[k]).double() ** 2).sum())
    assert all(n > 0 for _, n in moves.values()), moves  # every group trained
    rel = {g: (d / n) ** 0.5 for g, (d, n) in moves.items()}
    print(case, "losses", t_losses, j_losses, "moves rel L2", rel)
    assert all(r <= MOVE_RTOL for r in rel.values()), rel
