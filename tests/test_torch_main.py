"""The port's CLI trainer against the JAX package's artifact contract.

- `python -m sd_lora_trainer_tpu_torch.main cfg.json` ("device": "cpu"): a
  3-step tiny SDXL run, and one of the tiny SD1.5 (one text encoder, conv
  projections, four levels), writes the JAX package's artifact set; the LoRA's and
  the embeddings' keys and shapes equal those of the JAX package's
  `save_checkpoint` for the same config (adapters made by its
  `create_lora_params` on the same checkpoint); training_args.json has the
  JAX config's fields; every loss is finite. Exact (names and shapes).
- a bucketed run with TI and K-grouped steps trains (preprocessing crops
  every image to the train aspect, so the CLI's buckets share one ratio);
  on a bucket of another aspect the DAAM loss takes that bucket's own
  width/height, where the JAX loop's one baked ratio does not factor the
  attention maps (the loss raises); the bucketed draws drop nothing.
- a run resumed from its step-2 train state ends bit-equal to the whole
  run; the from-disk render reads a checkpoint back;
- with the final-save margin at 0, the in-loop checkpoint and render write
  their artifacts, and the summary's launches and loop seconds leave the
  render's out;
- the TI warmup runs on a description the config supplies; Prodigy and a
  full finetune under AdamW8bit with sharding_mode "fsdp" train and resume
  bit-equal;
- the sharding checks place a run on its mesh or refuse it, as JAX's do.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sd_lora_trainer_tpu.checkpoint import save_checkpoint as j_save_checkpoint
from sd_lora_trainer_tpu.config import TrainingConfig as JConfig
from sd_lora_trainer_tpu.models import weights as jw
from sd_lora_trainer_tpu.models.lora import create_lora_params as j_create_lora
from sd_lora_trainer_tpu_torch import main as tmain
from sd_lora_trainer_tpu_torch.config import TrainingConfig as TConfig
from sd_lora_trainer_tpu_torch.models import synthesize as ts
from sd_lora_trainer_tpu_torch.models.unet import TINY_SD15_UNET_CONFIG, TINY_SDXL_UNET_CONFIG
from sd_lora_trainer_tpu_torch.utils.safetensors_io import load_safetensors

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    ckpt = str(root / "tiny.safetensors")
    ts.synthesize_checkpoint(ckpt, "sdxl", TINY_SDXL_UNET_CONFIG, ts.TINY_VAE_CONFIG,
                             ts.TINY_CLIP_L_CONFIG, ts.TINY_CLIP_G_CONFIG, seed=0, device="cpu")
    rs = np.random.RandomState(0)
    data = root / "data"
    data.mkdir()
    for i, (w, h) in enumerate([(64, 64), (64, 64), (96, 64), (96, 64), (64, 96), (64, 96)]):
        Image.fromarray(rs.randint(0, 255, (h, w, 3), dtype=np.uint8)).save(data / f"{i}.png")
        (data / f"{i}.txt").write_text(f"a photo of a thing number {i}")
    # the tiny SD1.5 UNet's cross-attention takes the tiny CLIP-L's width
    ckpt15 = str(root / "tiny_sd15.safetensors")
    ts.synthesize_checkpoint(ckpt15, "sd15", dataclasses.replace(
        TINY_SD15_UNET_CONFIG, cross_attention_dim=ts.TINY_CLIP_L_CONFIG.hidden_size),
        ts.TINY_VAE_CONFIG, ts.TINY_CLIP_L_CONFIG, None, seed=0, device="cpu")
    return {"root": root, "ckpt": ckpt, "ckpt_sd15": ckpt15, "data": str(data)}


def _cfg(env, **kw):
    cfg = dict(name="cli", lora_training_urls=env["data"], concept_mode="style",
               caption_model="no_caption", sd_model_version="sdxl", ckpt_path=env["ckpt"],
               seed=0, resolution=64, validation_img_size=64, train_batch_size=2,
               max_train_steps=3, checkpointing_steps=100, n_sample_imgs=1, lora_rank=4,
               skip_gpt_cleanup=True, augment_imgs_up_to_n=0,
               output_dir=str(env["root"] / "runs"))
    cfg.update(kw)
    return cfg


@pytest.mark.parametrize("version", ["sdxl", "sd15"])
def test_cli_writes_the_jax_artifact_set(env, tmp_path, version):
    ckpt = env["ckpt"] if version == "sdxl" else env["ckpt_sd15"]
    out_dir = tmp_path / "runs"
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(_cfg(env, name="clirun", weight_type="fp32", device="cpu",
                                        sd_model_version=version, ckpt_path=ckpt,
                                        output_dir=str(out_dir))))
    proc = subprocess.run([sys.executable, "-m", "sd_lora_trainer_tpu_torch.main", str(cfg_path)],
                          cwd=str(tmp_path), capture_output=True, text=True,
                          timeout=600, env={**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "Training done :)" in proc.stdout
    summary = json.loads(next(ln for ln in proc.stdout.splitlines()
                              if ln.startswith(tmain.SUMMARY_TAG))[len(tmain.SUMMARY_TAG):])
    assert len(summary["tot_loss"]) == 3 and all(np.isfinite(summary["tot_loss"]))
    # no kernel on the CPU
    assert summary["launches"]["train"] == {"flash_fwd": 0, "flash_bwd": 0, "norm_fwd": 0,
                                            "norm_bwd": 0}
    run_dir = out_dir / os.listdir(out_dir)[0]
    save_dir = run_dir / "checkpoints" / "checkpoint-3"
    files = sorted(os.listdir(save_dir))
    lora_file, emb_file = f"clirun_{version}_lora.safetensors", f"clirun_{version}_embeddings.safetensors"
    assert files == sorted([lora_file, emb_file, "special_params.json", "training_args.json",
                            "validation_grid.jpg", "img_0003_0.jpg"])
    assert os.path.exists(run_dir / "checkpoints" / "validation_grid_0003.jpg")

    # the JAX package's export of the same config
    jm = jw.load_models_from_checkpoint(ckpt, dtype=jnp.float32)
    jlora = j_create_lora(jax.random.PRNGKey(0), jm.unet, rank=4)
    rows = [jnp.zeros((3, 32))] * (2 if version == "sdxl" else 1)
    jdir = str(tmp_path / "jax_export")
    j_save_checkpoint(jdir, 3, "clirun", version, {"TOK": "<s0><s1><s2>"}, True, ti_rows=rows,
                      unet_lora=jlora)
    assert sorted(os.listdir(jdir)) == [f for f in files if f.endswith((".safetensors", ".json"))
                                        and f != "training_args.json"]
    for fname in (lora_file, emb_file):
        mine = {k: tuple(v.shape) for k, v in load_safetensors(str(save_dir / fname)).items()}
        ref = {k: tuple(v.shape) for k, v in load_safetensors(os.path.join(jdir, fname)).items()}
        assert mine == ref, fname
    with open(save_dir / "special_params.json") as f, open(os.path.join(jdir, "special_params.json")) as g:
        assert json.load(f) == json.load(g)
    with open(save_dir / "training_args.json") as f:
        args = json.load(f)
    jfields = set(JConfig(**_cfg(env), _testing_no_output_dir=True).model_dump())
    assert set(args) == jfields
    assert args["training_attributes"]["validation_prompts"] == [""]
    assert args["sd_model_version"] == version and args["train_img_size"] == [64, 64]

    # the from-disk render reads the checkpoint back onto the base
    from sd_lora_trainer_tpu_torch.inference import render_images_eval

    prompts = render_images_eval(ckpt, str(save_dir), (64, 64), n_imgs=1, n_steps=2,
                                 dtype=torch.float32, precision="fp32", device="cpu")
    assert prompts == [""] and os.path.exists(save_dir / "img_0000_0.jpg")


def _run(config):
    gen = tmain.train(config)
    while True:
        try:
            next(gen)
        except StopIteration as stop:
            return stop.value


def test_resume_continues_the_run_exactly(env, monkeypatch):
    """A run resumed from its step-2 train state ends where the whole run
    ends, bit for bit: restored adapters, AdamW moments, update count and
    generator, and the host draws replayed through the completed steps."""
    saved = {}
    real_save = tmain.save_train_state

    def keep_each(path, state, plan=None, whole=None):
        real_save(path, state, plan, whole)
        saved[state.step] = path + f".{state.step}"
        real_save(saved[state.step], state, plan, whole)

    monkeypatch.setattr(tmain, "save_train_state", keep_each)
    kw = dict(max_train_steps=4, checkpointing_steps=2, steps_per_call=1, save_train_state=True,
              weight_type="fp32", device="cpu", n_sample_imgs=1)
    _, whole = _run(TConfig(**_cfg(env, name="whole", **kw)))
    assert sorted(saved) == [2, 4]
    _, resumed = _run(TConfig(**_cfg(env, name="resumed", resume_from=saved[2], **kw)))
    a = load_safetensors(os.path.join(whole, "whole_sdxl_lora.safetensors"))
    b = load_safetensors(os.path.join(resumed, "resumed_sdxl_lora.safetensors"))
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    a = load_safetensors(os.path.join(whole, "whole_sdxl_embeddings.safetensors"))
    b = load_safetensors(os.path.join(resumed, "resumed_sdxl_embeddings.safetensors"))
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_in_loop_checkpoints_keep_their_cost_apart(env, monkeypatch, capsys):
    """With the final-save margin at 0, a 4-step run checkpoints and renders
    at step 2 inside the loop and again at the end. Each step and each render
    adds known counts to the launch counters (no kernel runs on the CPU) and
    each render sleeps: the summary's train launches are the steps' alone,
    each render's are its own, and the loop's seconds leave the renders out."""
    from sd_lora_trainer_tpu_torch.ops import flash_attention as fa

    sleep_s = 1.0
    span = []
    real_make, real_render = tmain.make_train_step, tmain.render_images

    def counting_make(sc):
        step = real_make(sc)

        def counted(*a):
            t = time.perf_counter()
            out = step(*a)
            fa.LAUNCHES["flash_fwd"] += 2
            fa.LAUNCHES["flash_bwd"] += 1
            span.append((t, time.perf_counter()))
            return out
        return counted

    def counting_render(*a, **kw):
        prompts = real_render(*a, **kw)
        fa.LAUNCHES["flash_fwd"] += 3 * len(prompts)
        time.sleep(sleep_s)
        return prompts

    monkeypatch.setattr(tmain, "FINAL_SAVE_MARGIN", 0)
    monkeypatch.setattr(tmain, "make_train_step", counting_make)
    monkeypatch.setattr(tmain, "render_images", counting_render)
    config = TConfig(**_cfg(env, name="cadence", max_train_steps=4, checkpointing_steps=2,
                            steps_per_call=1, weight_type="fp32", device="cpu"))
    config, save_dir = _run(config)
    out = capsys.readouterr().out
    summary = json.loads(next(ln for ln in out.splitlines()
                              if ln.startswith(tmain.SUMMARY_TAG))[len(tmain.SUMMARY_TAG):])

    ckpt_root = os.path.dirname(save_dir)
    assert sorted(os.listdir(ckpt_root)) == ["checkpoint-2", "checkpoint-4",
                                             "validation_grid_0002.jpg", "validation_grid_0004.jpg"]
    for step in (2, 4):
        assert sorted(os.listdir(os.path.join(ckpt_root, f"checkpoint-{step}"))) == sorted([
            "cadence_sdxl_lora.safetensors", "cadence_sdxl_embeddings.safetensors",
            "special_params.json", "training_args.json", "validation_grid.jpg",
            f"img_{step:04d}_0.jpg"])
    assert summary["steps"] == 4 and len(span) == 4
    norm = {"norm_fwd": 0, "norm_bwd": 0}  # no norm kernel on the CPU
    assert summary["launches"]["train"] == {"flash_fwd": 2 * 4, "flash_bwd": 4, **norm}
    assert summary["launches"]["render"] == [{"flash_fwd": 3, "flash_bwd": 0, **norm}] * 2
    assert summary["rendered_images"] == [1, 1] and len(summary["checkpoint_s"]) == 2
    assert all(r >= sleep_s for r in summary["render_s"])
    # the in-loop render sits between the first step's start and the last
    # step's end; counted in the loop, it would push loop_s past that span
    assert 0 < summary["loop_s"] < (span[-1][1] - span[0][0]) - sleep_s / 2


def test_bucketed_ti_run_trains(env):
    config = TConfig(**_cfg(env, name="bucketed", aspect_ratio_bucketing=True, max_train_steps=4,
                            steps_per_call=2, caption_dropout=0.0, weight_type="fp32",
                            device="cpu"))
    assert config.token_attention_loss_w > 0 and not config.disable_ti
    config, save_dir = _run(config)
    losses = config.training_attributes["final_losses"]
    assert len(losses["token_attention_loss"]) == 4
    assert all(np.isfinite(v).all() for v in losses.values())
    assert os.path.exists(os.path.join(save_dir, "bucketed_sdxl_lora.safetensors"))


def test_daam_ratio_is_the_buckets_own(env):
    from sd_lora_trainer_tpu_torch.diffusion.schedulers import DDPMSchedule
    from sd_lora_trainer_tpu_torch.models import clip as tc
    from sd_lora_trainer_tpu_torch.models import unet as tu
    from sd_lora_trainer_tpu_torch.training import step as tstep
    from sd_lora_trainer_tpu_torch.training.embeddings import initialize_new_tokens

    gen = torch.Generator().manual_seed(0)
    unet = tu.init_unet_params(TINY_SDXL_UNET_CONFIG, gen, dtype=torch.float32, device="cpu")
    te1 = tc.init_clip_params(tc.TINY_CLIP_L_CONFIG, gen, device="cpu")
    te2 = tc.init_clip_params(tc.TINY_CLIP_G_CONFIG, gen, device="cpu")
    tables = [t["text_model"]["embeddings"]["token_embedding"]["weight"] for t in (te1, te2)]
    rows, targets = initialize_new_tokens(tables, 3, gen)
    frozen = tstep.FrozenModels(unet, te1, te2, DDPMSchedule.create(device="cpu"), targets,
                                TINY_SDXL_UNET_CONFIG, tc.TINY_CLIP_L_CONFIG,
                                tc.TINY_CLIP_G_CONFIG, "sdxl", (256, 256))
    config = TConfig(**_cfg(env, device="cpu"))
    ids = torch.full((2, 77), 255)
    ids[:, 0], ids[:, 1:4], ids[:, 4] = 254, torch.tensor([256, 257, 258]), 40
    lh, lw = 32, 48  # the (384, 256) bucket's latent, a VAE factor of 8
    batch = {"latent_mean": torch.randn(2, lh, lw, 4, generator=gen),
             "latent_logvar": torch.full((2, lh, lw, 4), -6.0),
             "latent_scale": torch.tensor(0.13025), "mask": torch.ones(2, lh, lw, 1),
             "input_ids": ids, "input_ids_2": ids, "caption_token_lengths": torch.tensor([6, 6]),
             "ti_token_positions": torch.tensor([[1, 2, 3], [1, 2, 3]])}
    trainable = {"ti": {"te1": rows[0], "te2": rows[1]}}
    ratio = tmain.daam_img_ratio((384, 256), [256, 256])
    assert ratio == 1.5 and tmain.daam_img_ratio(None, [384, 256]) == 1.5
    _, aux = tstep.compute_loss(trainable, frozen, tstep.StepConfig.from_config(config, ratio),
                                batch, 0, gen)
    assert torch.isfinite(aux["token_attention_loss"])
    baked = tstep.StepConfig.from_config(config, 256 / 256)  # the JAX loop's ratio
    with pytest.raises(ValueError, match="does not factor"):
        tstep.compute_loss(trainable, frozen, baked, batch, 0, gen)


class _Plan:
    """A dataset stub whose plan alternates two resolutions."""

    captions = ["a", "b"]
    bucket_latents = {}

    def __init__(self):
        self.n = 0

    def bucketed_batch(self):
        self.n += 1
        return {"id": self.n}, ((64, 64) if self.n % 2 else (96, 64))


def test_bucketed_draws_drop_nothing():
    plan = _Plan()
    draws = tmain.BucketedDraws(plan, np.random.RandomState(0), 2)
    got = [draws.draw((64, 64))[0]["id"] for _ in range(100)]  # pinned: (96, 64) waits
    assert got == list(range(1, 200, 2))
    assert len(draws.pending) == 99  # past JAX's 64, nothing evicted
    leaders = [draws.draw()[0]["id"] for _ in range(99)]
    assert leaders == list(range(2, 200, 2)) and not draws.pending


@pytest.mark.parametrize("kw,world,want", [
    ({"sharding_mode": "tp"}, 1, "falling back to dp"),
    ({"sharding_mode": "fsdp", "is_lora": False}, 2, ("fsdp", 2, 1)),
    ({"mesh_data_parallel": 2}, 1, ValueError("needs as many processes")),
    ({"train_batch_size": 3}, 2, ValueError("multi-process run needs a device mesh")),
])
def test_later_slices_raise(env, capsys, kw, world, want):
    """More than one process, tp and meshes were a later slice; now the
    JAX package's checks place a run on its mesh (`resolve_sharding`): tp on
    one device falls back to dp with JAX's printed line, fsdp on two
    processes shards over a data group of 2, a mesh wider than the processes
    and a global batch that does not divide them raise."""
    config = TConfig(**_cfg(env, device="cpu", **kw))
    if isinstance(want, Exception):
        with pytest.raises(type(want), match=str(want)):
            tmain.resolve_sharding(config, world)
    elif isinstance(want, str):
        assert tmain.resolve_sharding(config, world) is None
        assert want in capsys.readouterr().out
    else:
        assert tmain.resolve_sharding(config, world) == want


def test_warmup_runs_on_a_supplied_description(env, monkeypatch):
    """token_warmup_steps with a description in the config's
    training_attributes: preprocessing keeps it, and `train` warms both
    encoders' rows against it (token string vs description ids) before the
    steps, which start from the warmed rows."""
    calls = []
    real = tmain.warmup_token_embeddings

    def spy(rows, *a, **kw):
        out = real(rows, *a, **kw)
        calls.append((rows, a, kw, out))
        return out

    monkeypatch.setattr(tmain, "warmup_token_embeddings", spy)
    description = "a colorful test pattern"
    config = TConfig(**_cfg(env, name="warm", token_warmup_steps=3, weight_type="fp32",
                            device="cpu", max_train_steps=2,
                            training_attributes={"gpt_description": description}))
    config, save_dir = _run(config)
    assert config.training_attributes["gpt_description"] == description
    (rows, a, kw, (warmed, history)), = calls
    te_params, te_configs, version, token_ids, target_ids, dist = a
    assert sorted(rows) == sorted(te_params) == sorted(dist) == ["te1", "te2"] and version == "sdxl"
    assert kw["steps"] == 3 and kw["ti_lr"] == config.ti_lr
    for w in rows:
        assert not torch.equal(token_ids[w], target_ids[w])
        assert (warmed[w].detach() - rows[w].detach()).abs().max() > 0  # the rows moved
    assert all(np.isfinite(v).all() for v in history.values()) and "concept_description_loss" in history
    assert os.path.exists(os.path.join(save_dir, "warm_sdxl_embeddings.safetensors"))


@pytest.mark.parametrize("name,kw", [
    ("prodigy", dict(unet_optimizer_type="prodigy", ti_optimizer="prodigy")),
    ("ff8bit", dict(is_lora=False, unet_optimizer_type="AdamW8bit", sharding_mode="fsdp",
                    disable_ti=True)),
])
def test_resume_is_exact_under_each_optimizer(env, monkeypatch, name, kw):
    """The CLI trains under Prodigy (UNet and TI) and a full finetune under
    AdamW8bit with sharding_mode "fsdp" on one process; a run resumed from
    its step-2 train state ends bit-equal to the whole run."""
    saved = {}
    real_save = tmain.save_train_state

    def keep_each(path, state, plan=None, whole=None):
        real_save(path, state, plan, whole)
        saved[state.step] = path + f".{state.step}"
        real_save(saved[state.step], state, plan, whole)

    monkeypatch.setattr(tmain, "save_train_state", keep_each)
    base = dict(max_train_steps=4, checkpointing_steps=2, steps_per_call=1, save_train_state=True,
                weight_type="fp32", device="cpu", n_sample_imgs=1, **kw)
    cw, whole = _run(TConfig(**_cfg(env, name=name, **base)))
    assert all(np.isfinite(v).all() for v in cw.training_attributes["final_losses"].values())
    _, resumed = _run(TConfig(**_cfg(env, name=name, resume_from=saved[2], **base)))
    files = sorted(f for f in os.listdir(whole)
                   if f.endswith(".safetensors") and not f.startswith("train_state"))
    assert files == ([f"{name}_sdxl_embeddings.safetensors", f"{name}_sdxl_lora.safetensors"]
                     if kw.get("is_lora", True) else ["unet_finetuned.safetensors"])
    for f in files:
        a, b = load_safetensors(os.path.join(whole, f)), load_safetensors(os.path.join(resumed, f))
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a), f
