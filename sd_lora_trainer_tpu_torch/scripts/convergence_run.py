"""Seeded convergence run of the port: the loss curve and two quality trends.

    python -m sd_lora_trainer_tpu_torch.scripts.convergence_run [--tiny]
        [--steps 500] [--checkpointing-steps 100] [--resolution 128]
        [--seed 0] [--device cuda] [--out convergence_torch]

Counterpart of the JAX package's scripts/convergence_run.py, which shows
learning, not speed. `--tiny` (the only mode; a real-weights mode waits for
staged weights) synthesizes a tiny SDXL checkpoint, writes a deterministic
dataset that shares one concept (a bright disc over smooth gradients), runs
the port's trainer (`main.train`, debug on) with the JAX recipe's config,
then scores every periodic checkpoint (`checkpoint_trends`). It writes
`convergence_report.json` with the JAX report's keys (and the loss plots
where matplotlib exists) under `--out`, prints the report, and exits 1 if
the loss did not fall.

The tiny UNet is the JAX recipe's own (`TINY_SDXL_UNET_CONFIG`): at 128px
its self-attention runs at 1024 and 256 tokens with head dim 32, where the
card's flash kernels take it.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

from sd_lora_trainer_tpu_torch.scripts import ROOT, resolve_device


def make_structured_dataset(out_dir: str, n: int = 6, size: int = 96, seed: int = 0) -> None:
    """Deterministic images sharing one concept: a bright disc on a smooth
    two-color gradient, position/colors varying per image (a copy of the
    JAX script's, so both packages train on the same files)."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    os.makedirs(out_dir, exist_ok=True)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    for i in range(n):
        c0 = rng.randint(0, 100, 3).astype(np.float32)
        c1 = rng.randint(150, 255, 3).astype(np.float32)
        angle = rng.uniform(0, 2 * math.pi)
        t = (xx * math.cos(angle) + yy * math.sin(angle) + 1) / 2
        img = c0[None, None] * (1 - t[..., None]) + c1[None, None] * t[..., None]
        cx, cy = rng.uniform(0.3, 0.7, 2)
        r = rng.uniform(0.15, 0.25)
        disc = ((xx - cx) ** 2 + (yy - cy) ** 2) < r**2
        img[disc] = [250, 240, 90]  # the shared concept: a bright yellow disc
        Image.fromarray(img.astype(np.uint8)).save(os.path.join(out_dir, f"img_{i}.jpg"))
        with open(os.path.join(out_dir, f"img_{i}.txt"), "w") as f:
            f.write(f"a bright sun disc over a smooth gradient sky, variant {i}")


def checkpoint_trends(ckpt_path: str, run_root: str, data_dir: str, seed: int = 0, res: int = 128,
                      device="cuda"):
    """(quality_proxy, held_out_trend), one model load for every periodic
    checkpoint:

    - quality_proxy, `x0_latent_mse_train`: the one-step denoised estimate
      x0 = (x_t - sigma * eps_pred) / sqrt(abar) against the true train
      latents (fixed latents, noise and timesteps; only the adapters and TI
      rows vary by checkpoint);
    - held_out_trend, `held_out_eps_mse`: the eps-prediction MSE on an
      unseen image from the same concept process.

    Evaluated in float32 with plain attention, as the JAX script does."""
    from sd_lora_trainer_tpu_torch.checkpoint import load_checkpoint
    from sd_lora_trainer_tpu_torch.data.dataset import load_image_for_vae
    from sd_lora_trainer_tpu_torch.diffusion.schedulers import DDPMSchedule
    from sd_lora_trainer_tpu_torch.main import build_tokenizers
    from sd_lora_trainer_tpu_torch.models.clip import clip_text_forward
    from sd_lora_trainer_tpu_torch.models.lora import merge_lora
    from sd_lora_trainer_tpu_torch.models.unet import unet_forward
    from sd_lora_trainer_tpu_torch.models.vae import vae_encode
    from sd_lora_trainer_tpu_torch.models.weights import load_models_from_checkpoint

    holdout = os.path.join(data_dir, "..", "holdout")
    make_structured_dataset(holdout, n=1, size=160, seed=seed + 1000)
    holdout_path = sorted(glob.glob(os.path.join(holdout, "*.jpg")))[0]
    train_paths = sorted(glob.glob(os.path.join(data_dir, "*.jpg")))[:4]

    loaded = load_models_from_checkpoint(ckpt_path, dtype=torch.float32, device=device)
    tok1, tok2 = build_tokenizers(loaded)
    ckpt_dirs = sorted(glob.glob(os.path.join(run_root, "checkpoints", "checkpoint-*")),
                       key=lambda p: int(p.rsplit("-", 1)[1]))
    if not ckpt_dirs:
        return {}, {}

    paths = [holdout_path] + train_paths  # image 0: the held-out one
    imgs = torch.as_tensor(np.stack([load_image_for_vae(p, res, res) for p in paths]),
                           device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 7)
    with torch.no_grad():
        mean, logvar = vae_encode(loaded.vae, imgs, loaded.vae_config)
        latents = ((mean + torch.exp(0.5 * logvar) * torch.randn(mean.shape, generator=gen,
                                                                  device=device))
                   * loaded.vae_config.scaling_factor)
    n_img, n_t = len(paths), 5
    timesteps = torch.tensor([100, 300, 500, 700, 900], device=device).repeat(n_img)
    lat_rep = latents.repeat_interleave(n_t, dim=0)
    noise = torch.randn(lat_rep.shape, generator=gen, device=device)
    schedule = DDPMSchedule.create(device=device)
    noisy = schedule.add_noise(lat_rep, noise, timesteps)
    sqrt_a, sqrt_s = (x[:, None, None, None] for x in schedule.sqrt_alpha_sigma(timesteps))

    toks = [f"<s{i}>" for i in range(3)]
    for tok in (tok1, tok2):
        if tok is not None:
            tok.add_special_tokens(toks)
    prompt = "in the style of " + "".join(toks) + ", a bright sun disc over a smooth gradient sky"
    b = n_img * n_t
    ids1 = torch.tensor(tok1([prompt] * b), dtype=torch.long, device=device)
    ids2 = torch.tensor(tok2([prompt] * b), dtype=torch.long, device=device) if tok2 else None

    def eval_metrics(unet_params, ti1, ti2):
        o1 = clip_text_forward(loaded.text_encoder, ids1, loaded.text_encoder_config,
                               ti_embeddings=ti1, dtype=torch.float32)
        if loaded.version == "sdxl":
            o2 = clip_text_forward(loaded.text_encoder_2, ids2, loaded.text_encoder_2_config,
                                   ti_embeddings=ti2, dtype=torch.float32)
            ctx = torch.cat([o1["penultimate"], o2["penultimate"]], dim=-1)
            added = {"text_embeds": o2["pooled"],
                     "time_ids": torch.tensor([[1024, 1024, 0, 0, res, res]], dtype=torch.float32,
                                              device=device).repeat(b, 1)}
        else:
            ctx, added = o1["last"], None
        pred, _ = unet_forward(unet_params, noisy, timesteps, ctx, loaded.unet_config,
                               added_cond=added, use_flash=False, remat=False)
        per_sample_eps = ((pred - noise) ** 2).mean(dim=(1, 2, 3))
        x0_est = (noisy - sqrt_s * pred) / sqrt_a
        per_sample_x0 = ((x0_est - lat_rep) ** 2).mean(dim=(1, 2, 3))
        return float(per_sample_eps[:n_t].mean()), float(per_sample_x0[n_t:].mean())

    eps_per_ckpt, x0_per_ckpt = {}, {}
    for cd in ckpt_dirs:
        ck = load_checkpoint(cd, loaded.unet, [loaded.text_encoder, loaded.text_encoder_2],
                             device=device)
        unet_params = loaded.unet
        if ck.get("unet_lora") is not None:
            unet_params = merge_lora(loaded.unet, ck["unet_lora"], scale=1.0)
        ti = ck.get("ti_rows") or [None, None]
        step = int(cd.rsplit("-", 1)[1])
        with torch.no_grad():
            eps_v, x0_v = eval_metrics(unet_params, ti[0], ti[1])
        eps_per_ckpt[step] = round(eps_v, 5)
        x0_per_ckpt[step] = round(x0_v, 5)

    def trend(metric, per_ckpt, note):
        out = {"metric": metric, "per_checkpoint": per_ckpt, "note": note}
        steps = sorted(per_ckpt)
        if len(steps) >= 2:
            out["first"] = per_ckpt[steps[0]]
            out["last"] = per_ckpt[steps[-1]]
            out["improved"] = per_ckpt[steps[-1]] < per_ckpt[steps[0]]
        return out

    quality = trend(
        "x0_latent_mse_train", x0_per_ckpt,
        "one-step denoised x0 estimate vs the true train latents (fixed latents/noise/timesteps; "
        "only adapters+TI vary per checkpoint)")
    held = trend(
        "held_out_eps_mse", eps_per_ckpt,
        "eps-prediction MSE on an unseen image from the same concept process (fixed "
        "latent/noise/timesteps; only adapters+TI vary per checkpoint)")
    return quality, held


def run(config_kwargs: dict, out_dir: str) -> dict:
    """Train, copy the plots and the last validation grid, and report the loss drop."""
    from sd_lora_trainer_tpu_torch.config import TrainingConfig
    from sd_lora_trainer_tpu_torch.main import train

    config = TrainingConfig(**config_kwargs)
    gen = train(config)
    while True:
        try:
            next(gen)
        except StopIteration as stop:
            config, save_dir = stop.value
            break

    os.makedirs(out_dir, exist_ok=True)
    run_root = str(config.output_dir)
    for name in ("losses.png", "learning_rates.png", "grad_norms.png"):
        src = os.path.join(run_root, name)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(out_dir, name))
    grid = os.path.join(save_dir, "validation_grid.jpg")
    if os.path.exists(grid):
        shutil.copy(grid, os.path.join(out_dir, "validation_grid.jpg"))

    with open(os.path.join(save_dir, "training_args.json")) as f:
        args_json = json.load(f)
    series = args_json["training_attributes"].get("loss_series", {})
    img_loss = series.get("img_loss") or series.get("tot_loss") or []
    k = max(len(img_loss) // 10, 1)
    first, last = img_loss[:k], img_loss[-k:]
    report = {
        "steps": config.max_train_steps,
        "seed": config.seed,
        "resolution": config.resolution,
        "first_window_mean_img_loss": sum(first) / len(first) if first else None,
        "last_window_mean_img_loss": sum(last) / len(last) if last else None,
        "job_time_sec": round(args_json.get("job_time", 0.0), 1),
        "run_dir": run_root,
    }
    if first and last:
        report["loss_drop_pct"] = round(
            100 * (1 - report["last_window_mean_img_loss"] / report["first_window_mean_img_loss"]), 2)
    return report


def main(argv=None) -> int:
    from sd_lora_trainer_tpu_torch.models.synthesize import (
        TINY_CLIP_G_CONFIG, TINY_CLIP_L_CONFIG, TINY_VAE_CONFIG, synthesize_checkpoint)
    from sd_lora_trainer_tpu_torch.models.unet import TINY_SDXL_UNET_CONFIG

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tiny", action="store_true", default=True,
                        help="the synthesized tiny SDXL recipe (the only mode)")
    parser.add_argument("--steps", type=int, default=500)
    parser.add_argument("--checkpointing-steps", type=int, default=100,
                        help="periodic checkpoints; each one is scored by the trends")
    parser.add_argument("--resolution", type=int, default=128)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=os.path.join(ROOT, "convergence_torch"))
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="convergence_", dir=os.path.join(ROOT, "build"))
    try:
        ckpt = os.path.join(work, "tiny_sdxl.safetensors")
        synthesize_checkpoint(ckpt, "sdxl", TINY_SDXL_UNET_CONFIG, TINY_VAE_CONFIG,
                              TINY_CLIP_L_CONFIG, TINY_CLIP_G_CONFIG, seed=args.seed,
                              device=str(device))
        data_dir = os.path.join(work, "dataset")
        make_structured_dataset(data_dir, seed=args.seed, size=max(args.resolution + 32, 128))
        cfg = dict(
            name="convergence_tiny", lora_training_urls=data_dir, concept_mode="style",
            caption_model="no_caption", sd_model_version="sdxl", ckpt_path=ckpt, seed=args.seed,
            resolution=args.resolution, validation_img_size=args.resolution, train_batch_size=2,
            max_train_steps=args.steps, checkpointing_steps=args.checkpointing_steps,
            n_sample_imgs=4, lora_rank=8, skip_gpt_cleanup=True, augment_imgs_up_to_n=0,
            debug=True, output_dir=os.path.join(work, "runs"), device=device.type,
        )
        report = run(cfg, args.out)
        quality, held = checkpoint_trends(ckpt, report["run_dir"], data_dir, seed=args.seed,
                                          res=args.resolution, device=device)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if quality:
        report["quality_proxy"] = quality
    if held:
        report["held_out_trend"] = held
    report["device"] = str(device)
    with open(os.path.join(args.out, "convergence_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    drop = report.get("loss_drop_pct")
    if drop is not None and drop <= 0:
        print("WARNING: loss did not decrease", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
