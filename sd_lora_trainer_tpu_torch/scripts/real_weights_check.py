"""One-command rehearsal of the product path: convert -> train -> render -> score.

    python -m sd_lora_trainer_tpu_torch.scripts.real_weights_check --ckpt SD.safetensors
        [--model sdxl] [--res 512] [--steps 20] [--device cuda]
    python -m sd_lora_trainer_tpu_torch.scripts.real_weights_check --synthesize tiny|full

Counterpart of the JAX package's scripts/real_weights_check.py: loads a
single-file checkpoint through the strict converter (models/weights.py),
trains `--steps` LoRA+TI steps on a small synthetic concept with the port's
trainer, renders the validation images, and checks the artifact set,
finite losses and that every render has contrast. Where a CLIP scorer is
staged (scripts/auto_eval_model.py) it also scores train similarity, and
with real weights asserts `--min-train-sim`. `--synthesize` writes a
checkpoint first: "tiny" (the JAX package's tiny SDXL, or for `--model
sd15` its tiny SD1.5 with the cross-attention width of the tiny CLIP-L) or
"full" (the published widths). The last line is "REAL-WEIGHTS CHECK PASSED" when
everything held; any failure raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

import numpy as np

from sd_lora_trainer_tpu_torch.scripts import ROOT, resolve_device


def make_dataset(root: str, n: int = 4, size: int = 96) -> str:
    """Structured stripe patterns with captions (not pure noise, so CLIP
    train similarity means something)."""
    from PIL import Image

    data_dir = os.path.join(root, "dataset")
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.RandomState(0)
    for i in range(n):
        img = np.zeros((size, size, 3), np.uint8)
        img[:, :, i % 3] = 200
        img[:: (i + 2), :, :] = 30
        img += rng.randint(0, 40, img.shape).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(data_dir, f"img_{i}.jpg"))
        with open(os.path.join(data_dir, f"img_{i}.txt"), "w") as f:
            f.write(f"a striped test pattern number {i}")
    return data_dir


def synthesize(root: str, model: str, full: bool, device) -> str:
    """Write a synthesized single-file checkpoint (tiny or full width)."""
    import torch

    from sd_lora_trainer_tpu_torch.models import clip, synthesize as syn, unet as unet_mod, vae

    if full:
        unet_cfg = unet_mod.SDXL_UNET_CONFIG if model == "sdxl" else unet_mod.SD15_UNET_CONFIG
        vae_cfg = vae.SDXL_VAE_CONFIG if model == "sdxl" else vae.SD15_VAE_CONFIG
        te1_cfg, te2_cfg = clip.CLIP_L_CONFIG, clip.CLIP_BIG_G_CONFIG
    else:
        vae_cfg, te1_cfg, te2_cfg = syn.TINY_VAE_CONFIG, syn.TINY_CLIP_L_CONFIG, syn.TINY_CLIP_G_CONFIG
        # the tiny SD1.5 UNet's cross-attention (48 wide) takes the tiny
        # CLIP-L's 32: its hidden states are SD1.5's conditioning
        unet_cfg = (unet_mod.TINY_SDXL_UNET_CONFIG if model == "sdxl" else dataclasses.replace(
            unet_mod.TINY_SD15_UNET_CONFIG, cross_attention_dim=te1_cfg.hidden_size))
    ckpt = os.path.join(root, f"synth_{model}_{'full' if full else 'tiny'}.safetensors")
    print(f"[real-weights-check] synthesizing {'full-width' if full else 'tiny'} {model} "
          f"checkpoint -> {ckpt}", flush=True)
    syn.synthesize_checkpoint(ckpt, model, unet_cfg, vae_cfg, te1_cfg,
                              te2_cfg if model == "sdxl" else None, seed=0,
                              dtype=torch.float16 if full else torch.float32, device=str(device))
    return ckpt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", default=None, help="staged real checkpoint (single-file LDM)")
    ap.add_argument("--model", default="sdxl", choices=["sdxl", "sd15"])
    ap.add_argument("--res", type=int, default=None,
                    help="train/render resolution (default: 512 real, 64 synthesized)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--synthesize", choices=["tiny", "full"], default=None,
                    help="dry-run on a synthesized checkpoint instead of --ckpt")
    ap.add_argument("--out", default=None, help="output root (default: a temp dir under build/)")
    ap.add_argument("--min-train-sim", type=float, default=0.35,
                    help="CLIP train-similarity floor (real weights only)")
    ap.add_argument("--quantize-base", default="auto", choices=["auto", "none", "int8", "int8+te"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not args.ckpt and not args.synthesize:
        ap.error("need --ckpt (staged real weights) or --synthesize tiny|full")
    device = resolve_device(args.device)

    from PIL import Image

    from sd_lora_trainer_tpu_torch.config import TrainingConfig
    from sd_lora_trainer_tpu_torch.main import train
    from sd_lora_trainer_tpu_torch.scripts.auto_eval_model import Evaluation, get_all_jpg_filenames

    if args.out:
        root = args.out
        os.makedirs(root, exist_ok=True)
    else:
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        root = tempfile.mkdtemp(prefix="real_weights_check_", dir=os.path.join(ROOT, "build"))
    ckpt = args.ckpt or synthesize(root, args.model, args.synthesize == "full", device)
    res = args.res or (512 if args.ckpt else 64)
    data_dir = make_dataset(root)

    config = TrainingConfig(
        name="rwcheck", lora_training_urls=data_dir, concept_mode="style",
        caption_model="no_caption", sd_model_version=args.model, ckpt_path=ckpt, seed=0,
        resolution=res, validation_img_size=res, train_batch_size=2, max_train_steps=args.steps,
        checkpointing_steps=10_000, n_sample_imgs=2, lora_rank=8, skip_gpt_cleanup=True,
        augment_imgs_up_to_n=0, quantize_base=args.quantize_base,
        output_dir=os.path.join(root, "runs"), device=device.type,
    )
    print(f"[real-weights-check] training {args.steps} steps @ {res}px on {ckpt} ({device})",
          flush=True)
    gen = train(config)
    while True:
        try:
            next(gen)
        except StopIteration as stop:
            config, save_dir = stop.value
            break

    files = os.listdir(save_dir)
    for want in ("special_params.json", "training_args.json", "validation_grid.jpg"):
        if want not in files:
            raise RuntimeError(f"the checkpoint lacks {want}: {files}")
    if not (any(f.endswith("_lora.safetensors") for f in files)
            and any(f.endswith("_embeddings.safetensors") for f in files)):
        raise RuntimeError(f"the checkpoint lacks the LoRA or the embeddings: {files}")
    print(f"[real-weights-check] artifact set OK in {save_dir}", flush=True)

    with open(os.path.join(save_dir, "training_args.json")) as f:
        losses = json.load(f)["training_attributes"]["final_losses"].get("img_loss", [])
    if not losses or not np.all(np.isfinite(losses)):
        raise RuntimeError(f"losses {losses}")

    renders = sorted(f for f in files if f.startswith("img_") and f.endswith(".jpg"))
    if not renders:
        raise RuntimeError(f"no renders among {files}")
    for f in renders:
        std = np.asarray(Image.open(os.path.join(save_dir, f))).std()
        if std <= 1.0:
            raise RuntimeError(f"render {f} is near-constant (std={std:.3f})")

    ev = Evaluation([os.path.join(save_dir, f) for f in renders], device)
    if ev.available:
        sim = ev.training_image_alignment(get_all_jpg_filenames(data_dir))
        print(f"[real-weights-check] CLIP train-similarity: {sim:.4f}", flush=True)
        if args.ckpt and sim < args.min_train_sim:  # meaningful only with real weights
            raise RuntimeError(f"train-similarity {sim:.3f} < floor {args.min_train_sim}: the "
                               "adapters did not move the renders toward the concept")
    else:
        print("[real-weights-check] DEGRADED: CLIP scorer not staged "
              "(model_paths['CLIP']/clip-vit-base-patch32); skipped the train-similarity "
              "check, ran the image-statistics checks only", flush=True)
    print("REAL-WEIGHTS CHECK PASSED", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
