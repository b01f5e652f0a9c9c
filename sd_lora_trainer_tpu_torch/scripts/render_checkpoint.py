"""Render a trained checkpoint at a sweep of LoRA scales, one grid per scale.

    python -m sd_lora_trainer_tpu_torch.scripts.render_checkpoint CHECKPOINT_DIR
        --base_checkpoint SD.safetensors [--lora_scales 0.6,0.75,0.9]
        [--n_imgs 4] [--render_size 768] [--seed 0] [--device cuda]

Counterpart of the JAX package's scripts/test_inference.py (renamed so no
test collector takes it for a test file): loads the base checkpoint and the
trained adapters and TI rows from CHECKPOINT_DIR, and for each scale
renders `--n_imgs` validation images and their grid into
CHECKPOINT_DIR/scale_{scale:.2f}/.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

import torch

from sd_lora_trainer_tpu_torch.scripts import resolve_device


def main(argv=None) -> int:
    from sd_lora_trainer_tpu_torch.checkpoint import load_checkpoint
    from sd_lora_trainer_tpu_torch.data.io import make_validation_img_grid
    from sd_lora_trainer_tpu_torch.diffusion.schedulers import DDPMSchedule
    from sd_lora_trainer_tpu_torch.inference import InferencePipeline, render_images
    from sd_lora_trainer_tpu_torch.main import build_tokenizers
    from sd_lora_trainer_tpu_torch.models.weights import load_models_from_checkpoint

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("checkpoint_dir", help="trained checkpoint folder")
    parser.add_argument("--base_checkpoint", required=True, help="single-file SD checkpoint")
    parser.add_argument("--lora_scales", default="0.6,0.75,0.9")
    parser.add_argument("--n_imgs", type=int, default=4)
    parser.add_argument("--render_size", type=int, default=768)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    loaded = load_models_from_checkpoint(args.base_checkpoint, dtype=dtype, device=device)
    tok1, tok2 = build_tokenizers(loaded)
    ckpt = load_checkpoint(args.checkpoint_dir, loaded.unet,
                           [loaded.text_encoder, loaded.text_encoder_2], device=device)
    rows = ckpt["ti_rows"]
    toks = [f"<s{i}>" for i in range(rows[0].shape[0] if rows[0] is not None else 0)]
    for tok in (tok1, tok2):
        if tok is not None and toks:
            tok.add_special_tokens(toks)
    pipe = InferencePipeline(
        version=loaded.version, unet_params=loaded.unet, unet_config=loaded.unet_config,
        te1_params=loaded.text_encoder, te1_config=loaded.text_encoder_config,
        te2_params=loaded.text_encoder_2, te2_config=loaded.text_encoder_2_config,
        vae_params=loaded.vae, vae_config=loaded.vae_config, tokenizer_1=tok1, tokenizer_2=tok2,
        schedule=DDPMSchedule.create(device=device), ti_rows=rows)

    for scale in [float(s) for s in args.lora_scales.split(",")]:
        print(f"--- rendering at lora_scale={scale}")
        out_dir = os.path.join(args.checkpoint_dir, f"scale_{scale:.2f}")
        os.makedirs(out_dir, exist_ok=True)
        for f in ("training_args.json", "special_params.json"):  # render_images reads them
            if not os.path.exists(os.path.join(out_dir, f)):
                shutil.copy(os.path.join(args.checkpoint_dir, f), os.path.join(out_dir, f))
        render_images(pipe, render_size=(args.render_size, args.render_size), lora_path=out_dir,
                      train_step=0, seed=args.seed, lora_scale=scale, n_imgs=args.n_imgs,
                      unet_lora=ckpt["unet_lora"], te_loras=ckpt["te_loras"],
                      precision="bf16" if device.type == "cuda" else "fp32")
        grid = make_validation_img_grid(out_dir)
        print(f"saved renders and {os.path.basename(grid)} to {out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
