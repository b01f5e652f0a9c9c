"""Render throughput: full-width SDXL CFG Euler sampling plus the VAE decode.

    python -m sd_lora_trainer_tpu_torch.scripts.bench_inference [--res 1024]
        [--steps 25] [--batch 4] [--images 4] [--device cuda] [--tiny]

Counterpart of the JAX package's scripts/bench_inference.py: the render
loop of the validation grid (`inference._sample`, the UNet at batch 2n for
the unconditional and conditional halves, then the batched decode), on
random weights built on the device from a seed and random conditionings.
One warm-up render, then `--images / --batch` timed renders. stdout carries
one JSON line with the JAX script's metric name and unit (s/img), plus a
`config` with the flash_fwd launches per render call and the device's name
and power limit; diagnostics go to stderr. `--tiny` runs the tiny configs
(the code path only, for tests).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from sd_lora_trainer_tpu_torch.scripts import resolve_device


def log(*args) -> None:
    print("[bench-inf]", *args, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--res", type=int, default=1024)
    parser.add_argument("--steps", type=int, default=25, help="Euler steps")
    parser.add_argument("--batch", type=int, default=4, help="images per render call")
    parser.add_argument("--images", type=int, default=4, help="images timed")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--tiny", action="store_true", help="tiny configs (tests only)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    stdout = sys.stdout
    with contextlib.redirect_stdout(sys.stderr):
        out = run(args, device)
    print(json.dumps(out), file=stdout, flush=True)
    return 0


def run(args, device: torch.device) -> dict:
    from sd_lora_trainer_tpu_torch.diffusion.schedulers import DDPMSchedule
    from sd_lora_trainer_tpu_torch.inference import InferencePipeline, _sample, decode_images
    from sd_lora_trainer_tpu_torch.models import synthesize, unet as unet_mod, vae as vae_mod
    from sd_lora_trainer_tpu_torch.ops import flash_attention as fa
    from sd_lora_trainer_tpu_torch.utils import profiling

    unet_cfg = unet_mod.TINY_SDXL_UNET_CONFIG if args.tiny else unet_mod.SDXL_UNET_CONFIG
    vae_cfg = synthesize.TINY_VAE_CONFIG if args.tiny else vae_mod.SDXL_VAE_CONFIG
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    pipe = InferencePipeline(
        version="sdxl", unet_params=unet_mod.init_unet_params(unet_cfg, gen, dtype=torch.bfloat16,
                                                              device=device),
        unet_config=unet_cfg, te1_params=None, te1_config=None, te2_params=None, te2_config=None,
        vae_params=vae_mod.init_vae_params(vae_cfg, gen, dtype=torch.bfloat16, device=device),
        vae_config=vae_cfg, tokenizer_1=None, tokenizer_2=None,
        schedule=DDPMSchedule.create(device=device))
    n, lat = args.batch, args.res // vae_mod.downsample_factor(vae_cfg)
    ctx, pooled = unet_cfg.cross_attention_dim, unet_cfg.addition_pooled_dim

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    c, uc, pc, puc = randn(n, 77, ctx), randn(n, 77, ctx), randn(n, pooled), randn(n, pooled)
    add_ids = torch.tensor([[1024, 1024, 0, 0, args.res, args.res]], dtype=torch.float32,
                           device=device).repeat(n, 1)
    latents = randn(n, lat, lat, 4)
    profiling.synchronize(device)
    log(f"built SDXL UNet + VAE ({'tiny' if args.tiny else 'full width'}, bf16) on {device} in "
        f"{time.perf_counter() - t0:.1f} s; {args.res}px, {args.steps} steps, batch {n}")

    def render():
        z = _sample(pipe, pipe.unet_params, latents, c, uc, pc, puc, add_ids, args.steps, 8.0)
        return decode_images(pipe, z)  # a host copy: waits for the device

    t0 = time.perf_counter()
    img = render()
    log(f"first render {time.perf_counter() - t0:.2f} s (checksum {int(img.sum())})")
    n_calls = max(args.images // n, 1)
    before = dict(fa.LAUNCHES)
    t0 = time.perf_counter()
    for _ in range(n_calls):
        render()
    dt = time.perf_counter() - t0
    per_img = dt / (n_calls * n)
    launches = {k: (fa.LAUNCHES[k] - before[k]) / n_calls for k in fa.LAUNCHES}
    log(f"{n_calls} call(s) x batch {n} in {dt:.3f} s -> {per_img:.3f} s/img; flash launches "
        f"per call {launches}")
    return {"metric": f"sdxl_render_seconds_per_image_{args.res}px_{args.steps}steps_batch{n}",
            "value": round(per_img, 3), "unit": "s/img", "vs_baseline": None,
            "config": {"resolution": args.res, "steps": args.steps, "batch": n,
                       "images": n_calls * n, "launches_per_call": launches,
                       "device": profiling.device_description(device)}}


if __name__ == "__main__":
    sys.exit(main())
