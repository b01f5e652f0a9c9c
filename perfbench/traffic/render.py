"""Traffic kind "render": a checkpoint's validation renders, back to back.

Each call is `inference.render_images` as `main.py`'s `do_render` makes it
at a checkpoint: the recipe's `n_sample_imgs` prompts drawn from the seed,
the trained adapters merged at the recipe's `sample_imgs_lora_scale` into
the (int8) base, the TI rows, CFG Euler sampling and the VAE decode, the
images written as JPEG files into the checkpoint's directory. The weights,
the adapters (B drawn as trained ones) and the rows come from the seed; the
tokenizers are the benchmark's word-level ones (perfbench/tokenizer.py).

Set-up renders once (every kernel and shape the window uses). The window
runs whole calls until `--seconds` has passed, and the rate is the images
of the completed calls over the time they took. The check renders a
sample of the last call's images, drawn from the seed, with the reference
and compares the images that `render_images` decoded (before JPEG).
"""

from __future__ import annotations

import gc
import json
import os
import random
import shutil
import tempfile
import time
from typing import List

import numpy as np
import torch

from perfbench import inputs as inp, yardstick
from perfbench.harness import Outcome, log
from perfbench.reference.nn import Prec
from perfbench.reference.render import render as ref_render
from perfbench.tokenizer import WordTokenizer
from perfbench.traffic.train import port_clip_config, port_unet_config


def image_gap(prog_u8: np.ndarray, ref: torch.Tensor) -> float:
    """||program - reference|| / ||reference - mid-grey|| of one image, both
    as the program's uint8 levels."""
    ref_u8 = as_uint8(ref).astype(np.float64)
    p = prog_u8.astype(np.float64)
    return float(np.linalg.norm(p - ref_u8) / np.linalg.norm(ref_u8 - 127.5))


def build(config: dict, mix: dict, seed: int, device, workdir: str):
    from sd_lora_trainer_tpu_torch.config import TrainingConfig
    from sd_lora_trainer_tpu_torch.diffusion.schedulers import DDPMSchedule
    from sd_lora_trainer_tpu_torch.inference import InferencePipeline
    from sd_lora_trainer_tpu_torch.models.lora import UNET_TARGETS, create_lora_params, iter_lora_leaves
    from sd_lora_trainer_tpu_torch.models.quant import quantize_base_weights
    from sd_lora_trainer_tpu_torch.models.vae import VAEConfig

    tc = TrainingConfig.from_dict(dict(mix["recipe"], **mix["overrides"], seed=int(seed),
                                       device=device.type, _testing_no_output_dir=True))
    data = inp.make_inputs(config, seed, device, rank=tc.lora_rank, n_tokens=tc.n_tokens, vae=True,
                           lora_b_std=mix["lora_b_std"])
    lora = create_lora_params(data["unet"], tc.lora_rank, torch.Generator(device=device).manual_seed(0),
                              alpha_multiplier=tc.lora_alpha_multiplier, targets=UNET_TARGETS)
    with torch.no_grad():
        for name, entry in iter_lora_leaves(lora):
            entry["a"].copy_(data["lora_a"][name])
            entry["b"].copy_(data["lora_b"][name])
    unet = data.pop("unet")
    if tc.resolve_quantize_base() in ("int8", "int8+te"):
        unet = quantize_base_weights(unet)
    vae = config["vae"]
    pipe = InferencePipeline(
        version="sdxl", unet_params=unet, unet_config=port_unet_config(config["unet"]),
        te1_params=data["te1"], te1_config=port_clip_config(config["text_encoder"]),
        te2_params=data["te2"], te2_config=port_clip_config(config["text_encoder_2"]),
        vae_params=data["vae"],
        vae_config=VAEConfig(block_out_channels=tuple(vae["block_out_channels"]),
                             layers_per_block=vae["layers_per_block"],
                             latent_channels=vae["latent_channels"],
                             norm_num_groups=vae["norm_num_groups"],
                             scaling_factor=vae["scaling_factor"]),
        tokenizer_1=WordTokenizer(config["text_encoder"]["vocab_size"]),
        tokenizer_2=WordTokenizer(config["text_encoder_2"]["vocab_size"], pad_token_id=0),
        schedule=DDPMSchedule.create(device=device),
        ti_rows=[data["ti"]["te1"], data["ti"]["te2"]])
    with open(os.path.join(workdir, "training_args.json"), "w") as f:
        json.dump({"name": tc.name, "concept_mode": tc.concept_mode,
                   "training_attributes": {"trigger_text": "TOK"}}, f)
    with open(os.path.join(workdir, "special_params.json"), "w") as f:
        json.dump(tc.token_dict, f)
    return tc, pipe, lora


class Renderer:
    """The program's render pipeline and checkpoint directory; `call()`
    renders once as `do_render` does and keeps the decoded images."""

    def __init__(self, config: dict, mix: dict, seed: int, device):
        from sd_lora_trainer_tpu_torch import inference

        self.inference, self.mix, self.device = inference, mix, device
        self.cuda = device.type == "cuda"
        self.workdir = tempfile.mkdtemp(prefix="perfbench_render_")
        self.decoded: List[np.ndarray] = []
        self._real_decode = inference.decode_images

        def recording_decode(pipe, z):
            imgs = self._real_decode(pipe, z)
            self.decoded.append(imgs)
            return imgs

        inference.decode_images = recording_decode
        self.tc, self.pipe, self.lora = build(config, mix, seed, device, self.workdir)
        self.calls = 0

    def call(self) -> None:
        w, h = self.mix["resolution"]
        tc = self.tc
        self.inference.render_images(
            self.pipe, render_size=(w, h), lora_path=self.workdir, train_step=self.calls,
            seed=tc.seed, lora_scale=tc.sample_imgs_lora_scale, disable_ti=tc.disable_ti,
            prompt_modifier=tc.prompt_modifier, n_steps=self.mix["n_steps"],
            n_imgs=tc.n_sample_imgs, unet_lora=self.lora)
        self.calls += 1
        del self.decoded[:-1]
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def close(self) -> np.ndarray:
        """The last call's images; the program's state dropped."""
        last = self.decoded[-1]
        self.inference.decode_images = self._real_decode
        shutil.rmtree(self.workdir, ignore_errors=True)
        self.pipe = self.lora = None
        self.decoded = []
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()
        return last


def check_rows(mix: dict, seed: int) -> List[int]:
    """The sample of a call's images that the check renders again."""
    return sorted(random.Random(seed).sample(range(mix["n_imgs"]), mix["check_images"]))


def run(ctx) -> Outcome:
    config, mix, seed, device = ctx.config, ctx.mix, ctx.seed, ctx.device
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    r = Renderer(config, mix, seed, device)
    try:
        r.call()
        setup_s = time.perf_counter() - ctx.t0
        log(f"set-up {setup_s:.2f} s")
        t_start, first = time.perf_counter(), r.calls
        while time.perf_counter() - t_start < ctx.seconds:
            r.call()
        window_s = time.perf_counter() - t_start
        images = (r.calls - first) * r.tc.n_sample_imgs
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        log(f"window: {r.calls - first} calls, {images} images in {window_s:.3f} s, "
            f"{images / window_s:.4f} imgs/s, peak {peak / 2**30:.3f} GiB")
        measured = {"render_imgs_per_s": images / window_s, "peak_gib": peak / 2**30,
                    "setup_s": setup_s}
        layer = {"window_s": window_s, "images": images, "config": config, "mix": mix,
                 "platform": "gpu" if cuda else "cpu", "trace": None}
        trace = None
        if ctx.trace:
            from torch.profiler import ProfilerActivity, profile, record_function

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            with profile(activities=acts) as prof:
                with record_function("perfbench.window"):
                    r.call()
            trace = yardstick.trace_from_profiler(prof, "perfbench.window")
            del prof
            w, h = mix["resolution"]
            layer["trace"] = trace
            layer["attention_calls"] = yardstick.self_attention_calls(
                config["unet"], 2 * r.tc.n_sample_imgs, h // 8, w // 8)
    finally:
        last = r.close()
    rows = check_rows(mix, seed)
    t = time.perf_counter()
    ref = reference_images(config, mix, seed, device, rows, "fp32")
    readings = {"image_gap": max(image_gap(last[i], ref[j]) for j, i in enumerate(rows))}
    log(f"reference of images {rows} in {time.perf_counter() - t:.1f} s")
    failed = int(sum(not np.isfinite(last[i]).all() for i in rows))
    return Outcome(measured=measured, layer=layer, readings=readings, attempted=images,
                   failed=failed, peak_bytes=peak, trace=trace)


def reference_images(config, mix, seed, device, rows, prec: str) -> torch.Tensor:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = mix["reference_recipe"]
    data = inp.make_inputs(config, seed, device, rank=r["lora_rank"], n_tokens=r["n_tokens"],
                           vae=True, lora_b_std=mix["lora_b_std"])
    return ref_render(config, mix, data, seed, Prec(prec), device, rows)


def as_uint8(images: torch.Tensor) -> np.ndarray:
    """Reference images in [-1, 1] as the program's uint8 levels."""
    return ((torch.clamp(images, -1, 1) + 1) * 127.5).to(torch.uint8).cpu().numpy()
