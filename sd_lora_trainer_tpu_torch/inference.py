"""Validation rendering and from-disk inference (counterpart of sd_lora_trainer_tpu/inference.py).

Euler-discrete sampling with trailing spacing, CFG 8, a fixed negative
prompt, the `prepare_prompt_for_lora` token-replacement policy and the
token-scale blend of conditionings: the trained-token prompt and a
token-free "zero" prompt are encoded separately and lerped by
token_scale = 0.5 + 0.5 * lora_scale**0.4.

Adapters are merged into the weights at the requested lora_scale before
sampling (models/lora.py `merge_lora`), so the loop runs the plain UNet,
under `torch.no_grad` (the flash op then keeps no residuals), with the
flash kernels wherever `flash_attention_qualifies` says so (on the card).
The prompts are Python's `random` draws from the seed, as in the JAX
package; the initial latents come from a `torch.Generator` seeded with it,
or are passed in (the tests feed the JAX package's draws).
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
from typing import List, Optional, Tuple

import numpy as np
import torch

from sd_lora_trainer_tpu_torch.diffusion.schedulers import DDPMSchedule, EulerDiscreteSampler
from sd_lora_trainer_tpu_torch.models.clip import CLIPTextConfig, clip_text_forward
from sd_lora_trainer_tpu_torch.models.lora import merge_lora
from sd_lora_trainer_tpu_torch.models.unet import UNetConfig, unet_forward
from sd_lora_trainer_tpu_torch.models.vae import VAEConfig, downsample_factor, vae_decode_batched
from sd_lora_trainer_tpu_torch.utils import profiling
from sd_lora_trainer_tpu_torch.utils.utils import fix_prompt, replace_in_string
from sd_lora_trainer_tpu_torch.utils.val_prompts import val_prompts

NEGATIVE_PROMPT = (
    "nude, naked, poorly drawn face, ugly, tiling, out of frame, extra limbs, "
    "disfigured, deformed body, blurry, blurred, watermark, text, grainy, "
    "signature, cut off, draft"
)


@dataclasses.dataclass
class InferencePipeline:
    """Everything a render needs: weights, tokenizers and configs."""

    version: str
    unet_params: dict
    unet_config: UNetConfig
    te1_params: dict
    te1_config: CLIPTextConfig
    te2_params: Optional[dict]
    te2_config: Optional[CLIPTextConfig]
    vae_params: dict
    vae_config: VAEConfig
    tokenizer_1: object
    tokenizer_2: Optional[object]
    schedule: DDPMSchedule
    ti_rows: Optional[List[Optional[torch.Tensor]]] = None

    @property
    def device(self) -> torch.device:
        return self.te1_params["text_model"]["embeddings"]["token_embedding"]["weight"].device


def prepare_prompt_for_lora(prompt: str, lora_path: str, interpolation: bool = False,
                            verbose: bool = False) -> str:
    """Replace <concept>/the LoRA's name with the trigger text, and TOK with
    the trained tokens."""
    if "_no_token" in lora_path:
        return prompt
    sp_path = os.path.join(lora_path, "special_params.json")
    if not os.path.exists(sp_path):
        raise ValueError(
            "This concept is from an old lora trainer that was deprecated. "
            "Please retrain your concept for better results!"
        )
    with open(sp_path) as f:
        token_map = json.load(f)
    with open(os.path.join(lora_path, "training_args.json")) as f:
        training_args = json.load(f)
    trigger_text = training_args["training_attributes"]["trigger_text"]
    lora_name = str(training_args.get("name", "concept"))
    encapsulated = f"<{lora_name}>"
    mode = training_args.get("concept_mode", training_args.get("mode", "object"))

    if mode != "style":
        prompt = replace_in_string(prompt, {
            "<concept>": trigger_text,
            "<concepts>": trigger_text + "'s",
            encapsulated: trigger_text,
            encapsulated.lower(): trigger_text,
            lora_name: trigger_text,
            lora_name.lower(): trigger_text,
        })
        if trigger_text not in prompt:
            prompt = trigger_text + ", " + prompt
    else:
        prompt = replace_in_string(prompt, {
            "in the style of <concept>": "in the style of TOK",
            f"in the style of {encapsulated}": "in the style of TOK",
            f"in the style of {encapsulated.lower()}": "in the style of TOK",
            f"in the style of {lora_name}": "in the style of TOK",
            f"in the style of {lora_name.lower()}": "in the style of TOK",
        })
        if "in the style of TOK" not in prompt:
            prompt = "in the style of TOK, " + prompt

    prompt = replace_in_string(prompt, {"<concept>": "TOK", encapsulated: "TOK"})
    if interpolation and mode != "style":
        prompt = "TOK, " + prompt
    prompt = fix_prompt(replace_in_string(prompt, token_map))
    if verbose:
        print(f"Adjusted prompt for LoRA: {prompt}")
    return prompt


def compute_token_scale(lora_scale: float, power: float = 0.4, min_scale: float = 0.5) -> float:
    """token_scale = min + (1 - min) * lora_scale**power."""
    return min_scale + (1.0 - min_scale) * (lora_scale**power)


def _encode(pipe: InferencePipeline, prompts: List[str], resolution: Tuple[int, int]):
    """A prompt batch -> (prompt_embeds, pooled, add_time_ids), float32."""
    dev = pipe.device

    def run(tokenizer, params, cfg, ti):
        ids = torch.tensor(tokenizer(prompts), dtype=torch.long, device=dev)
        with torch.no_grad():
            return clip_text_forward(params, ids, cfg, ti_embeddings=ti, dtype=torch.float32)

    rows = pipe.ti_rows or []
    o1 = run(pipe.tokenizer_1, pipe.te1_params, pipe.te1_config, rows[0] if rows else None)
    if pipe.version == "sd15":
        return o1["last"], None, None
    o2 = run(pipe.tokenizer_2, pipe.te2_params, pipe.te2_config,
             rows[1] if len(rows) > 1 else None)
    embeds = torch.cat([o1["penultimate"], o2["penultimate"]], dim=-1)
    w, h = resolution
    add_time_ids = torch.tensor([[1024, 1024, 0, 0, h, w]], dtype=torch.float32,
                                device=dev).repeat(len(prompts), 1)
    return embeds, o2["pooled"], add_time_ids


def encode_prompt_advanced(
    pipe: InferencePipeline,
    lora_path: Optional[str],
    prompt: str,
    negative_prompt: str,
    lora_scale: float,
    resolution: Tuple[int, int],
    token_scale: Optional[float] = None,
    concept_mode: Optional[str] = None,
    negative_cache: Optional[Tuple] = None,
):
    """Blend the trained-token and token-free conditionings; returns
    (c, uc, pc, puc, add_time_ids). `negative_cache` holds a precomputed
    (uc, puc) of the negative prompt."""
    if lora_path and token_scale != 0:
        lora_prompt = prepare_prompt_for_lora(prompt, lora_path)
    else:
        lora_prompt = prompt
    replace_str = {"face": "person", "object": "object"}.get(concept_mode, "")
    zero_prompt = fix_prompt(prompt.replace("<concept>", replace_str))

    c2, pc2, add_ids = _encode(pipe, [lora_prompt], resolution)
    c1, pc1, _ = _encode(pipe, [zero_prompt], resolution)
    if negative_cache is not None:
        uc, puc = negative_cache
    else:
        uc, puc, _ = _encode(pipe, [negative_prompt], resolution)
    if token_scale is None:
        token_scale = compute_token_scale(lora_scale)
    c = (1 - token_scale) * c1 + token_scale * c2
    pc = None if pc1 is None else (1 - token_scale) * pc1 + token_scale * pc2
    return c, uc, pc, puc, add_ids


def _sample(pipe: InferencePipeline, unet_params: dict, latents: torch.Tensor, c, uc, pc, puc,
            add_ids, num_inference_steps: int, guidance_scale: float,
            compute_dtype=torch.bfloat16, use_flash: bool = True) -> torch.Tensor:
    """The CFG Euler loop: float32 latents, sigmas and CFG combine; the UNet
    forward in `compute_dtype` at batch 2n (unconditional and conditional)."""
    sampler = EulerDiscreteSampler(pipe.schedule)
    sigmas, timesteps = sampler.sigmas_and_timesteps(num_inference_steps)
    x = latents.float() * sampler.init_noise_sigma(num_inference_steps)
    ctx = torch.cat([uc, c]).to(compute_dtype)
    added = None
    if pipe.version == "sdxl":
        added = {"text_embeds": torch.cat([puc, pc]).to(compute_dtype),
                 "time_ids": torch.cat([add_ids, add_ids])}
    timesteps = timesteps.to(x.device)
    with torch.no_grad():
        for i in range(num_inference_steps):
            sigma, sigma_next = sigmas[i], sigmas[i + 1]
            x_in = sampler.scale_model_input(x, sigma)
            both = torch.cat([x_in, x_in]).to(compute_dtype)
            t = timesteps[i].expand(both.shape[0])
            eps, _ = unet_forward(unet_params, both, t, ctx, pipe.unet_config, added_cond=added,
                                  capture_attn=False, use_flash=use_flash, remat=False)
            eps_uncond, eps_text = eps.float().chunk(2)
            eps = eps_uncond + guidance_scale * (eps_text - eps_uncond)
            x = sampler.step(eps, sigma, sigma_next, x)
    return x


def decode_images(pipe: InferencePipeline, z: torch.Tensor) -> np.ndarray:
    """Latents -> uint8 NHWC images (bf16 decode in batch chunks)."""
    with torch.no_grad():
        imgs = vae_decode_batched(pipe.vae_params, z.to(torch.bfloat16), pipe.vae_config)
    imgs = (torch.clamp(imgs.float(), -1, 1) + 1) * 127.5
    return imgs.cpu().numpy().astype(np.uint8)


def render_images_eval(
    base_checkpoint_path: str,
    lora_save_path: str,
    render_size: Tuple[int, int],
    seed: int = 0,
    lora_scale: float = 0.75,
    n_imgs: int = 4,
    n_steps: int = 25,
    dtype=torch.bfloat16,
    precision: str = "bf16",
    device="cuda",
) -> List[str]:
    """Render from disk: rebuild the pipeline from the base checkpoint, load
    the trained adapters and TI rows, render into `lora_save_path`."""
    from sd_lora_trainer_tpu_torch.checkpoint import load_checkpoint
    from sd_lora_trainer_tpu_torch.main import build_tokenizers
    from sd_lora_trainer_tpu_torch.models.weights import load_models_from_checkpoint

    loaded = load_models_from_checkpoint(base_checkpoint_path, dtype=dtype, device=device)
    tok1, tok2 = build_tokenizers(loaded)
    ckpt = load_checkpoint(lora_save_path, loaded.unet,
                           [loaded.text_encoder, loaded.text_encoder_2], device=device)
    n_tokens = ckpt["ti_rows"][0].shape[0] if ckpt["ti_rows"][0] is not None else 0
    toks = [f"<s{i}>" for i in range(n_tokens)]
    for tok in (tok1, tok2):
        if tok is not None and toks:
            tok.add_special_tokens(toks)
    pipe = InferencePipeline(
        version=loaded.version, unet_params=loaded.unet, unet_config=loaded.unet_config,
        te1_params=loaded.text_encoder, te1_config=loaded.text_encoder_config,
        te2_params=loaded.text_encoder_2, te2_config=loaded.text_encoder_2_config,
        vae_params=loaded.vae, vae_config=loaded.vae_config, tokenizer_1=tok1,
        tokenizer_2=tok2, schedule=DDPMSchedule.create(device=device), ti_rows=ckpt["ti_rows"],
    )
    return render_images(pipe, render_size=render_size, lora_path=lora_save_path, train_step=0,
                         seed=seed, lora_scale=lora_scale, n_imgs=n_imgs, n_steps=n_steps,
                         unet_lora=ckpt["unet_lora"], te_loras=ckpt["te_loras"],
                         precision=precision)


def render_images(
    pipe: InferencePipeline,
    render_size: Tuple[int, int],
    lora_path: str,
    train_step: int,
    seed: int,
    lora_scale: float = 0.75,
    disable_ti: bool = False,
    prompt_modifier: Optional[str] = None,
    n_steps: int = 25,
    n_imgs: int = 4,
    unet_lora: Optional[dict] = None,
    te_loras: Optional[List[Optional[dict]]] = None,
    precision: str = "bf16",
    latents: Optional[torch.Tensor] = None,
) -> List[str]:
    """Render the validation images into `lora_path` as
    img_{train_step:04d}_{i}.jpg and return their prompts. The first prompt
    is "" (style) or "<concept>"; the rest are drawn from the mode's bank.
    `latents` [n_imgs, h/8, w/8, 4] replaces the initial normal draws.

    Host spans (utils/profiling.py) name the call's parts:
    `sdlt.render.merge` (the adapters into the weights), `encode` (the
    prompts), `denoise` (the sampling loop), `decode` (the VAE and the
    images' copy to the host) and `write` (the JPEG files)."""
    from PIL import Image

    random.seed(seed)
    with open(os.path.join(lora_path, "training_args.json")) as f:
        concept_mode = json.load(f)["concept_mode"]
    bank = val_prompts[concept_mode]
    prompts = random.sample(bank, min(n_imgs, len(bank)))
    while len(prompts) < n_imgs:
        prompts.append(random.choice(bank))
    prompts[0] = "" if concept_mode == "style" else "<concept>"
    if prompt_modifier:
        prompts = [prompt_modifier.format(p) for p in prompts]

    with profiling.span("render.merge"):
        unet_params = pipe.unet_params
        if unet_lora is not None:
            unet_params = merge_lora(unet_params, unet_lora, scale=lora_scale)
        te1_params, te2_params = pipe.te1_params, pipe.te2_params
        if te_loras:
            if te_loras[0] is not None:
                te1_params = merge_lora(te1_params, te_loras[0], scale=lora_scale)
            if len(te_loras) > 1 and te_loras[1] is not None and te2_params is not None:
                te2_params = merge_lora(te2_params, te_loras[1], scale=lora_scale)
    pipe = dataclasses.replace(pipe, unet_params=unet_params, te1_params=te1_params,
                               te2_params=te2_params)

    w, h = int(render_size[0]), int(render_size[1])
    f = downsample_factor(pipe.vae_config)
    lw, lh = w // f, h // f
    dev = pipe.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    cs, pcs, draws = [], [], []
    with profiling.span("render.encode"):
        uc, puc, _ = _encode(pipe, [NEGATIVE_PROMPT], (w, h))  # shared across prompts
        add_ids = None
        for prompt in prompts:
            c, uc, pc, puc, add_ids = encode_prompt_advanced(
                pipe, lora_path, prompt, NEGATIVE_PROMPT, lora_scale, (w, h),
                token_scale=0 if disable_ti else None, concept_mode=concept_mode,
                negative_cache=(uc, puc),
            )
            cs.append(c)
            pcs.append(pc)
            draws.append(torch.randn(1, lh, lw, 4, generator=gen, device=dev))
        n = len(prompts)
        c = torch.cat(cs)
        uc = uc.repeat(n, 1, 1)
        pc = None if pcs[0] is None else torch.cat(pcs)
        puc = None if puc is None else puc.repeat(n, 1)
        add_ids = None if add_ids is None else add_ids.repeat(n, 1)
    if latents is None:
        latents = torch.cat(draws)
    with profiling.span("render.denoise"):
        z = _sample(pipe, pipe.unet_params, latents.to(dev), c, uc, pc, puc, add_ids, n_steps,
                    8.0, compute_dtype=torch.float32 if precision == "fp32" else torch.bfloat16,
                    use_flash=precision != "fp32")
    with profiling.span("render.decode"):
        imgs = decode_images(pipe, z)
    with profiling.span("render.write"):
        for i in range(n):
            Image.fromarray(imgs[i]).save(os.path.join(lora_path, f"img_{train_step:04d}_{i}.jpg"),
                                          quality=95)
    return prompts
