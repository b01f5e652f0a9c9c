"""The reference validation render of a style LoRA (the trainer's published
render, the JAX package's read as a description): the prompts drawn from
the seed out of the style bank, each encoded with the trained tokens and
without them and blended by token_scale = 0.5 + 0.5 * lora_scale^0.4, the
negative prompt, the adapters merged into the (int8) base at lora_scale,
classifier-free guidance through a Euler sampler with trailing timesteps,
and the VAE decode. Nothing here imports the program under test."""

from __future__ import annotations

import random
import re
from typing import Dict, List

import torch

from perfbench.reference import vae as ref_vae
from perfbench.reference.clip import ClipSpec, clip_text
from perfbench.reference.nn import Prec
from perfbench.reference.train import _map, ddpm_alphas_cumprod, int8_rowwise
from perfbench.reference.unet import UNet, UNetSpec
from perfbench.tokenizer import WordTokenizer

_BOUNDARY = ("conv_in", "conv_out")


def replace_ci(s: str, table: Dict[str, str]) -> str:
    """Case-blind regex replacement, repeated until nothing changes."""
    while True:
        new = s
        for target, repl in table.items():
            new = re.sub(target, repl, new, flags=re.IGNORECASE)
        if new == s:
            return s
        s = new


def fix(prompt: str) -> str:
    if not prompt:
        return prompt
    prompt = re.sub(r"\s+", " ", prompt)
    prompt = re.sub(r",,", ",", prompt)
    prompt = re.sub(r"\s?,\s?", ", ", prompt)
    prompt = re.sub(r"\s?\.\s?", ". ", prompt)
    return prompt.strip()


def style_prompts(bank: List[str], n: int, seed: int) -> List[str]:
    rng = random.Random(seed)
    prompts = rng.sample(bank, min(n, len(bank)))
    while len(prompts) < n:
        prompts.append(rng.choice(bank))
    prompts[0] = ""
    return prompts


def with_tokens(prompt: str, name: str, token_map: Dict[str, str]) -> str:
    """A style prompt with the trained tokens in it."""
    enc = f"<{name}>"
    prompt = replace_ci(prompt, {
        "in the style of <concept>": "in the style of TOK",
        f"in the style of {enc}": "in the style of TOK",
        f"in the style of {enc.lower()}": "in the style of TOK",
        f"in the style of {name}": "in the style of TOK",
        f"in the style of {name.lower()}": "in the style of TOK"})
    if "in the style of TOK" not in prompt:
        prompt = "in the style of TOK, " + prompt
    prompt = replace_ci(prompt, {"<concept>": "TOK", enc: "TOK"})
    return fix(replace_ci(prompt, token_map))


def merged_unet(tree: dict, loras: Dict[str, dict], scale: float, prec: Prec, int8: bool) -> dict:
    """The UNet's weights with every adapter merged at `scale`:
    W + scale * (alpha / r) * B A, on the int8 base's weights where the
    recipe has one."""

    def leaf(path, t):
        if t.device.type != "meta":
            if int8 and path[-1] == "weight" and t.ndim in (2, 4) and path[-2] not in _BOUNDARY:
                t = int8_rowwise(t)
            site = ".".join(path[:-1])
            if path[-1] == "weight" and site in loras:
                a, b = loras[site]["a"].float(), loras[site]["b"].float()
                if a.ndim == 2:
                    delta = b @ a
                else:
                    delta = torch.einsum("or,rihw->oihw", b[:, :, 0, 0], a)
                t = t.float() + delta * scale * loras[site]["scale"]
        return t.to(prec.dt)

    return _map(tree, leaf)


def render(config: dict, mix: dict, inputs: dict, seed: int, prec: Prec, device,
           rows: List[int]) -> torch.Tensor:
    """The images [len(rows), H, W, 3] in [-1, 1] of the render's prompts
    `rows` (indices into its n_imgs)."""
    x = sample(config, mix, inputs, seed, prec, device, rows)
    with torch.no_grad():
        imgs = torch.cat([ref_vae.decode(inputs["vae"], x[j:j + 1], config["vae"], prec)
                          for j in range(len(rows))])
    return imgs.float().permute(0, 2, 3, 1)


def sample(config: dict, mix: dict, inputs: dict, seed: int, prec: Prec, device,
           rows: List[int]) -> torch.Tensor:
    """The sampled latents [len(rows), 4, h, w] (scaled, float32) of the
    render's prompts `rows`."""
    r = mix["reference_recipe"]
    w, h = mix["resolution"]
    n = mix["n_imgs"]
    lora_scale = r["lora_scale"]
    prompts = style_prompts(mix["prompt_bank"], n, seed)
    loras = {s: {"a": inputs["lora_a"][s], "b": inputs["lora_b"][s], "scale": r["lora_alpha_multiplier"]}
             for s in inputs["lora_a"]}
    unet_w = merged_unet(inputs["unet"], loras, lora_scale, prec, r["int8_base"])
    te = [inputs["te1"], inputs["te2"]]
    specs = [ClipSpec.from_config(config["text_encoder"]), ClipSpec.from_config(config["text_encoder_2"])]
    toks = [WordTokenizer(config["text_encoder"]["vocab_size"]),
            WordTokenizer(config["text_encoder_2"]["vocab_size"], pad_token_id=0)]
    # the render encodes its prompts in float32 (the control: fp8 operands)
    enc_prec = prec if prec.name == "fp8" else Prec("fp32")
    te_w = [_map(t, lambda _, x: x.float()) for t in te]
    ti = [inputs["ti"]["te1"], inputs["ti"]["te2"]]

    def encode(text):
        outs = []
        for i in range(2):
            ids = torch.tensor(toks[i]([text]), device=device)
            outs.append(clip_text(te_w[i], ids, specs[i], enc_prec, ti[i]))
        return (torch.cat([outs[0]["penultimate"], outs[1]["penultimate"]], dim=-1).float(),
                outs[1]["pooled"].float())

    token_scale = 0.5 + 0.5 * lora_scale ** 0.4
    uc, puc = encode(mix["negative_prompt"])
    cs, pcs = [], []
    for i in rows:
        c2, p2 = encode(with_tokens(prompts[i], r["name"], r["token_map"]))
        c1, p1 = encode(fix(prompts[i].replace("<concept>", "")))
        cs.append((1 - token_scale) * c1 + token_scale * c2)
        pcs.append((1 - token_scale) * p1 + token_scale * p2)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    draws = [torch.randn(1, h // 8, w // 8, 4, generator=gen, device=device) for _ in range(n)]
    x = torch.cat([draws[i] for i in rows]).permute(0, 3, 1, 2).float()
    k = len(rows)
    ctx = torch.cat([uc.repeat(k, 1, 1), torch.cat(cs)])
    ids = torch.tensor([[1024.0, 1024.0, 0.0, 0.0, h, w]], device=device).repeat(2 * k, 1)
    added = {"text_embeds": torch.cat([puc.repeat(k, 1), torch.cat(pcs)]), "time_ids": ids}

    steps = mix["n_steps"]
    abar = ddpm_alphas_cumprod(device).float()
    t = torch.arange(1000, 0, -1000 / steps, dtype=torch.float32).round().long() - 1
    ac = abar[t.to(device)]
    sigmas = torch.cat([((1 - ac) / ac).sqrt(), torch.zeros(1, device=device)])
    x = x * (sigmas[0] ** 2 + 1).sqrt()
    net = UNet(unet_w, UNetSpec.from_config(config["unet"], config["assumed"]), prec, {}, remat=False)
    with torch.no_grad():
        for i in range(steps):
            s, s_next = sigmas[i], sigmas[i + 1]
            xin = x / (s ** 2 + 1).sqrt()
            eps, _ = net.forward(torch.cat([xin, xin]), t[i].to(device).repeat(2 * k), ctx, added)
            eu, et = eps.float().chunk(2)
            x = x + (s_next - s) * (eu + r["guidance"] * (et - eu))
    return x
