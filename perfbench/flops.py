"""Model FLOPs of one image, counted on the benchmark's own reference:
`FlopCounterMode` over a batch of one on the meta device, no recompute and
no blocks, so that every operation of the model counts once whatever
implements the step (the convention of the program's bench,
sd_lora_trainer_tpu_torch/utils/profiling.py `count_step_flops` at commit
7d8db9e: the conditioning and the UNet, forward and backward, remat off;
the optimizer's update not counted)."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import inputs as inp
from perfbench.reference.nn import Prec
from perfbench.reference.train import Trainer


def _meta_batch(config: dict, mix: dict) -> dict:
    w, h = mix["resolution"]
    m = "meta"
    return {"latent_mean": torch.empty(1, h // 8, w // 8, 4, device=m),
            "latent_logvar": torch.empty(1, h // 8, w // 8, 4, device=m),
            "mask": torch.empty(1, h // 8, w // 8, 1, device=m),
            "input_ids": torch.zeros(1, 77, dtype=torch.long, device=m),
            "input_ids_2": torch.zeros(1, 77, dtype=torch.long, device=m),
            "caption_token_lengths": torch.zeros(1, dtype=torch.long, device=m),
            "ti_token_positions": torch.zeros(1, 3, dtype=torch.long, device=m),
            "latent_scale": torch.empty((), device=m)}


def train_flops_per_image(config: dict, mix: dict) -> int:
    """Forward and backward of one training image: conditioning, UNet,
    losses."""
    w, h = mix["resolution"]
    r = dict(mix["reference_recipe"], train_img_size=[w, h], daam_img_ratio=w / h)
    data = inp.make_inputs(config, 0, "meta", rank=r["lora_rank"], n_tokens=r["n_tokens"])
    trainer = Trainer(config, r, data, Prec("bf16", plain=True), "meta", remat=False)
    batch = _meta_batch(config, mix)
    draws = {"latent_eps": torch.empty(1, h // 8, w // 8, 4, device="meta"),
             "noise": torch.empty(1, h // 8, w // 8, 4, device="meta"),
             "offset_noise": torch.empty(1, 1, 1, 4, device="meta"),
             "timesteps": torch.zeros(1, dtype=torch.long, device="meta")}
    params = list(trainer.params.values())
    with FlopCounterMode(display=False) as counter:
        loss, _ = trainer.loss(batch, draws, 0)
        torch.autograd.grad(loss, params, allow_unused=True)
    return int(counter.get_total_flops())


def render_flops_per_image(config: dict, mix: dict) -> int:
    """One rendered image: its two prompts' encodes (with and without the
    trained tokens) and its share of the negative prompt's, 2 x n_steps
    UNet forwards (classifier-free guidance) and the VAE decode."""
    from perfbench.reference import vae as ref_vae
    from perfbench.reference.clip import ClipSpec, clip_text
    from perfbench.reference.unet import UNet, UNetSpec

    w, h = mix["resolution"]
    m = "meta"
    prec = Prec("bf16", plain=True)
    data = inp.make_inputs(config, 0, m, vae=True)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        ids = torch.zeros(1, 77, dtype=torch.long, device=m)
        for te, key in ((data["te1"], "text_encoder"), (data["te2"], "text_encoder_2")):
            clip_text(te, ids, ClipSpec.from_config(config[key]), prec, data["ti"]["te1"]
                      if key == "text_encoder" else data["ti"]["te2"])
    encode = counter.get_total_flops()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        net = UNet(data["unet"], UNetSpec.from_config(config["unet"], config["assumed"]), prec, {},
                   remat=False)
        added = {"text_embeds": torch.empty(1, 1280, device=m), "time_ids": torch.empty(1, 6, device=m)}
        net.forward(torch.empty(1, 4, h // 8, w // 8, device=m), torch.zeros(1, dtype=torch.long, device=m),
                    torch.empty(1, 77, config["unet"]["cross_attention_dim"], device=m), added)
    unet = counter.get_total_flops()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        ref_vae.decode(data["vae"], torch.empty(1, 4, h // 8, w // 8, device=m), config["vae"], prec)
    decode = counter.get_total_flops()
    n = mix["n_imgs"]
    return int(encode * (2 + 1 / n) + 2 * mix["n_steps"] * unet + decode)
