"""The reference training step of the LoRA + textual-inversion recipes,
written from the trainer's published loss and optimizer (the JAX
package's, read as a description): VAE-latent sampling, DDPM noising with
an offset noise, the UNet's epsilon prediction through rank-r LoRA, the
Min-SNR-gamma masked MSE, the DAAM token-attention regularizer, the L1 of
the adapters and the TI rows' std regularizer, then AdamW with decoupled
weight decay per group at the recipe's schedules.

`Trainer(config, recipe, inputs, prec).steps(batches, seed)` follows the
program's first steps on the same inputs and the same random draws (a
`torch.Generator` on the device seeded as the program's, drawn in the same
order and dtypes) and returns what the check compares. Nothing here
imports the program under test.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from perfbench.reference.clip import ClipSpec, clip_text
from perfbench.reference.nn import Prec
from perfbench.reference.unet import UNet, UNetSpec

_BOUNDARY = ("conv_in", "conv_out")


def _map(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn, path + (str(i),)) for i, v in enumerate(tree)]
    return fn(path, tree)


def int8_rowwise(w: torch.Tensor) -> torch.Tensor:
    """The int8 base's weight: per-output-channel symmetric codes,
    round(w / s) with s = amax / 127 (1 where a row is all zero), as float32
    codes times scales."""
    wf = w.float()
    amax = wf.abs().amax(dim=tuple(range(1, w.ndim)), keepdim=True)
    s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.round(wf / s) * s


def unet_weights(tree: dict, prec: Prec, int8: bool) -> dict:
    """The UNet's weights in the compute dtype; with an int8 base every
    2-D and 4-D kernel but the boundary convs is quantized first."""

    def conv_leaf(path, t):
        if (int8 and path[-1] == "weight" and t.ndim in (2, 4) and path[-2] not in _BOUNDARY
                and t.device.type != "meta"):
            t = int8_rowwise(t)
        return t.to(prec.dt)

    return _map(tree, conv_leaf)


def ddpm_alphas_cumprod(device) -> torch.Tensor:
    """Scaled-linear betas (0.00085 to 0.012 over 1000 steps), cumulative
    product of 1 - beta, computed in float64."""
    betas = torch.linspace(0.00085 ** 0.5, 0.012 ** 0.5, 1000, dtype=torch.float64) ** 2
    return torch.cumprod(1.0 - betas, dim=0).to(device)


def keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel at a = -0.5."""
    x = x.abs()
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return torch.where(x >= 2.0, torch.zeros_like(x), torch.where(x >= 1.0, far, near))


def cubic_resize_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] weights of an antialiased bicubic resize (the scheme of
    jax.image.resize: the kernel widened by the downscale factor, each
    output's weights normalized, outputs outside the input zeroed)."""
    inv = n_in / n_out
    widen = max(inv, 1.0)
    centers = (torch.arange(n_out, dtype=torch.float64) + 0.5) * inv - 0.5
    x = (centers[None, :] - torch.arange(n_in, dtype=torch.float64)[:, None]) / widen
    w = keys_cubic(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * 1.1920929e-07, w / torch.where(total != 0, total, 1.0),
                    torch.zeros_like(w))
    inside = (centers >= -0.5) & (centers <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).float().to(device)


def map_shape(q_len: int, ratio: float):
    width = round(math.sqrt(q_len * ratio))
    height = round(width / ratio)
    if height * width != q_len:
        raise ValueError(f"{q_len} pixels do not factor at width/height {ratio}")
    return height, width


def token_attention_loss(scores: Dict[str, torch.Tensor], mask: torch.Tensor, ratio: float,
                         lengths: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """The DAAM regularizer: every captured layer's map [B, h, w, 77]
    resized (bicubic) to the smallest layer's size and averaged over the
    layers; then 5 x the mean square of the content tokens' mean attention,
    the TI maps' square inside the (nearest-resized) mask, 2 x their square
    outside it offset by 10, and the variance across TI tokens of their mean
    attention, the last three over the samples that hold every TI token."""
    names = sorted(scores)
    b = scores[names[0]].shape[0]
    shapes = [map_shape(scores[n].shape[1], ratio) for n in names]
    h, w = min(shapes, key=lambda s: s[0] * s[1])
    maps = []
    for name, (hl, wl) in zip(names, shapes):
        m = scores[name].float().reshape(b, hl, wl, -1)
        if (hl, wl) != (h, w):
            m = torch.einsum("byxc,yi,xj->bijc", m, cubic_resize_matrix(hl, h, m.device),
                             cubic_resize_matrix(wl, w, m.device))
        maps.append(m)
    heat = torch.stack(maps).mean(dim=0)  # [B, h, w, 77]
    n_text = heat.shape[-1]
    rows = torch.floor((torch.arange(h, dtype=torch.float64) + 0.5) * mask.shape[1] / h).long()
    cols = torch.floor((torch.arange(w, dtype=torch.float64) + 0.5) * mask.shape[2] / w).long()
    m2 = mask.float()[:, rows.to(mask.device)][:, :, cols.to(mask.device), 0]  # [B, h, w]

    pos = torch.arange(n_text, device=heat.device)[None, :]
    content = ((pos >= 1) & (pos < lengths[:, None] - 1)).float()
    mean_att = heat.mean(dim=(1, 2))
    per_sample = (torch.relu(mean_att) ** 2 * content).sum(dim=1) / content.sum(dim=1).clamp(min=1)
    term0 = 5.0 * per_sample.mean()

    valid = (positions >= 0).all(dim=1).float()
    n_valid = valid.sum().clamp(min=1.0)
    idx = positions.long().clamp(0, n_text - 1)
    ti = torch.stack([heat[i, :, :, idx[i]] for i in range(b)]).permute(0, 3, 1, 2)  # [B, n, h, w]
    n_ti = ti.shape[1]
    vm = valid[:, None, None, None]
    norm = n_valid * n_ti * h * w
    term1 = (torch.relu(ti * m2[:, None]) ** 2 * vm).sum() / norm
    term2 = 2.0 * (torch.relu(ti * (1.0 - m2[:, None]) + 10.0) ** 2 * vm).sum() / norm
    term3 = (ti.mean(dim=(2, 3)).var(dim=1, correction=1) * valid).sum() / n_valid
    total = term0 + term1 + term2 + term3
    if total.device.type == "meta":
        return total
    return total if bool(valid.sum() > 0) else total * 0.0


class Trainer:
    """The reference's LoRA + TI training at one precision."""

    def __init__(self, config: dict, recipe: dict, inputs: dict, prec: Prec, device,
                 remat: bool = True):
        self.cfg, self.r, self.prec, self.device = config, recipe, prec, device
        self.sdxl = inputs["te2"] is not None
        self.unet = unet_weights(inputs["unet"], prec, recipe["int8_base"])
        self.te = [_map(inputs[k], lambda _, t: t.to(prec.dt)) if inputs[k] is not None else None
                   for k in ("te1", "te2")]
        self.tables = [inputs[k]["text_model"]["embeddings"]["token_embedding"]["weight"]
                       if inputs[k] is not None else None for k in ("te1", "te2")]
        self.unet_spec = UNetSpec.from_config(config["unet"], config["assumed"])
        self.clip_specs = [ClipSpec.from_config(config["text_encoder"]),
                           ClipSpec.from_config(config["text_encoder_2"]) if self.sdxl else None]
        self.remat = remat
        rank = recipe["lora_rank"]
        self.scale = recipe["lora_rank"] * recipe["lora_alpha_multiplier"] / rank
        # the trainables, float32 leaves: unet.<site>.a / .b, ti.te1, ti.te2
        self.params: Dict[str, torch.Tensor] = {}
        for site, a in sorted(inputs["lora_a"].items()):
            shape = inputs["lora_shapes"][site]
            self.params[f"unet.{site}.a"] = a.detach().clone().float().requires_grad_()
            b_shape = (shape[0], rank) + (1,) * (len(shape) - 2)
            self.params[f"unet.{site}.b"] = torch.zeros(b_shape, device=a.device).requires_grad_()
        for which, rows in inputs["ti"].items():
            self.params[f"ti.{which}"] = rows.detach().clone().float().requires_grad_()
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.abar = ddpm_alphas_cumprod(device)
        self.std_targets = {}
        for i, table in enumerate(self.tables):
            if table is None:
                continue
            stds = table.float().std(dim=-1, correction=0)
            if table.device.type == "meta":
                self.std_targets[f"te{i + 1}"] = (stds.mean(), stds.mean())
                continue
            self.std_targets[f"te{i + 1}"] = (stds.mean(), stds.std(correction=0) ** 2 / stds.mean())
        if recipe["cond_reg_w"] or recipe["tok_cov_reg_w"]:
            raise NotImplementedError("the prompt-norm and covariance regularizers are not "
                                      "in the reference (both recipes leave them at 0)")

    # --- the step's draws, as the program makes them ---

    def draws(self, gen: torch.Generator, shape) -> dict:
        b, h, w, c = shape
        d = {"latent_eps": torch.randn(shape, generator=gen, dtype=torch.float32, device=self.device),
             "noise": torch.randn(shape, generator=gen, dtype=torch.bfloat16, device=self.device)}
        if self.r["noise_offset"] > 0:
            d["offset_noise"] = torch.randn((b, 1, 1, c), generator=gen, dtype=torch.bfloat16,
                                            device=self.device)
        d["timesteps"] = torch.randint(0, 1000, (b,), generator=gen, device=self.device)
        return d

    def loras(self) -> Dict[str, dict]:
        return {k[len("unet."):-2]: {"a": self.params[k], "b": self.params[k[:-2] + ".b"],
                                     "scale": self.scale}
                for k in self.params if k.startswith("unet.") and k.endswith(".a")}

    def loss(self, batch: dict, draws: dict, step: int):
        r, prec = self.r, self.prec
        mean, logvar = batch["latent_mean"].float(), batch["latent_logvar"].float()
        latent = (mean + torch.exp(0.5 * logvar) * draws["latent_eps"]) * batch["latent_scale"].float()
        ti = {k[3:]: v for k, v in self.params.items() if k.startswith("ti.")}
        o1 = clip_text(self.te[0], batch["input_ids"], self.clip_specs[0], prec, ti.get("te1"))
        added = None
        if self.sdxl:
            o2 = clip_text(self.te[1], batch["input_ids_2"], self.clip_specs[1], prec, ti.get("te2"))
            ctx = torch.cat([o1["penultimate"], o2["penultimate"]], dim=-1)
            w, h = r["train_img_size"]
            ids = torch.tensor([1024.0, 1024.0, 0.0, 0.0, h, w], device=self.device)
            added = {"text_embeds": o2["pooled"], "time_ids": ids.repeat(mean.shape[0], 1)}
        else:
            ctx = o1["last"]
        noise = draws["noise"].float()
        if r["noise_offset"] > 0:
            noise = noise + r["noise_offset"] * draws["offset_noise"].float()
        t = draws["timesteps"]
        ab = self.abar[t].float()[:, None, None, None]
        noisy = ab.sqrt() * latent + (1.0 - ab).sqrt() * noise
        capture = r["train_ti"] and r["token_attention_loss_w"] > 0
        net = UNet(self.unet, self.unet_spec, prec, self.loras(), remat=self.remat)
        pred, scores = net.forward(noisy.permute(0, 3, 1, 2), t, ctx, added, capture)
        pred = pred.float().permute(0, 2, 3, 1)
        mask = batch["mask"].float()
        per_sample = ((pred - noise) ** 2 * mask).mean(dim=(1, 2, 3))
        snr = (ab / (1.0 - ab)).reshape(-1)
        weights = torch.clamp(snr, max=r["snr_gamma"]) / snr
        mean_mask = mask.mean(dim=(1, 2, 3))
        img = (per_sample * weights / weights.mean() / (mean_mask / mean_mask.mean())).mean()
        aux = {"img_loss": img}
        loss = img
        if capture:
            att = token_attention_loss(scores, mask, r["daam_img_ratio"],
                                       batch["caption_token_lengths"], batch["ti_token_positions"])
            loss = loss + r["token_attention_loss_w"] * att
            aux["token_attention_loss"] = att
        if r["l1_penalty"] > 0:
            # |p| as where(p >= 0, p, -p): the gradient at 0 is +1, as the
            # trainer defines it (B starts at 0)
            mats = [v for k, v in self.params.items() if k.startswith("unet.")]
            l1 = sum(torch.where(m >= 0, m, -m).sum() for m in mats) / sum(m.numel() for m in mats)
            loss = loss + r["l1_penalty"] * l1
        if r["train_ti"] and r["std_loss_w"] > 0 and ti:
            active = 1.0 if step / r["max_train_steps"] <= r["freeze_ti_after_completion_f"] else 0.0
            terms = []
            for which, rows in ti.items():
                target_mean, target_var = self.std_targets[which]
                terms.append(((target_mean - rows.std(dim=-1, correction=0)) ** 2 / target_var).mean())
            loss = loss + active * r["std_loss_w"] * torch.stack(terms).mean()
        aux["tot_loss"] = loss
        return loss, aux

    # --- the update ---

    def lrs(self, n: int) -> Dict[str, float]:
        r = self.r
        f = min(n / r["max_train_steps"], 1.0)
        base = r["unet_lr_base"]
        warm = max(r["unet_lr_warmup_steps"], 1)
        unet = 0.0 if f < r["freeze_unet_before_completion_f"] else base * (r["unet_lr"] / base) ** (n / warm)
        ti = 0.0 if f > r["freeze_ti_after_completion_f"] else r["ti_lr"] * (1.0 - f) ** 1.7
        return {"unet": unet, "ti": ti}

    @torch.no_grad()
    def adamw(self, grads: Dict[str, torch.Tensor], n: int) -> None:
        b1, b2, eps = 0.9, 0.999, 1e-8
        lrs = self.lrs(n)
        bc1, bc2 = 1.0 - b1 ** (n + 1), 1.0 - b2 ** (n + 1)
        for k, p in self.params.items():
            group = k.split(".")[0]
            lr = lrs[group]
            wd = self.r["lora_weight_decay"] if group == "unet" else self.r["ti_weight_decay"]
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            update = (self.m[k] / bc1) / ((self.v[k] / bc2).sqrt() + eps) + wd * p
            p.sub_(lr * update)

    def steps(self, batches: List[dict], seed_draws: int) -> dict:
        """Follow the program's first len(batches) steps; return each step's
        loss, the first two steps' gradients, the trainables before, after
        the first step and after the last, and each step's batch and draws
        ("fed", for `step_at`)."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed_draws))
        out = {"losses": [], "grads": [], "fed": [],
               "p0": {k: v.detach().clone() for k, v in self.params.items()}}
        for n, batch in enumerate(batches):
            batch = {k: v.to(self.device) for k, v in batch.items()}
            d = self.draws(gen, tuple(batch["latent_mean"].shape))
            out["fed"].append((batch, d))
            loss, grads = self._grads(batch, d, n)
            out["losses"].append(float(loss.detach()))
            if n < 2:
                out["grads"].append({k: g.detach().clone() for k, g in grads.items()})
            self.adamw(grads, n)
            if n == 0:
                out["p1"] = {k: v.detach().clone() for k, v in self.params.items()}
        out["p_end"] = {k: v.detach().clone() for k, v in self.params.items()}
        return out

    def _grads(self, batch: dict, draws: dict, n: int):
        names = list(self.params)
        loss, _ = self.loss(batch, draws, n)
        grads = torch.autograd.grad(loss, [self.params[k] for k in names], allow_unused=True)
        return loss, {k: (g if g is not None else torch.zeros_like(self.params[k]))
                      for k, g in zip(names, grads)}

    def step_at(self, params: Dict[str, torch.Tensor], fed, n: int) -> dict:
        """Step n's loss and gradient (0-based) at the given trainables,
        with that step's (batch, draws)."""
        own = self.params
        self.params = {k: params[k].detach().float().clone().requires_grad_() for k in own}
        try:
            loss, grads = self._grads(fed[0], fed[1], n)
        finally:
            self.params = own
        return {"loss": float(loss.detach()), "grads": {k: g.detach() for k, g in grads.items()}}
