"""Textual-inversion token warmup (text-only pre-optimization).

Counterpart of sd_lora_trainer_tpu/training/token_warmup.py. Before image
training, the new token rows are optimized so that encoding the token
string ("<s0><s1><s2>") lands near the encoding of the concept description,
with text-encoder forwards only:

    loss = 0.2 * [ mse(c, c*) + (1 - cos(c, c*))
                   + 0.25 * (mse(pooled, pooled*) + (1 - cos(pooled, pooled*))) ]
           + 0.5 * token std regularizer + tok_cov_reg_w * covariance regularizer

c is SDXL's two penultimate states side by side (SD1.5: CLIP-L's last),
pooled is TE2's (SDXL only). The targets are encoded once, without the TI
rows, in float32. The rows train under AdamW at ti_lr / ti_weight_decay
(optax's adamw: b1 0.9, b2 0.999, eps 1e-8, decoupled decay). As in the JAX
package, the history holds the last step's terms only.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from sd_lora_trainer_tpu_torch.diffusion.losses import DistributionLossTargets
from sd_lora_trainer_tpu_torch.models.clip import CLIPTextConfig, clip_text_forward


def _embed_cosine_losses(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    pred, target = pred.float(), target.float()
    mse = torch.mean((pred - target) ** 2)
    cos = torch.sum(pred * target, dim=-1) / (
        torch.linalg.norm(pred, dim=-1) * torch.linalg.norm(target, dim=-1) + 1e-8)
    return mse + (1.0 - cos.mean())


def warmup_token_embeddings(
    ti_rows: Dict[str, torch.Tensor],  # {"te1": rows, "te2": rows?}
    te_params: Dict[str, dict],
    te_configs: Dict[str, CLIPTextConfig],
    version: str,
    token_ids: Dict[str, torch.Tensor],  # [1, 77] tokenized "<s0><s1><s2>"
    target_ids: Dict[str, torch.Tensor],  # [1, 77] tokenized concept description
    distribution_targets: Dict[str, DistributionLossTargets],
    steps: int,
    ti_lr: float,
    ti_weight_decay: float = 0.0,
    tok_cov_reg_w: float = 0.0,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, list]]:
    """Returns (warmed rows, new leaf tensors that require grad; history)."""
    if steps <= 0:
        return ti_rows, {}

    def conditioning(rows, ids, use_ti: bool):
        outs = {which: clip_text_forward(te_params[which], ids[which], te_configs[which],
                                         ti_embeddings=rows.get(which) if use_ti else None,
                                         dtype=torch.float32)
                for which in te_params}
        if version == "sdxl":
            c = torch.cat([outs["te1"]["penultimate"], outs["te2"]["penultimate"]], -1)
            return c, outs["te2"]["pooled"]
        return outs["te1"]["last"], None

    with torch.no_grad():
        target_c, target_pooled = conditioning(ti_rows, target_ids, use_ti=False)

    rows = {w: r.detach().clone().requires_grad_() for w, r in ti_rows.items()}
    optimizer = torch.optim.AdamW(list(rows.values()), lr=ti_lr, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=ti_weight_decay)

    def loss_fn():
        c, pooled = conditioning(rows, token_ids, use_ti=True)
        loss = _embed_cosine_losses(c, target_c)
        if pooled is not None and target_pooled is not None:
            loss = loss + 0.25 * _embed_cosine_losses(pooled, target_pooled)
        loss = 0.2 * loss
        aux = {"concept_description_loss": loss}
        std_losses = [distribution_targets[w].std_loss(r) for w, r in rows.items()
                      if w in distribution_targets]
        if std_losses:
            stdl = torch.mean(torch.stack(std_losses))
            loss = loss + 0.5 * stdl
            aux["token_std_loss"] = stdl
        if tok_cov_reg_w > 0.0:
            cov_losses = [distribution_targets[w].covariance_loss(r) for w, r in rows.items()
                          if w in distribution_targets]
            if cov_losses:
                cov = torch.mean(torch.stack(cov_losses))
                loss = loss + tok_cov_reg_w * cov
                aux["covariance_tok_reg_loss"] = cov
        return loss, aux

    with torch.enable_grad():
        for _ in range(steps):
            optimizer.zero_grad(set_to_none=True)
            loss, aux = loss_fn()
            loss.backward()
            optimizer.step()
    for r in rows.values():
        r.grad = None
    history: Dict[str, list] = {}
    for k, v in aux.items():
        history.setdefault(k, []).append(float(v.detach()))
    return rows, history
