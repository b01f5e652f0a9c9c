"""DAAM attention-heatmap debug plots (counterpart of sd_lora_trainer_tpu/diffusion/daam_debug.py).

Renders the TI tokens' spatial attention maps, averaged over layers, beside
the training mask: the visual check that the token-attention regularizer
keeps the concept tokens inside the masked region. Without matplotlib (the
card's machine has none) it writes nothing and returns "", as
utils/plots.py does.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from sd_lora_trainer_tpu_torch.diffusion.losses import stack_attention_maps
from sd_lora_trainer_tpu_torch.utils.plots import _plt


def plot_token_attention_maps(
    output_dir: str,
    attn_scores: Dict[str, torch.Tensor],  # name -> [B, q_len, 77]
    masks: np.ndarray,  # [B, H, W, 1]
    ti_token_positions: np.ndarray,  # [B, n_ti]
    img_ratio: float,
    global_step: int,
) -> str:
    """Write daam/token_attention_{step}.png under output_dir; returns its path."""
    plt = _plt()
    if plt is None:
        return ""
    with torch.no_grad():
        scores = {k: torch.as_tensor(v).float() for k, v in attn_scores.items()}
        maps = stack_attention_maps(scores, img_ratio).mean(dim=0).cpu().numpy()  # [B, h, w, 77]
    masks = np.asarray(masks)
    ti_token_positions = np.asarray(ti_token_positions)
    batch, n_ti = maps.shape[0], ti_token_positions.shape[1]

    fig, axes = plt.subplots(batch, n_ti + 1, figsize=(3 * (n_ti + 1), 3 * batch), squeeze=False)
    for b in range(batch):
        axes[b][0].imshow(masks[b, :, :, 0], cmap="gray")
        axes[b][0].set_title("mask", fontsize=8)
        axes[b][0].axis("off")
        for t in range(n_ti):
            pos = int(ti_token_positions[b, t])
            axes[b][t + 1].imshow(maps[b, :, :, max(pos, 0)], cmap="viridis")
            axes[b][t + 1].set_title(f"<s{t}> @ {pos}", fontsize=8)
            axes[b][t + 1].axis("off")
    os.makedirs(os.path.join(output_dir, "daam"), exist_ok=True)
    out = os.path.join(output_dir, "daam", f"token_attention_{global_step:05d}.png")
    fig.tight_layout()
    fig.savefig(out, dpi=80)
    plt.close(fig)
    return out
