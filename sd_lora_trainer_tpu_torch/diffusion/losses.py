"""Training losses and regularizers (counterpart of diffusion/losses.py).

- `diffusion_loss`: masked MSE with Min-SNR-gamma weighting and mask-mean
  renormalization;
- `prompt_norm_regularization` / `DistributionLossTargets`: prompt-embedding
  norm target and token covariance/std losses;
- `token_attention_loss`: the DAAM cross-attention regularizer in the JAX
  package's streaming form (spatial means as fixed linear functionals of the
  raw scores; only the TI-token maps are resized);
- `stack_attention_maps`: the same scores as resized heatmaps, for the
  DAAM debug plots (diffusion/daam_debug.py);
- `lora_l1_penalty`.

The resizes replay jax.image.resize exactly: "bicubic" is the Keys cubic
kernel (a = -0.5) with antialiasing when downsampling, applied as one weight
matrix per spatial axis; "nearest" samples floor((i + 0.5) * in / out).
All tensors are NHWC.

`group` (parallel training, parallel/sharding.py `Group`): the batch is this
rank's rows of the data group's global batch, and each batch-level
statistic is taken over the global batch (`group.average` of a local mean,
`group.total` of a count), so that the mean over ranks of each rank's loss
is the one-process loss of the global batch, and so are its gradients once
averaged over the ranks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from sd_lora_trainer_tpu_torch.diffusion.schedulers import DDPMSchedule
from sd_lora_trainer_tpu_torch.utils.utils import kept_on_card


def _batch_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean over dim 0 (a global batch's under `group`)."""
    m = x.mean(dim=0)
    return m if group is None else group.average(m)


def _batch_total(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of a gradient-free tensor (the global batch's under `group`)."""
    return x.sum() if group is None else group.total(x.sum())


def diffusion_loss(model_pred, noise, noisy_latent, latent, mask, schedule: DDPMSchedule,
                   timesteps, snr_gamma: float, group=None) -> torch.Tensor:
    """Masked Min-SNR-weighted MSE."""
    if schedule.prediction_type == "epsilon":
        target = noise
    elif schedule.prediction_type == "v_prediction":
        target = schedule.get_velocity(latent, noise, timesteps)
    else:
        raise ValueError(f"Unknown prediction type {schedule.prediction_type}")

    sq_err = (model_pred.float() - target.float()) ** 2 * mask.float()
    per_sample = sq_err.mean(dim=tuple(range(1, sq_err.ndim)))
    if snr_gamma is None or snr_gamma == 0.0:
        weighted = per_sample
    else:
        snr = schedule.compute_snr(timesteps)
        weights = torch.clamp(snr, max=snr_gamma) / snr
        if schedule.prediction_type == "v_prediction":
            weights = weights + 1.0
        weighted = per_sample * (weights / _batch_mean(weights, group))
    mean_mask = mask.float().mean(dim=tuple(range(1, mask.ndim)))
    return (weighted / (mean_mask / _batch_mean(mean_mask, group))).mean()


def lora_l1_penalty(mats) -> torch.Tensor:
    """Normalized L1 of all LoRA matrices: sum|p| / numel.

    |p| is written as where(p >= 0, p, -p) so its gradient at p = 0 is +1, as
    jnp.abs's is in the JAX package (torch's abs gives 0 there). LoRA-B starts
    at exactly 0, so this decides the first updates of every B element whose
    loss gradient is below the penalty's.
    """
    mats = list(mats)
    if not mats:
        return torch.zeros(())
    abs_sum = sum(torch.where(m >= 0, m, -m).float().sum() for m in mats)
    return abs_sum / sum(m.numel() for m in mats)


TARGET_PROMPT_NORM = {"sdxl": 34.5, "sd15": 27.8}


def prompt_norm_regularization(prompt_embeds, target_norm: float, group=None):
    """(loss, observed mean per-token norm) against the pretrained target."""
    cond_norms = _batch_mean(torch.linalg.norm(prompt_embeds.float(), dim=-1), group)
    observed = cond_norms[2:].mean()
    return (observed - target_norm) ** 2, observed


def _covariance(x: torch.Tensor) -> torch.Tensor:
    xc = x - x.mean(dim=0)
    return (xc.T @ xc) / (x.shape[0] - 1)


@dataclasses.dataclass(frozen=True)
class DistributionLossTargets:
    """Statistics of a pretrained token-embedding table."""

    target_cov: torch.Tensor  # [D, D] float32
    target_stds_mean: torch.Tensor  # scalar
    target_stds_var: torch.Tensor  # scalar: std(stds)^2 / mean(stds)

    @classmethod
    def from_embeddings(cls, table: torch.Tensor) -> "DistributionLossTargets":
        table = table.float()
        stds = table.std(dim=-1, correction=0)
        return cls(
            target_cov=_covariance(table),
            target_stds_mean=stds.mean(),
            target_stds_var=stds.std(correction=0) ** 2 / stds.mean(),
        )

    def covariance_loss(self, new_embeddings: torch.Tensor) -> torch.Tensor:
        cov_new = _covariance(new_embeddings.float())
        d = new_embeddings.shape[-1]
        return torch.linalg.norm(self.target_cov - cov_new) / (d * d)

    def std_loss(self, new_embeddings: torch.Tensor) -> torch.Tensor:
        stds = new_embeddings.float().std(dim=-1, correction=0)
        return torch.mean((self.target_stds_mean - stds) ** 2 / self.target_stds_var)


# ---------------------------------------------------------------------------
# DAAM token-attention regularization
# ---------------------------------------------------------------------------


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


@kept_on_card
def _cubic_weight_mat(in_size: int, out_size: int, device) -> torch.Tensor:
    """[in, out] bicubic resize weights, as jax.image compute_weight_mat
    (antialias on, translation 0), in float32; built on the host."""
    inv_scale = 1.0 / torch.tensor(out_size / in_size, dtype=torch.float32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None]).abs()
    w = _keys_cubic(x / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1.0), torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def _resize_bicubic(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """[B, h, w, C] -> [B, H, W, C] as jax.image.resize(..., "bicubic")."""
    wh = _cubic_weight_mat(x.shape[1], out_hw[0], x.device)
    ww = _cubic_weight_mat(x.shape[2], out_hw[1], x.device)
    return torch.einsum("byxc,yi,xj->bijc", x.float(), wh, ww)


def _resize_nearest(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """[B, h, w, C] -> [B, H, W, C] as jax.image.resize(..., "nearest")."""
    for axis, n in ((1, out_hw[0]), (2, out_hw[1])):
        m = x.shape[axis]
        if m == n:
            continue
        x = x.index_select(axis, _nearest_rows(m, n, x.device))
    return x


@kept_on_card
def _nearest_rows(m: int, n: int, device) -> torch.Tensor:
    """The source row of each of n output rows of a nearest resize from m."""
    return torch.floor((torch.arange(n, dtype=torch.float32) + 0.5) * m / n).long().to(device)


def _map_hw(name: str, q_len: int, img_ratio: float) -> Tuple[int, int]:
    """(height, width) of an attention map of q_len pixels; img_ratio = width / height."""
    width = round(math.sqrt(q_len * img_ratio))
    height = round(width / img_ratio)
    if height * width != q_len:
        raise ValueError(f"attention map {name}: q_len={q_len} does not factor as "
                         f"{height}x{width} for img_ratio={img_ratio}")
    return height, width


def stack_attention_maps(attn_scores: Dict[str, torch.Tensor], img_ratio: float) -> torch.Tensor:
    """Per-layer DAAM scores (name -> [B, q_len, 77]) as spatial heatmaps at
    the smallest layer's resolution, stacked in name order: [L, B, h, w, 77].
    The larger maps are resized bicubic, as jax.image.resize does."""
    names = sorted(attn_scores)
    maps = []
    for name in names:
        score = attn_scores[name]
        b, q_len, n_text = score.shape
        maps.append(score.reshape(b, *_map_hw(name, q_len, img_ratio), n_text))
    h, w = min((m.shape[1:3] for m in maps), key=lambda s: s[0] * s[1])
    return torch.stack([m if m.shape[1:3] == (h, w) else _resize_bicubic(m, (h, w)).to(m.dtype)
                        for m in maps])


def _resized_spatial_mean_weights(height: int, width: int, min_shape: Tuple[int, int],
                                  device) -> torch.Tensor:
    """w with <w, x.ravel()> == mean over pixels of bicubic_resize(x, min_shape)."""
    p = min_shape[0] * min_shape[1]
    if (height, width) == tuple(min_shape):
        return torch.full((height * width,), 1.0 / p, dtype=torch.float32, device=device)
    rh = _cubic_weight_mat(height, min_shape[0], device).sum(dim=1)
    rw = _cubic_weight_mat(width, min_shape[1], device).sum(dim=1)
    return (rh[:, None] * rw[None, :]).reshape(-1) / p


def token_attention_loss(
    attn_scores: Dict[str, torch.Tensor],  # name -> [B, q_len, 77] fp32 scores
    mask: torch.Tensor,  # [B, H, W, 1] latent-res mask
    img_ratio: float,
    caption_token_lengths: torch.Tensor,  # [B] int
    ti_token_positions: torch.Tensor,  # [B, n_ti] int, -1 if absent
    group=None,
) -> torch.Tensor:
    """DAAM cross-attention regularizer: (0) mean attention of the caption's
    content tokens, (1) TI-token attention inside the mask, (2) TI-token
    attention outside the mask (+10 offset), (3) variance of the mean
    attention across TI tokens. Samples that lost their TI tokens are masked
    out; with none left the loss is 0."""
    names = sorted(attn_scores.keys())
    first = attn_scores[names[0]]
    batch, _, n_text = first.shape
    device = first.device
    n_layers = len(names)
    n_ti = ti_token_positions.shape[1]
    valid = (ti_token_positions >= 0).all(dim=1)
    safe_pos = ti_token_positions.long().clamp(0, n_text - 1)

    shapes = [_map_hw(name, attn_scores[name].shape[1], img_ratio) for name in names]
    min_shape = min(shapes, key=lambda s: s[0] * s[1])
    h, w = min_shape

    mean_acc = torch.zeros(batch, n_text, dtype=torch.float32, device=device)
    ti_acc = torch.zeros(batch, h, w, n_ti, dtype=torch.float32, device=device)
    for name, (hl, wl) in zip(names, shapes):
        score = attn_scores[name]
        wvec = _resized_spatial_mean_weights(hl, wl, min_shape, device)
        mean_acc = mean_acc + torch.einsum("bqt,q->bt", score, wvec)
        g = torch.gather(score, 2, safe_pos[:, None, :].expand(-1, score.shape[1], -1))
        g = g.reshape(batch, hl, wl, n_ti)
        if (hl, wl) != min_shape:
            g = _resize_bicubic(g, min_shape)
        ti_acc = ti_acc + g

    mask2 = _resize_nearest(mask.float(), min_shape)[..., 0]  # [B, h, w]

    pos = torch.arange(n_text, device=device)[None, :]
    content = (pos >= 1) & (pos < (caption_token_lengths[:, None] - 1))
    relu_sq = torch.relu(mean_acc / n_layers) ** 2
    denom = torch.clamp(content.sum(dim=1), min=1)
    att_l2_per_sample = (relu_sq * content).sum(dim=1) / denom

    ti_heatmaps = (ti_acc / n_layers).permute(0, 3, 1, 2)  # [B, n_ti, h, w]
    ti_masks = mask2[:, None, :, :].expand_as(ti_heatmaps)
    valid_f = valid.float()
    # this rank's share of the global count: the terms normalized by it are
    # sums over the rows, and the ranks' losses are averaged
    n_ranks = 1 if group is None else group.size
    valid_total = _batch_total(valid_f, group)
    n_valid = torch.clamp(valid_total, min=1.0) / n_ranks
    vmask = valid_f[:, None, None, None]
    token_att_var = ti_heatmaps.mean(dim=(2, 3)).var(dim=1, correction=1)

    norm = n_valid * n_ti * h * w
    reg_loss_0 = 5.0 * att_l2_per_sample.mean()
    reg_loss_1 = 1.0 * ((torch.relu(ti_heatmaps * ti_masks) ** 2) * vmask).sum() / norm
    reg_loss_2 = 2.0 * ((torch.relu(ti_heatmaps * (1.0 - ti_masks) + 10.0) ** 2) * vmask).sum() / norm
    reg_loss_3 = 1.0 * (token_att_var * valid_f).sum() / n_valid
    total = reg_loss_0 + reg_loss_1 + reg_loss_2 + reg_loss_3
    return torch.where(valid_total > 0, total, torch.zeros_like(total))
