"""The training step (counterpart of sd_lora_trainer_tpu/training/step.py).

One step: CLIP-L + OpenCLIP-bigG conditioning with trainable TI rows, DDPM
add_noise, the UNet forward and backward through LoRA (flash self-attention
on the card, DAAM scores from cross-attention), the Min-SNR masked MSE, the
token-attention loss, the L1 penalty and the TI regularizers, then one optimizer
update per group.

- trainable tree: {"unet": lora tree, "ti": {"te1": rows, "te2": rows},
  "te_lora": {"te1": tree, "te2": tree}} (groups optional); its tensors are
  leaves that require grad and the optimizer updates them in place;
- random draws: `jax.random` streams cannot be replayed in torch, so
  `compute_loss` takes latent_eps, noise, offset_noise and timesteps as
  optional explicit tensors and draws the missing ones from a
  `torch.Generator`;
- gradient accumulation: batch tensors carry a leading [accum] dim; the
  gradients and aux terms are averaged over the micro-batches;
- parallel training (`StepConfig.parallel`, parallel/sharding.py): the step
  takes the global batch and keeps this rank's rows; every rank draws the
  global batch's noise from the same generator and keeps its rows, so the
  streams are those of one process; the losses' batch-level statistics are
  the data group's; the gradients are synced before the update.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from sd_lora_trainer_tpu_torch.config import TrainingConfig
from sd_lora_trainer_tpu_torch.diffusion.losses import (
    TARGET_PROMPT_NORM,
    DistributionLossTargets,
    diffusion_loss,
    lora_l1_penalty,
    prompt_norm_regularization,
    token_attention_loss,
)
from sd_lora_trainer_tpu_torch.diffusion.schedulers import DDPMSchedule
from sd_lora_trainer_tpu_torch.models.clip import CLIPTextConfig
from sd_lora_trainer_tpu_torch.models.conditioning import sd15_conditioning, sdxl_conditioning
from sd_lora_trainer_tpu_torch.models.lora import inject_lora, iter_lora_leaves
from sd_lora_trainer_tpu_torch.models.unet import UNetConfig, unet_forward
from sd_lora_trainer_tpu_torch.parallel.distributed import local_rows
from sd_lora_trainer_tpu_torch.training.optimizers import GroupOptimizer, group_tensors


@dataclasses.dataclass
class FrozenModels:
    """The non-trainable models and tables of a run."""

    unet_params: Any
    te1_params: Any
    te2_params: Any  # None for sd15
    schedule: DDPMSchedule
    distribution_targets: Dict[str, DistributionLossTargets]  # "te1"/"te2"
    unet_config: UNetConfig
    te1_config: CLIPTextConfig
    te2_config: Optional[CLIPTextConfig]
    version: str  # "sd15" | "sdxl"
    resolution: Tuple[int, int]  # (W, H)


@dataclasses.dataclass
class TrainState:
    """Trainable tensors (updated in place), their optimizer, the step count
    and the generator of the step's random draws."""

    step: int
    trainable: dict
    optimizer: GroupOptimizer
    generator: torch.Generator


@dataclasses.dataclass(frozen=True)
class StepConfig:
    snr_gamma: float
    noise_offset: float
    l1_penalty: float
    token_attention_loss_w: float
    cond_reg_w: float
    tok_cov_reg_w: float
    std_loss_w: float  # the reference hardcodes 0.01
    grad_accum: int
    is_lora: bool
    train_ti: bool
    use_flash: bool
    remat: Union[bool, str]  # False | True | a plan of models/unet.py
    max_train_steps: int
    ti_freeze_f: float
    ti_lr: float
    daam_img_ratio: float
    # names whose remat stash is row-wise int8 (ops/stash8.py); "" = none
    stash8: str = ""
    # recompute the text-encoder conditioning in the backward, nothing kept:
    # set by quantize_base "int8+te", whose dequantized TE weights would
    # otherwise stay alive from forward to backward
    remat_te: bool = False
    # the mesh a multi-process step runs under (parallel/sharding.py
    # ParallelPlan); None on one process
    parallel: Any = None

    @classmethod
    def from_config(cls, config: TrainingConfig, img_ratio: float) -> "StepConfig":
        remat = config.remat
        quantize_base = config.resolve_quantize_base()
        if remat == "auto":
            # the JAX package's plans, resolved here so every consumer gets a
            # concrete one: SD1.5 at <= 512px keeps all activations; an int8
            # base pays for "light" (plain resnet layers keep theirs) with the
            # flash residuals kept; a bf16 base recomputes every layer but the
            # flash residuals. They rest on TPU measurements; an H100 choice
            # waits for the port's benchmark.
            sizes = config.train_img_size
            if not sizes:
                r = config.resolution
                sizes = r if isinstance(r, (list, tuple)) else (r, r)
            if (config.sd_model_version == "sd15" and max(sizes) <= 512
                    and config.train_batch_size <= 16):
                remat = False
            elif quantize_base in ("int8", "int8+te"):
                remat = "light+save:flash_out*,flash_lse*"
            else:
                remat = "save:flash_out*,flash_lse*"
        return cls(
            snr_gamma=config.snr_gamma,
            noise_offset=config.noise_offset,
            l1_penalty=config.l1_penalty,
            token_attention_loss_w=config.token_attention_loss_w,
            cond_reg_w=config.cond_reg_w,
            tok_cov_reg_w=config.tok_cov_reg_w,
            std_loss_w=0.01,
            grad_accum=config.gradient_accumulation_steps,
            is_lora=config.is_lora,
            train_ti=not config.disable_ti,
            use_flash=True,
            remat=remat,
            stash8=config.remat_stash8,
            remat_te=quantize_base == "int8+te",
            max_train_steps=config.max_train_steps,
            ti_freeze_f=config.freeze_ti_after_completion_f,
            ti_lr=config.ti_lr,
            daam_img_ratio=img_ratio,
        )


def _unet_params_with_adapters(frozen: FrozenModels, trainable, sc: StepConfig):
    if not sc.is_lora:
        return trainable["unet"]
    if "unet" in trainable:
        return inject_lora(frozen.unet_params, trainable["unet"])
    return frozen.unet_params


def _te_params_with_adapters(frozen: FrozenModels, trainable, which: str):
    base = frozen.te1_params if which == "te1" else frozen.te2_params
    te_lora = trainable.get("te_lora", {})
    if base is not None and which in te_lora:
        return inject_lora(base, te_lora[which])
    return base


def compute_loss(
    trainable,
    frozen: FrozenModels,
    sc: StepConfig,
    batch: Dict[str, torch.Tensor],
    step: int,
    generator: Optional[torch.Generator] = None,
    latent_eps: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    offset_noise: Optional[torch.Tensor] = None,
    timesteps: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One micro-batch loss with every reference term.

    Under `sc.parallel` the batch is this rank's rows; draws are made (or
    given) in the global batch's shape and this rank's rows kept."""
    mean, logvar = batch["latent_mean"], batch["latent_logvar"]
    device = mean.device
    par = sc.parallel
    n_data = par.n_data if par is not None else 1
    group = par.batch if par is not None else None

    def rows(t):
        """This rank's rows of a global-batch tensor (a local one passes)."""
        if n_data > 1 and t.shape[0] == mean.shape[0] * n_data:
            return par.local_rows(t)
        return t

    def draw(shape, dtype):
        shape = (shape[0] * n_data,) + tuple(shape[1:])
        return rows(torch.randn(shape, generator=generator, dtype=dtype, device=device))

    if latent_eps is None:
        latent_eps = draw(mean.shape, torch.float32)
    latent_eps = rows(latent_eps)
    std = torch.exp(0.5 * logvar.float())
    latent = ((mean.float() + std * latent_eps.float()) * batch["latent_scale"]).to(mean.dtype)

    ti = trainable.get("ti", {})

    def conditioning():
        if frozen.version == "sdxl":
            return sdxl_conditioning(
                _te_params_with_adapters(frozen, trainable, "te1"),
                _te_params_with_adapters(frozen, trainable, "te2"),
                batch["input_ids"], batch["input_ids_2"],
                frozen.te1_config, frozen.te2_config, frozen.resolution,
                ti_rows_1=ti.get("te1"), ti_rows_2=ti.get("te2"), dtype=latent.dtype,
            )
        pe, _, _ = sd15_conditioning(
            _te_params_with_adapters(frozen, trainable, "te1"), batch["input_ids"],
            frozen.te1_config, ti_rows=ti.get("te1"), dtype=latent.dtype,
        )
        return pe, None, None

    if sc.remat_te:
        # int8 text encoders: recomputing the conditioning keeps only the
        # codes and its [B, 77, *] outputs alive, not the dequantized weights
        prompt_embeds, pooled, add_time_ids = checkpoint(conditioning, use_reentrant=False)
    else:
        prompt_embeds, pooled, add_time_ids = conditioning()
    added_cond = ({"text_embeds": pooled, "time_ids": add_time_ids}
                  if frozen.version == "sdxl" else None)

    if noise is None:
        noise = draw(latent.shape, latent.dtype)
    noise = rows(noise).to(latent.dtype)
    if sc.noise_offset > 0.0:
        b, _, _, c = latent.shape
        if offset_noise is None:
            offset_noise = draw((b, 1, 1, c), latent.dtype)
        noise = noise + sc.noise_offset * rows(offset_noise).to(latent.dtype)
    if timesteps is None:
        timesteps = rows(torch.randint(0, frozen.schedule.num_train_timesteps,
                                       (latent.shape[0] * n_data,), generator=generator,
                                       device=device))
    timesteps = rows(timesteps)
    noisy_latent = frozen.schedule.add_noise(latent, noise, timesteps)

    capture = sc.train_ti and sc.token_attention_loss_w > 0.0
    model_pred, attn_scores = unet_forward(
        _unet_params_with_adapters(frozen, trainable, sc), noisy_latent, timesteps,
        prompt_embeds, frozen.unet_config, added_cond=added_cond, capture_attn=capture,
        use_flash=sc.use_flash, remat=sc.remat, stash8=sc.stash8,
        gather=par.gather if par is not None and par.fsdp is not None else None,
    )

    mask = batch["mask"]
    img_loss = diffusion_loss(model_pred, noise, noisy_latent, latent, mask, frozen.schedule,
                              timesteps, sc.snr_gamma, group=group)
    loss = img_loss
    aux: Dict[str, torch.Tensor] = {"img_loss": img_loss}

    if capture:
        attn_loss = token_attention_loss(
            attn_scores, mask, sc.daam_img_ratio, batch["caption_token_lengths"],
            batch["ti_token_positions"], group=group,
        )
        loss = loss + sc.token_attention_loss_w * attn_loss
        aux["token_attention_loss"] = attn_loss

    if sc.l1_penalty > 0.0 and sc.is_lora and "unet" in trainable:
        mats = [m for _, e in iter_lora_leaves(trainable["unet"]) for m in (e["a"], e["b"])]
        l1 = lora_l1_penalty(mats)
        loss = loss + sc.l1_penalty * l1
        aux["l1_norm"] = l1

    if sc.train_ti:
        ti_active = 0.0 if step / sc.max_train_steps > sc.ti_freeze_f else 1.0
        if sc.cond_reg_w > 0.0:
            reg, observed = prompt_norm_regularization(
                prompt_embeds, TARGET_PROMPT_NORM[frozen.version], group=group
            )
            loss = loss + ti_active * sc.cond_reg_w * reg
            aux["prompt_norm"] = observed
        cov_losses, std_losses = [], []
        for which, rows in ti.items():
            if rows is None:
                continue
            targets = frozen.distribution_targets[which]
            if sc.tok_cov_reg_w > 0.0:
                cov_losses.append(targets.covariance_loss(rows))
            if sc.std_loss_w > 0.0:
                std_losses.append(targets.std_loss(rows))
        if cov_losses:
            cov = torch.stack(cov_losses).mean()
            loss = loss + ti_active * sc.tok_cov_reg_w * cov
            aux["covariance_tok_reg_loss"] = cov
        if std_losses:
            stdl = torch.stack(std_losses).mean()
            loss = loss + ti_active * sc.std_loss_w * stdl
            aux["token_std_loss"] = stdl

    aux["tot_loss"] = loss
    return loss, aux


def make_train_step(sc: StepConfig):
    """Build `train_step(state, batch, frozen, draws=None) -> metrics`.

    `batch` tensors carry a leading [accum] dim (0-dim tensors ride through);
    `draws` optionally holds one dict of explicit compute_loss draws per
    micro-batch. The step averages loss and gradients over the micro-batches,
    applies one optimizer update in place and advances `state.step`. Under
    `sc.parallel` the batch and draws are the global batch's.
    """

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor], frozen: FrozenModels,
                   draws: Optional[List[dict]] = None) -> Dict[str, torch.Tensor]:
        metrics = accumulate_grads(sc, state, batch, frozen, draws)
        state.optimizer.step()
        state.step += 1
        return metrics

    return train_step


def accumulate_grads(sc: StepConfig, state: TrainState, batch: Dict[str, torch.Tensor],
                     frozen: FrozenModels, draws: Optional[List[dict]] = None
                     ) -> Dict[str, torch.Tensor]:
    """The step up to the update: the trainables' .grad from every
    micro-batch (synced across the mesh), and the step's metrics."""
    par = sc.parallel
    if par is not None:  # this rank's rows of the [accum, B, ...] global batch
        batch = local_rows(batch, par.n_data, par.mesh.data_rank)
    state.optimizer.zero_grad()
    aux_sum: Dict[str, torch.Tensor] = {}
    for i in range(sc.grad_accum):
        mb = {k: (v[i] if v.ndim > 0 else v) for k, v in batch.items()}
        loss, aux = compute_loss(
            state.trainable, frozen, sc, mb, state.step, state.generator,
            **(draws[i] if draws else {}),
        )
        (loss / sc.grad_accum).backward()
        for k, v in aux.items():
            aux_sum[k] = aux_sum.get(k, 0.0) + v.detach()
    metrics = {k: v / sc.grad_accum for k, v in aux_sum.items()}
    tensors = group_tensors(state.trainable)
    if par is None:
        grads = [t.grad for t in tensors if t.grad is not None]
        metrics["grad_norm"] = torch.sqrt(sum(g.float().pow(2).sum() for g in grads))
        return metrics
    par.sync_grads(tensors)
    metrics = par.average_metrics(metrics)
    metrics["grad_norm"] = torch.sqrt(par.grad_sq_sum(tensors))
    return metrics


def run_steps(train_step, state: TrainState, batches, frozen: FrozenModels,
              steps_per_call: int) -> List[Dict[str, torch.Tensor]]:
    """The host loop of one `steps_per_call` group: K steps over K batches."""
    metrics = []
    for _, batch in zip(range(steps_per_call), batches):
        metrics.append(train_step(state, batch, frozen))
    return metrics
