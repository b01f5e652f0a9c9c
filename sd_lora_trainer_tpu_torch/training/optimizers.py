"""The three optimizer groups and the reference's LR schedules.

Counterpart of sd_lora_trainer_tpu/training/optimizers.py. The trainable tree
has top-level groups {"unet": lora tree, "ti": {"te1": rows, "te2": rows},
"te_lora": {...}}; each group gets AdamW with torch's defaults (b1 0.9,
b2 0.999, eps 1e-8, decoupled weight decay), which is the update optax.adamw
computes, and its own schedule, evaluated at the number of updates done so
far (optax's count). With f = step / max_train_steps:

- TI:      ti_lr * (1 - f)^1.7, frozen after freeze_ti_after_completion_f
- TE LoRA: te_lr * (1 - f)^2 * min(step / warmup, 1)
- UNet:    base_lr * (unet_lr / base_lr)^(step / warmup_steps), frozen
           while f < freeze_unet_before_completion_f

Prodigy and AdamW8bit are later slices of the port and raise.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from sd_lora_trainer_tpu_torch.config import TrainingConfig


def base_unet_lr(config: TrainingConfig) -> float:
    """Cold-start LR of the exponential UNet warmup."""
    if not config.is_lora:
        return 1.0e-5
    return 2.0e-4 if config.disable_ti else 5.0e-5


def ti_lr_schedule(config: TrainingConfig) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        f = min(step / config.max_train_steps, 1.0)
        if f > config.freeze_ti_after_completion_f:
            return 0.0
        return config.ti_lr * (1.0 - f) ** 1.7

    return schedule


def te_lora_lr_schedule(config: TrainingConfig) -> Callable[[int], float]:
    warmup = config.txt_encoders_lr_warmup_steps

    def schedule(step: int) -> float:
        f = min(step / config.max_train_steps, 1.0)
        lr = config.text_encoder_lora_lr * (1.0 - f) ** 2.0
        if warmup > 0:
            lr *= min(step / warmup, 1.0)
        return lr

    return schedule


def unet_lr_schedule(config: TrainingConfig) -> Callable[[int], float]:
    base = base_unet_lr(config)
    warmup = max(config.unet_lr_warmup_steps or config.max_train_steps, 1)

    def schedule(step: int) -> float:
        f = min(step / config.max_train_steps, 1.0)
        if f < config.freeze_unet_before_completion_f:
            return 0.0
        return base * (config.unet_lr / base) ** (step / warmup)

    return schedule


def group_tensors(tree) -> List[torch.Tensor]:
    """The trainable tensors of one group, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in tree for t in group_tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in group_tensors(v)]
    return []  # LoraAlpha and other hyperparameters


class GroupOptimizer:
    """One torch AdamW over the trainable groups, with a schedule per group."""

    def __init__(self, config: TrainingConfig, trainable: dict):
        if config.unet_optimizer_type != "adamw" or config.ti_optimizer != "adamw":
            raise NotImplementedError(
                f"unet_optimizer_type={config.unet_optimizer_type!r}, "
                f"ti_optimizer={config.ti_optimizer!r}: Prodigy and AdamW8bit are a later "
                "slice of the port; use adamw"
            )
        wd = {
            "unet": config.lora_weight_decay if not config.use_dora else 0.0,
            "ti": config.ti_weight_decay,
            "te_lora": config.text_encoder_lora_weight_decay if not config.use_dora else 0.0,
        }
        schedules = {
            "unet": unet_lr_schedule(config),
            "ti": ti_lr_schedule(config),
            "te_lora": te_lora_lr_schedule(config),
        }
        groups = []
        self.schedules: Dict[str, Callable[[int], float]] = {}
        for name in ("unet", "ti", "te_lora"):
            if name not in trainable:
                continue
            self.schedules[name] = schedules[name]
            groups.append({
                "params": group_tensors(trainable[name]), "name": name,
                "lr": schedules[name](0), "weight_decay": wd[name],
            })
        self.opt = torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8)
        self.count = 0

    def step(self) -> None:
        """Apply one update from the tensors' .grad at the scheduled LRs."""
        for group in self.opt.param_groups:
            group["lr"] = self.schedules[group["name"]](self.count)
        self.opt.step()
        self.count += 1

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)
