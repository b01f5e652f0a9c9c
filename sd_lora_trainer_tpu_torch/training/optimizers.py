"""The three optimizer groups and the reference's LR schedules.

Counterpart of sd_lora_trainer_tpu/training/optimizers.py. The trainable tree
has top-level groups {"unet": lora tree or UNet tree, "ti": {"te1": rows,
"te2": rows}, "te_lora": {...}}; each group gets the optimizer the JAX
package's `build_unet_optimizer`, `build_ti_optimizer` and
`build_te_lora_optimizer` choose, with the same settings, and an optimizer
of its own (so each Prodigy group adapts its own d, as under optax's
multi_transform):

- AdamW (torch's, b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay: the
  update optax.adamw computes) at the group's schedule;
- "prodigy" (UNet or TI): training/prodigy.py at lr 1.0, betas (0.9, 0.99),
  safeguard_warmup, bias correction and decoupled decay, with d_coef =
  prodigy_d_coef and growth_rate = unet_prodigy_growth_factor for the UNet,
  d_coef 1 and no growth cap for TI; the schedules do not apply;
- "AdamW8bit" (UNet): training/quantized_adam.py at the UNet schedule.

Schedules, evaluated at the number of updates done so far (optax's count),
with f = step / max_train_steps:

- TI:      ti_lr * (1 - f)^1.7, frozen after freeze_ti_after_completion_f
- TE LoRA: te_lr * (1 - f)^2 * min(step / warmup, 1)
- UNet:    base_lr * (unet_lr / base_lr)^(step / warmup_steps), frozen
           while f < freeze_unet_before_completion_f
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from sd_lora_trainer_tpu_torch.config import TrainingConfig
from sd_lora_trainer_tpu_torch.training.prodigy import Prodigy, prodigy_effective_lr
from sd_lora_trainer_tpu_torch.training.quantized_adam import AdamW8bit


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


class AdamW:
    """torch's AdamW over one group, at the LR `step` is given."""

    kind = "adamw"

    def __init__(self, params: List[torch.Tensor], weight_decay: float):
        self.params = list(params)
        self.opt = torch.optim.AdamW(self.params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=weight_decay)

    def step(self, lr: float) -> None:
        self.opt.param_groups[0]["lr"] = lr
        self.opt.step()

    def state_tensors(self) -> Dict[str, torch.Tensor]:
        return {f"{k}.{i:05d}": v for i, p in enumerate(self.params)
                for k, v in self.opt.state.get(p, {}).items()}

    def load_state_tensors(self, sd: Dict[str, torch.Tensor]) -> None:
        entries: Dict[int, Dict[str, torch.Tensor]] = {}
        for k, v in sd.items():
            key, _, i = k.rpartition(".")
            entries.setdefault(int(i), {})[key] = v
        for i, entry in entries.items():
            p = self.params[i]
            # the 0-d step count stays on the CPU unless AdamW is fused
            self.opt.state[p] = {k: v if v.ndim == 0 else v.to(p.device) for k, v in entry.items()}


def build_group_optimizer(config: TrainingConfig, name: str, params: List[torch.Tensor],
                          total=None):
    """The optimizer of group `name` ("unet", "ti" or "te_lora"). `total`
    sums a tensor over the ranks that hold shards of the group (fsdp): what
    Prodigy's sums over every tensor need; elementwise updates need none."""
    wd = {
        "unet": config.lora_weight_decay if not config.use_dora else 0.0,
        "ti": config.ti_weight_decay,
        "te_lora": config.text_encoder_lora_weight_decay if not config.use_dora else 0.0,
    }[name]
    prodigy = dict(lr=1.0, betas=(0.9, 0.99), weight_decay=wd, safeguard_warmup=True,
                   use_bias_correction=True, decouple=True)
    if name == "unet" and config.unet_optimizer_type == "prodigy":
        return Prodigy(params, d_coef=config.prodigy_d_coef,
                       growth_rate=config.unet_prodigy_growth_factor, total=total, **prodigy)
    if name == "unet" and config.unet_optimizer_type == "AdamW8bit":
        return AdamW8bit(params, weight_decay=wd)
    if name == "ti" and config.ti_optimizer == "prodigy":
        return Prodigy(params, d_coef=1.0, **prodigy)
    return AdamW(params, wd)


class GroupOptimizer:
    """One optimizer per trainable group, each at its own schedule.
    `totals` maps a sharded group to its sum over the ranks (fsdp)."""

    def __init__(self, config: TrainingConfig, trainable: dict, totals: Optional[dict] = None):
        schedules = {
            "unet": unet_lr_schedule(config),
            "ti": ti_lr_schedule(config),
            "te_lora": te_lora_lr_schedule(config),
        }
        self.groups: Dict[str, object] = {}
        self.schedules: Dict[str, Callable[[int], float]] = {}
        for name in ("unet", "ti", "te_lora"):
            if name not in trainable:
                continue
            self.schedules[name] = schedules[name]
            self.groups[name] = build_group_optimizer(config, name, group_tensors(trainable[name]),
                                                      (totals or {}).get(name))
        self.count = 0

    def params(self) -> List[torch.Tensor]:
        """Every trainable tensor, group by group."""
        return [p for opt in self.groups.values() for p in opt.params]

    def kinds(self) -> Dict[str, str]:
        return {name: opt.kind for name, opt in self.groups.items()}

    def step(self) -> None:
        """Apply one update from the tensors' .grad at the scheduled LRs
        (a Prodigy group runs at its fixed LR of 1)."""
        for name, opt in self.groups.items():
            opt.step(None if isinstance(opt, Prodigy) else self.schedules[name](self.count))
        self.count += 1

    def zero_grad(self) -> None:
        for p in self.params():
            p.grad = None

    def state_tensors(self) -> Dict[str, torch.Tensor]:
        """Every group's optimizer state, keyed "<group>.<name>"."""
        return {f"{name}.{k}": v for name, opt in self.groups.items()
                for k, v in opt.state_tensors().items()}

    def load_state_tensors(self, sd: Dict[str, torch.Tensor]) -> None:
        for name, opt in self.groups.items():
            prefix = name + "."
            opt.load_state_tensors({k[len(prefix):]: v for k, v in sd.items()
                                    if k.startswith(prefix)})


def current_lrs(config: TrainingConfig, step: int,
                optimizer: Optional[GroupOptimizer] = None) -> Dict[str, float]:
    """The schedules' LRs at `step` under the JAX package's names, plus each
    Prodigy group's effective LR (d * lr * bias correction) as
    "<group>_prodigy" when an optimizer is given (a host read of d)."""
    out = {"unet": unet_lr_schedule(config)(step),
           "textual_inversion": ti_lr_schedule(config)(step),
           "text_encoders": te_lora_lr_schedule(config)(step)}
    for name, opt in (optimizer.groups.items() if optimizer else ()):
        if isinstance(opt, Prodigy):
            out[f"{name}_prodigy"] = float(prodigy_effective_lr(opt))
    return out
