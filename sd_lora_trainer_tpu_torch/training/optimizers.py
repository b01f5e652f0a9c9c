"""The three optimizer groups and the reference's LR schedules.

Counterpart of sd_lora_trainer_tpu/training/optimizers.py. The trainable tree
has top-level groups {"unet": lora tree or UNet tree, "ti": {"te1": rows,
"te2": rows}, "te_lora": {...}}; each group gets the optimizer the JAX
package's `build_unet_optimizer`, `build_ti_optimizer` and
`build_te_lora_optimizer` choose, with the same settings, and an optimizer
of its own (so each Prodigy group adapts its own d, as under optax's
multi_transform):

- AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay: the update
  optax.adamw computes, written here with foreach ops) at the group's
  schedule;
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

Each schedule is tensor ops on a float64 0-d step count: the update
evaluates it at a device count, `current_lrs` (the debug LR history) at a
Python step, on the CPU. Nothing an update reads changes as a Python value
from step to step, so a captured step (training/step.py) replays it: an optimizer
keeps its update count on the host (`count`, the mirror that resume and
export read) and in a device tensor that `sync` fills from it before each
update. `update` is the device work alone, `advance` moves the host count,
and `step` is the three in order.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Union

import torch

from sd_lora_trainer_tpu_torch.config import TrainingConfig
from sd_lora_trainer_tpu_torch.training.prodigy import Prodigy, prodigy_effective_lr
from sd_lora_trainer_tpu_torch.training.quantized_adam import AdamW8bit
from sd_lora_trainer_tpu_torch.utils import profiling


def base_unet_lr(config: TrainingConfig) -> float:
    """Cold-start LR of the exponential UNet warmup."""
    if not config.is_lora:
        return 1.0e-5
    return 2.0e-4 if config.disable_ti else 5.0e-5


Schedule = Callable[[Union[int, torch.Tensor]], Union[float, torch.Tensor]]


def _schedule(fn: Callable[[torch.Tensor], torch.Tensor]) -> Schedule:
    """`fn` of a float64 0-d step count; a Python step gets a float."""

    def schedule(step):
        if isinstance(step, torch.Tensor):
            return fn(step)
        return float(fn(torch.tensor(step, dtype=torch.float64)))

    return schedule


def _fraction(config: TrainingConfig, step: torch.Tensor) -> torch.Tensor:
    return torch.clamp(step / config.max_train_steps, max=1.0)


def ti_lr_schedule(config: TrainingConfig) -> Schedule:
    def schedule(step):
        f = _fraction(config, step)
        return torch.where(f > config.freeze_ti_after_completion_f, 0.0,
                           config.ti_lr * (1.0 - f) ** 1.7)

    return _schedule(schedule)


def te_lora_lr_schedule(config: TrainingConfig) -> Schedule:
    warmup = config.txt_encoders_lr_warmup_steps

    def schedule(step):
        lr = config.text_encoder_lora_lr * (1.0 - _fraction(config, step)) ** 2.0
        return lr * torch.clamp(step / warmup, max=1.0) if warmup > 0 else lr

    return _schedule(schedule)


def unet_lr_schedule(config: TrainingConfig) -> Schedule:
    base = base_unet_lr(config)
    warmup = max(config.unet_lr_warmup_steps or config.max_train_steps, 1)

    def schedule(step):
        return torch.where(_fraction(config, step) < config.freeze_unet_before_completion_f, 0.0,
                           base * (config.unet_lr / base) ** (step / warmup))

    return _schedule(schedule)


_SCHEDULES = {"unet": unet_lr_schedule, "ti": ti_lr_schedule, "te_lora": te_lora_lr_schedule}


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
    """optax.adamw over one group at the LR `update` is given: the moments
    in each tensor's dtype, the bias corrections from a device count, a
    missing grad read as 0. The state keeps torch AdamW's keys ("step",
    "exp_avg", "exp_avg_sq" per tensor), so train states written before
    load."""

    kind = "adamw"

    def __init__(self, params: List[torch.Tensor], weight_decay: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        with torch.no_grad():
            self.exp_avg = [torch.zeros_like(p) for p in self.params]
            self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self._count_t = torch.zeros((), dtype=torch.float32, device=self.params[0].device)

    def sync(self) -> None:
        self._count_t.fill_(self.count)

    def bias_corrections(self):
        """(1 - b1^n, 1 - b2^n) for this update's n, float32 0-d on the device."""
        count = self._count_t + 1.0
        return 1.0 - self.b1**count, 1.0 - self.b2**count

    @torch.no_grad()
    def update(self, lr) -> None:
        """p <- p - lr * ((m / bc1) / (sqrt(v / bc2) + eps) + wd * p) in 9
        passes over the tensors (torch's capturable AdamW's): the decay as
        one scaling of p, and the step size -lr / bc1 folded into the
        denominator, since addcdiv takes no device scalar (at lr 0 the
        denominator is infinite and p keeps its value). The device scalars
        take the tensors' dtype: a scalar of another dtype sends a foreach
        op down its one-kernel-a-tensor path (scripts/update_time.py times
        both)."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        bc1, bc2 = self.bias_corrections()
        dtype = self.params[0].dtype
        torch._foreach_lerp_(self.exp_avg, grads, 1.0 - self.b1)
        torch._foreach_mul_(self.exp_avg_sq, self.b2)
        torch._foreach_addcmul_(self.exp_avg_sq, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_sqrt(self.exp_avg_sq)
        torch._foreach_div_(denom, torch.sqrt(bc2).to(dtype))
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(denom, (-lr / bc1).to(dtype))
        if self.weight_decay:
            torch._foreach_mul_(self.params, (1.0 - lr * self.weight_decay).to(dtype))
        torch._foreach_addcdiv_(self.params, self.exp_avg, denom)

    def advance(self) -> None:
        self.count += 1

    def step(self, lr) -> None:
        self.sync()
        self.update(lr)
        self.advance()

    def state_tensors(self) -> Dict[str, torch.Tensor]:
        step = torch.tensor(float(self.count), dtype=torch.float32)
        out = {}
        for i in range(len(self.params)):
            out[f"step.{i:05d}"] = step
            out[f"exp_avg.{i:05d}"] = self.exp_avg[i]
            out[f"exp_avg_sq.{i:05d}"] = self.exp_avg_sq[i]
        return out

    @torch.no_grad()
    def load_state_tensors(self, sd: Dict[str, torch.Tensor]) -> None:
        for k, v in sd.items():
            key, _, i = k.rpartition(".")
            if key == "step":
                self.count = int(v)
            else:
                getattr(self, key)[int(i)].copy_(v)


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
        self.groups: Dict[str, object] = {}
        self.schedules: Dict[str, Schedule] = {}
        for name in ("unet", "ti", "te_lora"):
            if name not in trainable:
                continue
            self.schedules[name] = _SCHEDULES[name](config)
            self.groups[name] = build_group_optimizer(config, name, group_tensors(trainable[name]),
                                                      (totals or {}).get(name))
        self.count = 0
        device = self.params()[0].device if self.groups else "cpu"
        self._count_t = torch.zeros((), dtype=torch.float64, device=device)

    def params(self) -> List[torch.Tensor]:
        """Every trainable tensor, group by group."""
        return [p for opt in self.groups.values() for p in opt.params]

    def kinds(self) -> Dict[str, str]:
        return {name: opt.kind for name, opt in self.groups.items()}

    def sync(self) -> None:
        """Fill the device counts from their host mirrors (fill kernels:
        no host wait). Runs before each update, outside a captured step."""
        self._count_t.fill_(self.count)
        for opt in self.groups.values():
            opt.sync()

    def device_lrs(self) -> Dict[str, torch.Tensor]:
        """Each scheduled group's LR at the device count, float32 0-d."""
        return {name: self.schedules[name](self._count_t).float()
                for name, opt in self.groups.items() if not isinstance(opt, Prodigy)}

    def update(self) -> None:
        """One update of every group from the tensors' .grad at the device
        LRs (a Prodigy group runs at its fixed LR of 1): device work only."""
        lrs = self.device_lrs()
        for name, opt in self.groups.items():
            with profiling.phase("update." + name):
                opt.update(lrs.get(name))

    def advance(self) -> None:
        """Count the update on the host."""
        self.count += 1
        for opt in self.groups.values():
            opt.advance()

    def step(self) -> None:
        """Apply one update at the scheduled LRs and count it."""
        self.sync()
        self.update()
        self.advance()

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
