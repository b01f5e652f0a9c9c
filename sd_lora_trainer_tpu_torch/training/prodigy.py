"""The Prodigy optimizer (arXiv:2306.06101) over one group of tensors.

Counterpart of sd_lora_trainer_tpu/training/prodigy.py: the prodigyopt
update rule with its four knobs (d_coef, growth_rate, safeguard_warmup,
decouple) and bias correction, in the JAX package's order of operations.
The state is fp32 `exp_avg`, `exp_avg_sq`, `s` and `p0` (the tensors'
initial values) per tensor, and four 0-d tensors on the group's device:
`d`, `d_max`, `d_numerator` and `count`. Every scalar stays on the device
and is updated in place, so a step never waits for it and a captured step
(training/step.py) replays it.

One instance serves one group: JAX's `optax.multi_transform` gives the UNet
group and the TI group a `d` each, which one Prodigy over several torch
parameter groups would not.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch


class Prodigy:
    kind = "prodigy"

    def __init__(
        self,
        params: List[torch.Tensor],
        lr: float = 1.0,
        betas=(0.9, 0.99),
        beta3: Optional[float] = None,
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        d_coef: float = 1.0,
        d0: float = 1e-6,
        growth_rate: float = math.inf,
        safeguard_warmup: bool = True,
        use_bias_correction: bool = True,
        decouple: bool = True,
        total=None,
    ):
        self.params = list(params)
        # fsdp: the group's tensors are shards, and its two sums over every
        # tensor are summed over the data group too (parallel/sharding.py)
        self.total = total if total is not None else (lambda t: t)
        self.lr = lr
        self.beta1, self.beta2 = betas
        self.beta3 = beta3 if beta3 is not None else self.beta2**0.5
        self.eps, self.weight_decay, self.d_coef = eps, weight_decay, d_coef
        self.growth_rate = growth_rate
        self.safeguard_warmup = safeguard_warmup
        self.use_bias_correction = use_bias_correction
        self.decouple = decouple
        device = self.params[0].device
        with torch.no_grad():
            self.exp_avg = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
            self.exp_avg_sq = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
            self.s = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
            self.p0 = [p.detach().float().clone() for p in self.params]
        self.d0 = torch.tensor(d0, dtype=torch.float32, device=device)
        self.d = self.d0.clone()
        self.d_max = self.d0.clone()
        self.d_numerator = torch.zeros((), dtype=torch.float32, device=device)
        self.count = torch.zeros((), dtype=torch.int32, device=device)

    def _bias_correction(self) -> torch.Tensor:
        if not self.use_bias_correction:
            return torch.ones((), dtype=torch.float32, device=self.d.device)
        k1 = self.count.float() + 1.0
        return torch.sqrt(1.0 - self.beta2**k1) / (1.0 - self.beta1**k1)

    def sync(self) -> None:
        """Nothing to fill: the count is a device tensor only."""

    def advance(self) -> None:
        """Nothing to count on the host."""

    @torch.no_grad()
    def update(self, lr: Optional[float] = None) -> None:
        """One update of every tensor from its .grad (a missing grad is 0)."""
        lr = self.lr if lr is None else lr
        b1, b2, b3 = self.beta1, self.beta2, self.beta3
        d, d0 = self.d, self.d0
        grads = [p.grad.float() if p.grad is not None else torch.zeros_like(m)
                 for p, m in zip(self.params, self.exp_avg)]
        p32 = [p.detach().float() for p in self.params]
        dlr = d * lr * self._bias_correction()

        # the numerator: a beta3-decayed sum of (d / d0) * dlr * <g, p0 - p>
        prods = torch._foreach_sub(self.p0, p32)
        torch._foreach_mul_(prods, grads)
        dot = self.total(sum(t.sum() for t in prods))
        d_numerator = self.d_numerator * b3 + (d / d0) * dlr * dot

        torch._foreach_mul_(self.exp_avg, b1)
        torch._foreach_add_(self.exp_avg, torch._foreach_mul(grads, d * (1 - b1)))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, d * d * (1 - b2))
        torch._foreach_mul_(self.exp_avg_sq, b2)
        torch._foreach_add_(self.exp_avg_sq, sq)
        s_coef = (d / d0) * (d if self.safeguard_warmup else dlr)
        torch._foreach_mul_(self.s, b3)
        torch._foreach_add_(self.s, torch._foreach_mul(grads, s_coef))
        d_denom = self.total(sum(torch._foreach_norm(self.s, 1)))

        d_hat = self.d_coef * d_numerator / torch.clamp(d_denom, min=1e-30)
        # while d is still d0 it takes d_hat at once; afterwards it grows by
        # at most growth_rate a step, and it never shrinks
        d_new = torch.where(d == d0, torch.maximum(d, d_hat), d)
        d_max = torch.maximum(self.d_max, d_hat)
        d_new = torch.minimum(d_max, d_new * self.growth_rate)
        d_new = torch.maximum(d_new, d)

        # the step takes dlr from the old d and the eps guard from the new d
        denom = torch._foreach_sqrt(self.exp_avg_sq)
        # a list of 0-d tensors, not one: a tensor second operand of
        # _foreach_add_ is read on the host on the CPU (and when traced)
        torch._foreach_add_(denom, [d_new * self.eps] * len(denom))
        updates = torch._foreach_mul(self.exp_avg, -dlr)
        torch._foreach_div_(updates, denom)
        if self.decouple and self.weight_decay > 0.0:
            torch._foreach_sub_(updates, torch._foreach_mul(p32, self.weight_decay * dlr))
        for p, u in zip(self.params, updates):
            p.add_(u.to(p.dtype))

        self.d.copy_(d_new)
        self.d_max.copy_(d_max)
        self.d_numerator.copy_(d_numerator)
        self.count.add_(1)

    step = update

    def state_tensors(self) -> Dict[str, torch.Tensor]:
        out = {"d": self.d, "d_max": self.d_max, "d_numerator": self.d_numerator,
               "count": self.count}
        for name in ("exp_avg", "exp_avg_sq", "s", "p0"):
            for i, t in enumerate(getattr(self, name)):
                out[f"{name}.{i:05d}"] = t
        return out

    @torch.no_grad()
    def load_state_tensors(self, sd: Dict[str, torch.Tensor]) -> None:
        for name in ("d", "d_max", "d_numerator", "count"):
            getattr(self, name).copy_(sd[name])
        for name in ("exp_avg", "exp_avg_sq", "s", "p0"):
            for i, t in enumerate(getattr(self, name)):
                t.copy_(sd[f"{name}.{i:05d}"])


def prodigy_effective_lr(opt: Prodigy, learning_rate: float = 1.0) -> torch.Tensor:
    """d * lr * bias_correction: the step size the reference logs per step."""
    k1 = opt.count.float() + 1.0
    bc = torch.sqrt(1.0 - opt.beta2**k1) / (1.0 - opt.beta1**k1)
    return opt.d * learning_rate * bc
