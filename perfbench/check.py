"""The comparison that decides `correct` for the training cells.

Each number compared is a gap between what the program produced and what
the reference computes from the same inputs and draws:

- `loss1_gap`, `loss23_gap`: |program - reference| / |reference| of the
  first step's loss, and the larger of the second and third steps';
- `grad_gap`: the first gradient as the optimizer got it (its AdamW first
  moment after one step, over 1 - beta1), by the worst leaf: the gap
  between the program's norm and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf (the median over the
  leaves whose reference gradient is not 0); `grad_median_gap`, the
  median leaf's;
- `grad_err`: the same first gradient's error over every leaf together,
  ||program - reference|| / ||reference||;
- `loss2_gap`, `grad2_err`: the second step, the one that the program's
  first replay of its captured graph computes, against the reference's
  second step taken at the program's own trainables after step 1, with
  step 2's batch and draws, in the recipes' precision (bf16): the loss's
  gap as `loss1_gap`'s, and the gradient (the program's first moments
  after two steps, less b1 times those after one, over 1 - b1) by its
  error over every leaf together. Taken from the program's state, this
  step carries none of the sign flips of AdamW's first update (below). A
  float32 judge would read what every bf16 computation drops alike: B's
  first move, about lr, is under half a bf16 step of the base output it
  is added to (PERF.md);
- `change_gap`: the trainables' change over the three steps, by the worst
  leaf, measured so; a leaf whose reference gradient stays under a
  thousandth of the median leaf's in both of the first two steps moves by
  round-off alone and is left out; `change_median_gap`, the median leaf's;
- `lora_sites`: adapted modules that one side has and the other lacks.

Each cell's limits file (perfbench/limits/) says which are compared, and
from which readings each limit was set; the rest are printed beside them.
`grad2_angle` (the angle in radians between the two sides' second
gradients, from the moments after two steps) is never compared: AdamW's
first update moves each element by about lr x the sign of its gradient, so
every gradient after it carries the sign flips of near-zero elements,
whatever the precision (PERF.md).
"""

from __future__ import annotations

import gc
import math
from typing import Dict, List

import torch

from perfbench import inputs as inp
from perfbench.reference.nn import Prec
from perfbench.reference.train import Trainer


def _median(values: List[float]) -> float:
    values = sorted(values)
    n = len(values)
    if not n:
        return 0.0
    return values[n // 2] if n % 2 else 0.5 * (values[n // 2 - 1] + values[n // 2])


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep=None) -> Dict[str, float]:
    """Each leaf's |program norm - reference norm| over the larger of the
    reference's norm of that leaf and of the median leaf."""
    names = [k for k in ref if keep is None or k in keep]
    pn = {k: float(prog[k].float().norm()) for k in names}
    rn = {k: float(ref[k].float().norm()) for k in names}
    med = _median([v for v in rn.values() if v > 0])
    gaps = {}
    for k in names:
        denom = max(rn[k], med)
        gaps[k] = abs(pn[k] - rn[k]) / denom if denom > 0 else (0.0 if pn[k] == 0 else math.inf)
    return gaps


def first_grads(prog: dict) -> Dict[str, torch.Tensor]:
    return {k: m / (1.0 - prog["b1"]) for k, m in prog["m1"].items()}


def second_grads(prog: dict) -> Dict[str, torch.Tensor]:
    b1 = prog["b1"]
    return {k: (prog["m2"][k] - b1 * prog["m1"][k]) / (1.0 - b1) for k in prog["m2"]}


def changes(side: dict) -> Dict[str, torch.Tensor]:
    return {k: side["p_end"][k] - side["p0"][k] for k in side["p0"]}


def rel_err(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> float:
    """||program - reference|| / ||reference|| over every leaf together."""
    err = math.sqrt(sum(float((prog[k].double() - ref[k].double()).pow(2).sum()) for k in ref))
    norm = math.sqrt(sum(float(ref[k].double().pow(2).sum()) for k in ref))
    return err / norm if norm > 0 else math.inf


def worst_leaves(prog: dict, ref: dict, top: int = 4) -> Dict[str, list]:
    """The leaves that set `grad_gap` and `change_gap`, worst first, with
    their gaps (a diagnosis, not compared)."""
    pairs = {"grad": leaf_gaps(first_grads(prog), ref["grads"][0]),
             "change": leaf_gaps(changes(prog), changes(ref))}
    return {what: sorted(g.items(), key=lambda kv: -kv[1])[:top] for what, g in pairs.items()}


def angle(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> float:
    dot = sum(float((a[k].double() * b[k].double()).sum()) for k in b)
    na = math.sqrt(sum(float(a[k].double().pow(2).sum()) for k in b))
    nb = math.sqrt(sum(float(b[k].double().pow(2).sum()) for k in b))
    if na == 0 or nb == 0:
        return math.pi / 2
    return math.acos(max(-1.0, min(1.0, dot / (na * nb))))


NUMBERS = ("loss1_gap", "loss2_gap", "loss23_gap", "grad_err", "grad2_err", "grad_gap",
           "grad_median_gap", "change_gap", "change_median_gap", "grad2_angle")
# the precision of the reference that judges the second step: the recipes'
STEP2_JUDGE = "bf16"


def readings_of(prog: dict, ref: dict, at: dict) -> Dict[str, float]:
    """The compared numbers (and the reported angle) from the program's
    snapshots {losses, p0, p1, m1, m2, p_end, b1}, the reference's steps,
    and the reference's second step at the program's p1 {loss, grads}."""
    if set(prog["p0"]) != set(ref["p0"]) or len(prog["losses"]) != len(ref["losses"]):
        return {k: math.inf for k in NUMBERS}
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])]
    g1, g2 = first_grads(prog), second_grads(prog)
    r1, r2 = ref["grads"][0], ref["grads"][1]
    norms = {k: max(float(r1[k].norm()), float(r2[k].norm())) for k in r1}
    med = _median([v for v in norms.values() if v > 0])
    moved = {k for k, v in norms.items() if v >= 1e-3 * med}
    grad = list(leaf_gaps(g1, r1).values())
    change = list(leaf_gaps(changes(prog), changes(ref), keep=moved).values())
    return {
        "grad_err": rel_err(g1, r1),
        "grad2_err": rel_err(g2, at["grads"]),
        "loss1_gap": losses[0],
        "loss2_gap": abs(prog["losses"][1] - at["loss"]) / abs(at["loss"]),
        "loss23_gap": max(losses[1:]),
        "grad_gap": max(grad),
        "grad_median_gap": _median(grad),
        "change_gap": max(change),
        "change_median_gap": _median(change),
        "grad2_angle": angle(g2, r2),
    }


def reference_steps(config: dict, mix: dict, seed: int, device, batches, seed_draws: int,
                    prec: str, at=()) -> dict:
    """The reference's steps at `prec`, and under "at" the second step
    (loss and gradient) at STEP2_JUDGE at each of the trainables `at` (a
    side's p1)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w, h = mix["resolution"]
    r = dict(mix["reference_recipe"], train_img_size=[w, h], daam_img_ratio=w / h)

    def trainer(p):
        data = inp.make_inputs(config, seed, device, rank=r["lora_rank"], n_tokens=r["n_tokens"])
        return Trainer(config, r, data, Prec(p), device)

    ref = trainer(prec).steps(batches, seed_draws)
    if at:
        gc.collect()
        judge = trainer(STEP2_JUDGE)
        ref["at"] = [judge.step_at(p1, ref["fed"][1], 1) for p1 in at]
    return ref


def as_program(ref: dict, b1: float = 0.9) -> dict:
    """A reference run in the program's place (the control): its
    snapshots in the program's form, the moments rebuilt from the
    gradients."""
    g1, g2 = ref["grads"]
    m1 = {k: (1.0 - b1) * g for k, g in g1.items()}
    m2 = {k: b1 * m1[k] + (1.0 - b1) * g2[k] for k in g2}
    return {"losses": ref["losses"], "p0": ref["p0"], "p1": ref["p1"], "m1": m1, "m2": m2,
            "p_end": ref["p_end"], "b1": b1}


def judged(config: dict, mix: dict, seed: int, device, batches, seed_draws: int,
           sides: List[dict]):
    """The float32 reference's steps, and each side's readings against it."""
    ref = reference_steps(config, mix, seed, device, batches, seed_draws, "fp32",
                          at=[s["p1"] for s in sides])
    return ref, [readings_of(s, ref, a) for s, a in zip(sides, ref["at"])]


def train_readings(config: dict, mix: dict, seed: int, device, batches, seed_draws: int,
                   prog: dict) -> Dict[str, float]:
    return judged(config, mix, seed, device, batches, seed_draws, [prog])[1][0]
