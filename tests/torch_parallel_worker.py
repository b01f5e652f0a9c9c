"""One rank of the 2-process gloo group behind tests/test_torch_parallel.py.

    WORLD_SIZE=2 RANK=r MASTER_ADDR=localhost MASTER_PORT=p \
        python tests/torch_parallel_worker.py <dir>

Reads `<dir>/inputs.pt` (the tiny SDXL models, trainables, global batch and
JAX's draws, written by the test), runs every parallel case of the port on
the CPU and writes `<dir>/rank{r}.pt`. Imports torch and the port only.
Cases:

- attention: a UNet transformer block split by `shard_block_tp` at heads 2
  and 4 (mesh 1 x 2), heads 3 (indivisible, mesh 1 x 2) and batch 3
  (mesh 2 x 1), its output and whether it was split;
- <mode>_<optimizer>: dp and tp (LoRA, TI, TE-LoRA; tp unfused) under
  AdamW, fsdp (full finetune + TI) under AdamW, Prodigy and AdamW8bit: two
  train steps, the first on JAX's draws with its loss terms and gradients
  recorded (fsdp shards gathered whole), the second on the generator's;
  the trainables after each; then the same steps on one process (the cases
  shared out between the ranks, after every 2-rank case);
- state: the fsdp AdamW8bit state saved by both ranks (the trainables
  gathered first, as the CLI gathers them), restored by both into a zeroed
  template and saved again (the two files must be equal); whether the rank
  holds the gathered state.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sd_lora_trainer_tpu_torch import checkpoint as ck  # noqa: E402
from sd_lora_trainer_tpu_torch.config import TrainingConfig  # noqa: E402
from sd_lora_trainer_tpu_torch.models.unet import _transformer_block  # noqa: E402
from sd_lora_trainer_tpu_torch.parallel import sharding  # noqa: E402
from sd_lora_trainer_tpu_torch.parallel.distributed import (  # noqa: E402
    maybe_initialize_distributed,
    unshard_to_rank0,
)
from sd_lora_trainer_tpu_torch.training import step as ts  # noqa: E402
from sd_lora_trainer_tpu_torch.training.optimizers import GroupOptimizer, group_tensors  # noqa: E402


def config(**kw) -> TrainingConfig:
    base = dict(lora_training_urls="x", concept_mode="style", sd_model_version="sdxl",
                max_train_steps=50, lora_rank=4, _testing_no_output_dir=True, resolution=16,
                unet_lr=1e-3, cond_reg_w=1e-5, tok_cov_reg_w=1e-5, quantize_base="none",
                train_batch_size=4, device="cpu")
    base.update(kw)
    return TrainingConfig(**base)


def trainable_for(inp, full: bool):
    tr = copy.deepcopy(inp["full_trainable"] if full else inp["lora_trainable"])
    for t in group_tensors(tr):
        t.requires_grad_()
    return tr


def _whole(tree, plan, grad: bool = False):
    """Plain copies of the trainables (or of their gradients), fsdp shards
    gathered whole."""

    def whole(_, t):
        v = t if not grad else t.grad if t.grad is not None else torch.zeros_like(t)
        if plan is not None and plan.is_sharded(t):
            return plan.fsdp.full_of(t, v)
        return v.detach().clone()

    return sharding._map(tree, whole)


def build(inp, mode, full, mesh, optimizer="adamw"):
    cfg = config(is_lora=not full, unet_optimizer_type=optimizer,
                 **({} if full else {"text_encoder_lora_optimizer": "adamw",
                                     "text_encoder_lora_lr": 1e-3}))
    tr = trainable_for(inp, full)
    frozen = inp["frozen"]
    plan = None
    if mode is not None:
        plan, tr, frozen = sharding.parallelize(mode, mesh, tr, frozen)
    totals = {"unet": plan.batch.total} if plan is not None and plan.fsdp is not None else None
    state = ts.TrainState(step=0, trainable=tr, optimizer=GroupOptimizer(cfg, tr, totals),
                          generator=torch.Generator().manual_seed(5))
    sc = dataclasses.replace(ts.StepConfig.from_config(cfg, 1.0), parallel=plan)
    return cfg, sc, state, frozen, plan


def steps_case(inp, mode, full, mesh, optimizer):
    """Two train steps: the first on JAX's draws (its loss terms and
    gradients recorded before the update), the second on the generator's."""
    sharding.reset_collective_stats()
    _, sc, state, frozen, plan = build(inp, mode, full, mesh, optimizer)
    after = [_whole(state.trainable, plan)]
    metrics = ts.accumulate_grads(sc, state, inp["batch"], frozen, draws=[inp["draws"]])
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "grads": _whole(state.trainable, plan, grad=True)}
    state.optimizer.step()
    state.step += 1
    after.append(_whole(state.trainable, plan))
    ts.make_train_step(sc)(state, inp["batch"], frozen)
    after.append(_whole(state.trainable, plan))
    out.update(params=after, collectives=sharding.collective_stats())
    return out, state, plan


def state_case(inp, state, plan, mesh, folder):
    """Save by both ranks (with the trainables gathered first, as the CLI
    does), restore into a zeroed template, save again (gathering them)."""
    first = os.path.join(folder, "state_2ranks.safetensors")
    ck.save_train_state(first, state, plan, unshard_to_rank0(state.trainable, plan))
    torch.distributed.barrier()
    _, _, template, _, plan_t = build(inp, "fsdp", True, mesh, "AdamW8bit")
    with torch.no_grad():
        for t in group_tensors(template.trainable):
            t.zero_()
    ck.restore_train_state(first, template, plan_t)
    again = os.path.join(folder, "state_2ranks_again.safetensors")
    ck.save_train_state(again, template, plan_t)
    torch.distributed.barrier()
    # what save_train_state writes lands on rank 0 alone
    keeps = ck.whole_train_state(template, plan_t) is not None
    return {"first": first, "again": again, "keeps": keeps}


def main() -> int:
    folder = sys.argv[1]
    world, rank = maybe_initialize_distributed("cpu")
    assert world == 2, world
    torch.set_num_threads(1)
    inp = torch.load(os.path.join(folder, "inputs.pt"), weights_only=False)
    out = {}

    mesh_model = sharding.Mesh(1, 2)
    mesh_data = sharding.Mesh(2, 1)
    att = {}
    for name, (heads, mesh) in {"heads2": (2, mesh_model), "heads4": (4, mesh_model),
                                "heads3_indivisible": (3, mesh_model),
                                "batch3_indivisible": (2, mesh_data)}.items():
        a = inp["attention"][name]
        block = sharding.shard_block_tp(a["block"], heads, mesh.model)
        att[name] = {"out": _transformer_block(block, a["x"], a["ctx"], heads, False, True)[0],
                     "split": "tp" in block["attn1"]["to_q"]}
    out["attention"] = att

    cases = {"dp_adamw": ("dp", False, mesh_data, "adamw"),
             "tp_adamw": ("tp", False, mesh_model, "adamw")}
    cases.update({f"fsdp_{opt}": ("fsdp", True, mesh_data, opt)
                  for opt in ("adamw", "prodigy", "AdamW8bit")})
    for name, (mode, full, mesh, opt) in cases.items():
        out[name], state, plan = steps_case(inp, mode, full, mesh, opt)
    out["state"] = state_case(inp, state, plan, mesh_data, folder)
    # the same steps on one process, the cases shared out between the ranks
    for i, (name, (_, full, mesh, opt)) in enumerate(cases.items()):
        if i % 2 == rank:
            out[name]["one_process"] = steps_case(inp, None, full, mesh, opt)[0]["params"]
    torch.save(out, os.path.join(folder, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
