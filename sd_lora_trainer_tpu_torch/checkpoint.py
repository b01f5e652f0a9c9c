"""Checkpoint save/load: the artifact contract, and a resumable train state.

Counterpart of sd_lora_trainer_tpu/checkpoint.py. `save_checkpoint` writes
the JAX package's artifact set, under the same names:

    {name}_{version}_embeddings.safetensors   TI rows, keys clip_l / clip_g
    special_params.json                       token map {"TOK": "<s0><s1><s2>"}
    {name}_{version}_lora.safetensors         kohya/WebUI LoRA (ComfyUI/A1111)
    unet_finetuned.safetensors (full finetune) LDM-layout UNet

`load_checkpoint` reads them back. `save_train_state` and
`restore_train_state` keep what a run needs to resume: the trainable
tensors, each group's optimizer state (AdamW, Prodigy or AdamW8bit), the
step and the generator's state, in one flat safetensors file written
atomically. Under fsdp (a `plan` of parallel/sharding.py) the shards and
their optimizer state are gathered whole into rank 0's host memory first
(a collective every rank enters) and rank 0 writes, so the file is the
one-process file: a state saved by N ranks restores in any number of them,
each taking its shards. The files are
written and read by utils/safetensors_io.py, not the `safetensors` package.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import torch

from sd_lora_trainer_tpu_torch.config import sanitize_name
from sd_lora_trainer_tpu_torch.models.lora import kohya_state_dict, load_kohya_state_dict
from sd_lora_trainer_tpu_torch.models.weights import export_ldm_unet
from sd_lora_trainer_tpu_torch.parallel.distributed import unshard_to_rank0
from sd_lora_trainer_tpu_torch.parallel.sharding import optimizer_state_shardings, state_param_index
from sd_lora_trainer_tpu_torch.training.embeddings import TXT_ENCODER_KEYS
from sd_lora_trainer_tpu_torch.training.optimizers import group_tensors
from sd_lora_trainer_tpu_torch.utils.safetensors_io import (
    load_safetensors,
    read_safetensors_metadata,
    save_safetensors,
)


def save_checkpoint(
    output_dir: str,
    global_step: int,
    name: str,
    pretrained_model_version: str,
    token_dict: Dict[str, str],
    is_lora: bool,
    ti_rows: Optional[List[Optional[torch.Tensor]]] = None,
    unet_lora: Optional[dict] = None,
    te_loras: Optional[List[Optional[dict]]] = None,
    unet_params: Optional[dict] = None,
    unet_config=None,
) -> None:
    """Write the full artifact set of one checkpoint into `output_dir`."""
    os.makedirs(output_dir, exist_ok=True)
    name = sanitize_name(name)
    print(f"Saving checkpoint at step.. {global_step}")

    if ti_rows is not None and any(r is not None for r in ti_rows):
        tensors = {TXT_ENCODER_KEYS[i]: rows.detach().float()
                   for i, rows in enumerate(ti_rows) if rows is not None}
        save_safetensors(tensors, os.path.join(
            output_dir, f"{name}_{pretrained_model_version}_embeddings.safetensors"))

    with open(os.path.join(output_dir, "special_params.json"), "w") as f:
        json.dump(token_dict, f)

    if is_lora:
        if unet_lora is None:
            raise ValueError("is_lora=True requires a UNet adapter tree")
        save_safetensors(kohya_state_dict(unet_lora=unet_lora, te_loras=te_loras), os.path.join(
            output_dir, f"{name}_{pretrained_model_version}_lora.safetensors"))
    else:
        if unet_params is None or unet_config is None:
            raise ValueError("a full finetune checkpoint needs unet_params and unet_config")
        save_safetensors(export_ldm_unet(unet_params, unet_config),
                         os.path.join(output_dir, "unet_finetuned.safetensors"))


def find_lora_file(save_dir: str) -> Optional[str]:
    for f in sorted(os.listdir(save_dir)):
        if f.endswith("_lora.safetensors"):
            return os.path.join(save_dir, f)
    return None


def find_embeddings_file(save_dir: str) -> Optional[str]:
    for f in sorted(os.listdir(save_dir)):
        if f.endswith("embeddings.safetensors"):
            return os.path.join(save_dir, f)
    return None


def load_checkpoint(lora_save_path: str, unet_params: dict, te_params: List[Optional[dict]],
                    device="cuda") -> dict:
    """A saved checkpoint's adapters, TI rows and token map, on `device`:
    {"unet_lora", "te_loras", "ti_rows", "token_dict"}. The caller merges
    the adapters at a chosen scale (models/lora.py `merge_lora`)."""
    if not os.path.exists(lora_save_path):
        raise FileNotFoundError(f"Invalid lora_save_path: {lora_save_path}")
    token_dict = {}
    sp = os.path.join(lora_save_path, "special_params.json")
    if os.path.exists(sp):
        with open(sp) as f:
            token_dict = json.load(f)

    unet_lora, te_loras = None, [None] * len(te_params)
    lora_file = find_lora_file(lora_save_path)
    if lora_file:
        unet_lora, te_loras = load_kohya_state_dict(load_safetensors(lora_file), unet_params,
                                                    te_params, device=device)

    ti_rows: List[Optional[torch.Tensor]] = [None] * max(len(te_params), 2)
    emb_file = find_embeddings_file(lora_save_path)
    if emb_file:
        sd = load_safetensors(emb_file)
        for i, key in enumerate(TXT_ENCODER_KEYS):
            for k in (key, f"text_encoders_{i}"):  # the second: the legacy name
                if k in sd:
                    ti_rows[i] = sd[k].to(device)
                    break
    return {"unet_lora": unet_lora, "te_loras": te_loras, "ti_rows": ti_rows,
            "token_dict": token_dict}


# ---------------------------------------------------------------------------
# Resumable train state
# ---------------------------------------------------------------------------


def whole_train_state(state, plan, whole=None) -> Optional[Dict[str, torch.Tensor]]:
    """The train state's tensors under their file keys. Under fsdp a
    collective every rank enters: the shards and the optimizer state that
    `optimizer_state_shardings` shards are gathered one tensor at a time
    into rank 0's host memory, and the other ranks get None. `whole`,
    `unshard_to_rank0`'s tree where the caller has it, is reused."""
    sharded = plan is not None and plan.fsdp is not None
    main = plan is None or plan.mesh.is_main
    tensors = {
        "step": torch.tensor(state.step, dtype=torch.int64),
        "optimizer_count": torch.tensor(state.optimizer.count, dtype=torch.int64),
        "generator": state.generator.get_state(),
    }
    params = state.optimizer.params()
    if sharded and whole is None:
        whole = unshard_to_rank0(state.trainable, plan)
    if sharded and main:
        params = [t for name in state.optimizer.groups for t in group_tensors(whole[name])]
    for i, p in enumerate(params):
        tensors[f"param_{i:05d}"] = p
    specs = optimizer_state_shardings(state.optimizer, plan.specs) if sharded else {}
    for name, opt in state.optimizer.groups.items():
        for k, v in opt.state_tensors().items():
            if specs.get(f"{name}.{k}"):
                v = plan.fsdp.on_rank0(plan.fsdp.full_state(v, opt.params[state_param_index(k)]))
            tensors[f"optim.{name}.{k}"] = v
    return tensors if main else None


def save_train_state(path: str, state, plan=None, whole=None) -> None:
    """Write a TrainState (training/step.py): the trainable tensors in the
    optimizer's order, each group's optimizer state (AdamW's moments and
    step counts; Prodigy's moments, s, p0 and its 0-d d, d_max,
    d_numerator and count; AdamW8bit's uint8 indices and fp32 block scales),
    the optimizers' kinds (in the file's metadata), the update count, the
    step and the generator's state. Atomic: a crash while saving leaves the
    previous file. Under a `plan` every rank calls it and rank 0 writes;
    `whole` is `unshard_to_rank0`'s tree where the caller has it."""
    path = os.path.abspath(path)
    tensors = whole_train_state(state, plan, whole)
    if tensors is None:
        return
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    save_safetensors(tensors, tmp, metadata={"optimizers": json.dumps(state.optimizer.kinds())})
    os.replace(tmp, path)


def restore_train_state(path: str, template_state, plan=None):
    """Load a file of `save_train_state` into `template_state`, a TrainState
    of the same configuration (its tensors are overwritten in place, so the
    optimizers keep their references), and return it. A state written under
    other optimizers is refused. Under an fsdp `plan` each rank takes its
    shards of the whole tensors."""
    if os.path.isdir(path):
        raise ValueError(f"train state at {path} is a directory, not a file of save_train_state")
    path = os.path.abspath(path)
    sd = load_safetensors(path)
    params = template_state.optimizer.params()
    n_saved = sum(k.startswith("param_") for k in sd)
    if n_saved != len(params):
        raise ValueError(
            f"train state at {path} has {n_saved} tensors but the current model/optimizer "
            f"configuration has {len(params)}: resume must use the configuration it was saved with"
        )
    saved_kinds = json.loads(read_safetensors_metadata(path).get("optimizers", "null"))
    kinds = template_state.optimizer.kinds()
    if saved_kinds != kinds:
        raise ValueError(
            f"train state at {path} was written under the optimizers {saved_kinds} but this run "
            f"uses {kinds}: resume must use the optimizers it was saved with")
    sharded = plan is not None and plan.fsdp is not None
    specs = (optimizer_state_shardings(template_state.optimizer, plan.specs)
             if sharded else {})
    with torch.no_grad():
        for i, p in enumerate(params):
            v = sd[f"param_{i:05d}"]
            p.copy_(plan.fsdp.shard_of(v.to(p.device)) if sharded and plan.is_sharded(p) else v)
        optim = {}
        for k, v in sd.items():
            if not k.startswith("optim."):
                continue
            name, _, key = k[len("optim."):].partition(".")
            if specs.get(f"{name}.{key}"):
                opt = template_state.optimizer.groups[name]
                v = plan.fsdp.state_shard(key.rpartition(".")[0], v,
                                          opt.params[state_param_index(key)])
            optim[f"{name}.{key}"] = v
        template_state.optimizer.load_state_tensors(optim)
    template_state.step = int(sd["step"])
    template_state.optimizer.count = int(sd["optimizer_count"])
    template_state.generator.set_state(sd["generator"])
    return template_state
