"""Checkpoint save/load: the artifact contract, and a resumable train state.

Counterpart of sd_lora_trainer_tpu/checkpoint.py. `save_checkpoint` writes
the JAX package's artifact set, under the same names:

    {name}_{version}_embeddings.safetensors   TI rows, keys clip_l / clip_g
    special_params.json                       token map {"TOK": "<s0><s1><s2>"}
    {name}_{version}_lora.safetensors         kohya/WebUI LoRA (ComfyUI/A1111)
    unet_finetuned.safetensors (full finetune) LDM-layout UNet

`load_checkpoint` reads them back. `save_train_state` and
`restore_train_state` keep what a run needs to resume (one process): the
trainable tensors, AdamW's moments and counts, the step and the generator's
state, in one flat safetensors file written atomically. The files are
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
from sd_lora_trainer_tpu_torch.training.embeddings import TXT_ENCODER_KEYS
from sd_lora_trainer_tpu_torch.utils.safetensors_io import load_safetensors, save_safetensors


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


def _params(state) -> List[torch.Tensor]:
    return [p for g in state.optimizer.opt.param_groups for p in g["params"]]


def save_train_state(path: str, state) -> None:
    """Write a TrainState (training/step.py): the trainable tensors in the
    optimizer's order, AdamW's exp_avg/exp_avg_sq/step per tensor, the
    update count, the step and the generator's state. Atomic: a crash while
    saving leaves the previous file."""
    path = os.path.abspath(path)
    tensors = {
        "step": torch.tensor(state.step, dtype=torch.int64),
        "optimizer_count": torch.tensor(state.optimizer.count, dtype=torch.int64),
        "generator": state.generator.get_state(),
    }
    opt_state = state.optimizer.opt.state
    for i, p in enumerate(_params(state)):
        tensors[f"param_{i:05d}"] = p
        for key, value in opt_state.get(p, {}).items():
            tensors[f"adam_{key}_{i:05d}"] = value
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    save_safetensors(tensors, tmp)
    os.replace(tmp, path)


def restore_train_state(path: str, template_state):
    """Load a file of `save_train_state` into `template_state`, a TrainState
    of the same configuration (its tensors are overwritten in place, so the
    optimizer keeps its references), and return it."""
    if os.path.isdir(path):
        raise ValueError(f"train state at {path} is a directory, not a file of save_train_state")
    sd = load_safetensors(os.path.abspath(path))
    params = _params(template_state)
    n_saved = sum(k.startswith("param_") for k in sd)
    if n_saved != len(params):
        raise ValueError(
            f"train state at {path} has {n_saved} tensors but the current model/optimizer "
            f"configuration has {len(params)}: resume must use the configuration it was saved with"
        )
    adam: Dict[str, dict] = {}
    for k, v in sd.items():
        if k.startswith("adam_"):
            key, _, idx = k[len("adam_"):].rpartition("_")
            adam.setdefault(idx, {})[key] = v
    opt_state = template_state.optimizer.opt.state
    with torch.no_grad():
        for i, p in enumerate(params):
            p.copy_(sd[f"param_{i:05d}"])
            entry = adam.get(f"{i:05d}")
            if entry:
                # AdamW keeps its 0-d step count on the CPU unless it is fused
                opt_state[p] = {k: v if v.ndim == 0 else v.to(p.device) for k, v in entry.items()}
    template_state.step = int(sd["step"])
    template_state.optimizer.count = int(sd["optimizer_count"])
    template_state.generator.set_state(sd["generator"])
    return template_state
