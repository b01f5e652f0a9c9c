"""Prompt conditioning: token ids -> UNet conditioning tensors.

Counterpart of sd_lora_trainer_tpu/models/conditioning.py. SD1.5 conditions
on CLIP-L's final hidden state; SDXL concatenates both encoders' penultimate
states, takes the pooled projection from TE2, and appends the
micro-conditioning time ids with the reference's deliberate
original_size=(1024, 1024).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from sd_lora_trainer_tpu_torch.models.clip import CLIPTextConfig, clip_text_forward
from sd_lora_trainer_tpu_torch.utils.utils import kept_on_card


def sd15_conditioning(te1_params: dict, input_ids: torch.Tensor, cfg: CLIPTextConfig,
                      ti_rows: Optional[torch.Tensor] = None, dtype=torch.bfloat16):
    out = clip_text_forward(te1_params, input_ids, cfg, ti_embeddings=ti_rows, dtype=dtype)
    return out["last"], None, None


def sdxl_conditioning(
    te1_params: dict,
    te2_params: dict,
    input_ids_1: torch.Tensor,  # [B, 77] CLIP-L ids
    input_ids_2: torch.Tensor,  # [B, 77] CLIP-G ids
    cfg1: CLIPTextConfig,
    cfg2: CLIPTextConfig,
    resolution: Tuple[int, int],  # (W, H)
    ti_rows_1: Optional[torch.Tensor] = None,
    ti_rows_2: Optional[torch.Tensor] = None,
    dtype=torch.bfloat16,
):
    """Returns (prompt_embeds [B,77,2048], pooled [B,1280], add_time_ids [B,6])."""
    o1 = clip_text_forward(te1_params, input_ids_1, cfg1, ti_embeddings=ti_rows_1, dtype=dtype)
    o2 = clip_text_forward(te2_params, input_ids_2, cfg2, ti_embeddings=ti_rows_2, dtype=dtype)
    prompt_embeds = torch.cat([o1["penultimate"], o2["penultimate"]], dim=-1)
    b = input_ids_1.shape[0]
    add_time_ids = _time_ids(tuple(resolution), prompt_embeds.device).repeat(b, 1)
    return prompt_embeds, o2["pooled"], add_time_ids


@kept_on_card
def _time_ids(resolution: Tuple[int, int], device) -> torch.Tensor:
    """[1, 6] SDXL time ids for (W, H)."""
    return torch.tensor([[1024, 1024, 0, 0, resolution[1], resolution[0]]], dtype=torch.float32,
                        device=device)
