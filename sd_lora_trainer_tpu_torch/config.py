"""Training configuration: the JAX package's `TrainingConfig` field surface.

Same field names, defaults and derived-default logic as
sd_lora_trainer_tpu/config.py (face-mode and DoRA overrides, token-list
generation, timestamped output dir), so `train_configs/*.json` parse
unchanged. A plain dataclass instead of pydantic: the port's machine has no
pydantic. Unknown JSON keys are ignored, as there; the choice-valued fields
the port branches on are validated.

Options that belong to later slices of the port raise `NotImplementedError`
naming the slice instead of being silently ignored: the `offload:` remat
policies, Prodigy and AdamW8bit.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import time
from datetime import datetime
from typing import List, Optional, Union

_CHOICES = {
    "concept_mode": ("face", "style", "object"),
    "caption_model": ("gpt4-v", "blip", "florence", "no_caption"),
    "sd_model_version": (None, "sdxl", "sd15"),
    "unet_optimizer_type": ("adamw", "prodigy", "AdamW8bit"),
    "ti_optimizer": ("adamw", "prodigy"),
    "weight_type": ("fp16", "bf16", "fp32"),
    "text_encoder_lora_optimizer": (None, "adamw"),
    "sharding_mode": ("dp", "fsdp", "tp"),
}


def sanitize_name(name: str, max_length: int = 255) -> str:
    """Replace special characters with underscores (artifact filenames embed
    this name, so the mapping matches the JAX package's)."""
    cleaned = re.sub(r"[^\w.-]+", "_", name)
    cleaned = re.sub(r"_+", "_", cleaned)
    cleaned = cleaned.strip("_.")
    cleaned = cleaned.lstrip(".")
    cleaned = cleaned[:max_length]
    if not cleaned:
        raise ValueError("Malformed name")
    return cleaned


@dataclasses.dataclass
class TrainingConfig:
    lora_training_urls: str
    concept_mode: str
    caption_prefix: str = ""
    prompt_modifier: Optional[str] = None
    caption_model: str = "florence"
    caption_dropout: float = 0.1
    sd_model_version: Optional[str] = None
    ckpt_path: Optional[str] = None
    pretrained_model: Optional[dict] = None
    seed: Optional[int] = None
    resolution: int = 512
    validation_img_size: Optional[Union[int, List[int]]] = None
    train_img_size: Optional[List[int]] = None
    train_aspect_ratio: Optional[float] = None
    train_batch_size: int = 4
    max_train_steps: int = 300
    num_train_epochs: Optional[int] = None
    checkpointing_steps: int = 10000
    gradient_accumulation_steps: int = 1
    is_lora: bool = True

    unet_optimizer_type: str = "adamw"
    unet_lr_warmup_steps: Optional[int] = None
    unet_lr: float = 0.0003
    prodigy_d_coef: float = 1.0
    unet_prodigy_growth_factor: float = 1.05
    lora_weight_decay: float = 0.004

    ti_lr: float = 0.001
    token_warmup_steps: int = 0
    ti_weight_decay: float = 0.0
    ti_optimizer: str = "adamw"
    freeze_ti_after_completion_f: float = 0.7
    freeze_unet_before_completion_f: float = 0.0

    token_attention_loss_w: float = 3e-7
    cond_reg_w: float = 0.0e-5
    tok_cond_reg_w: float = 0.0e-5
    tok_cov_reg_w: float = 0.0
    l1_penalty: float = 0.03

    noise_offset: float = 0.02
    snr_gamma: float = 5.0
    lora_alpha_multiplier: float = 1.0
    lora_rank: int = 16
    use_dora: bool = False

    left_right_flip_augmentation: bool = True
    augment_imgs_up_to_n: int = 40
    mask_target_prompts: Optional[str] = None
    crop_based_on_salience: bool = True
    use_face_detection_instead: bool = False
    clipseg_temperature: float = 0.5
    n_sample_imgs: int = 4
    name: Optional[str] = None
    output_dir: str = "eden_lora_training_runs"
    debug: bool = False
    allow_tf32: bool = True
    disable_ti: bool = False
    skip_gpt_cleanup: bool = False
    weight_type: str = "bf16"
    n_tokens: int = 3
    inserting_list_tokens: List[str] = dataclasses.field(
        default_factory=lambda: ["<s0>", "<s1>", "<s2>"]
    )
    token_dict: dict = dataclasses.field(default_factory=lambda: {"TOK": "<s0><s1><s2>"})
    device: str = "cuda"
    sample_imgs_lora_scale: Optional[float] = None
    dataloader_num_workers: int = 0
    training_attributes: dict = dataclasses.field(default_factory=dict)
    aspect_ratio_bucketing: bool = False
    start_time: float = 0.0
    job_time: float = 0.0

    text_encoder_lora_optimizer: Optional[str] = None
    text_encoder_lora_lr: float = 1.0e-5
    txt_encoders_lr_warmup_steps: int = 200
    text_encoder_lora_weight_decay: float = 1.0e-5
    text_encoder_lora_rank: int = 16

    # Extensions of the JAX package, kept for the JSON surface.
    mesh_data_parallel: int = 0
    sharding_mode: str = "dp"
    mesh_model_parallel: int = 2
    remat: Union[bool, str] = "auto"
    remat_stash8: str = ""
    quantize_base: str = "auto"
    fuse_qkv: bool = True
    prewarm_compile: bool = True
    steps_per_call: int = 4
    save_train_state: bool = False
    resume_from: Optional[str] = None
    _testing_no_output_dir: bool = False

    def __post_init__(self):
        for field, allowed in _CHOICES.items():
            if getattr(self, field) not in allowed:
                raise ValueError(f"{field}={getattr(self, field)!r} not in {allowed}")

        if not self.ckpt_path:
            if self.sd_model_version is not None:
                self.pretrained_model = {"path": None, "url": None, "version": self.sd_model_version}
        else:
            self.pretrained_model = {
                "path": self.ckpt_path, "url": None, "version": self.sd_model_version,
            }

        if not self.name:
            self.name = os.path.basename(self.lora_training_urls)[:40]
        self.name = sanitize_name(self.name)

        if not self._testing_no_output_dir:
            # the path only: the directory is made by the train loop
            timestamp = datetime.now().strftime("%d%b_%H%M")
            self.output_dir = (
                self.output_dir
                + f"/{self.name}_{timestamp}-{self.concept_mode}_res{self.resolution}"
                + f"_{self.max_train_steps}steps"
            )

        if self.seed is None:
            self.seed = int(time.time())
        if self.unet_lr_warmup_steps is None:
            self.unet_lr_warmup_steps = self.max_train_steps
        if self.checkpointing_steps < 1:
            self.checkpointing_steps = self.max_train_steps

        if self.concept_mode == "face":
            self.left_right_flip_augmentation = False
            self.mask_target_prompts = "face"

        if self.use_dora:
            self.l1_penalty = 0.0
            self.lora_weight_decay = 0.0
            self.text_encoder_lora_weight_decay = 0.0

        self.inserting_list_tokens = [f"<s{i}>" for i in range(self.n_tokens)]
        self.token_dict = {"TOK": "".join(self.inserting_list_tokens)}
        self.start_time = time.time()

    def resolve_quantize_base(self) -> str:
        """Concrete "none" | "int8" | "int8+te" for quantize_base="auto", as
        the JAX package resolves it: "auto" is int8 for SDXL and "none"
        otherwise; full finetune (the base trains) and tp (its sharding
        specs match bf16 weights) get "none" even when int8 was asked for.
        The JAX choice rests on TPU measurements; an H100-specific "auto"
        waits for the port's benchmark."""
        q = self.quantize_base
        if q not in ("auto", "none", "int8", "int8+te"):
            raise ValueError(f"unknown quantize_base {q!r}")
        if q == "auto":
            q = "int8" if self.sd_model_version == "sdxl" else "none"
        if q in ("int8", "int8+te") and (not self.is_lora or self.sharding_mode == "tp"):
            return "none"
        return q

    @classmethod
    def from_dict(cls, data: dict) -> "TrainingConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in names})

    @classmethod
    def from_json(cls, file_path: str) -> "TrainingConfig":
        with open(file_path, "r") as f:
            return cls.from_dict(json.load(f))
