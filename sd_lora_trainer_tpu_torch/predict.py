"""Replicate cog front-end of the port (counterpart of the root predict.py).

The same typed Input surface and defaults: it builds a TrainingConfig,
streams CogOutput progress from the port's `train` generator, and tars the
final checkpoint directory. The run trains on the CUDA card (the config's
default device). `cog` is optional: without it, stand-ins keep the module
importable for tests and local runs.

    cog predict -i lora_training_urls=... (with `predict:` in cog.yaml set to
    "sd_lora_trainer_tpu_torch/predict.py:Predictor")
"""

from __future__ import annotations

import os
import tarfile
from typing import Iterator, Optional

try:  # cog only exists inside the Replicate image
    from cog import BaseModel, BasePredictor, Input, Path as cogPath

    COG_AVAILABLE = True
except ImportError:  # local / test stand-ins
    COG_AVAILABLE = False

    class BaseModel:  # type: ignore
        def __init__(self, **kw):
            for k, v in kw.items():
                setattr(self, k, v)

    class BasePredictor:  # type: ignore
        pass

    def Input(description="", default=None, choices=None, ge=None, le=None):  # type: ignore
        return default

    cogPath = str  # type: ignore

from sd_lora_trainer_tpu_torch.config import TrainingConfig
from sd_lora_trainer_tpu_torch.main import train


class CogOutput(BaseModel):
    files: Optional[list] = []
    name: Optional[str] = None
    thumbnails: Optional[list] = []
    attributes: Optional[dict] = None
    progress: Optional[float] = None
    isFinal: bool = False


class Predictor(BasePredictor):
    def setup(self):
        print("cog:setup")

    def predict(
        self,
        name: str = Input(description="Name of new LORA concept", default="unnamed"),
        lora_training_urls: str = Input(
            description="Training images for new LORA concept (image urls or an url to a .zip of images)"
        ),
        concept_mode: str = Input(
            description="What are you trying to learn?",
            choices=["style", "face", "object"],
            default="style",
        ),
        sd_model_version: str = Input(
            description="Base model version", choices=["sdxl", "sd15"], default="sdxl"
        ),
        max_train_steps: int = Input(description="Number of training steps", default=300),
        checkpointing_steps: int = Input(
            description="Save a checkpoint every n steps", default=10000
        ),
        resolution: int = Input(description="Training resolution", default=512),
        unet_lr: float = Input(description="Final unet learning rate", default=0.0003),
        ti_lr: float = Input(description="Textual-inversion learning rate", default=0.001),
        lora_rank: int = Input(description="LoRA rank for the unet", default=16),
        n_tokens: int = Input(description="Number of new TI tokens", ge=1, le=4, default=3),
        train_batch_size: int = Input(description="Per-device batch size", default=4),
        n_sample_imgs: int = Input(description="Validation grid size", default=4),
        validation_img_size: int = Input(description="Validation render size", default=1024),
        sample_imgs_lora_scale: float = Input(
            description="LoRA scale for sample renders", default=None
        ),
        seed: int = Input(description="Random seed", default=None),
    ) -> Iterator[CogOutput]:
        print("cog:predict starting new training job...")
        yield CogOutput(name=name, progress=0.0)

        config = TrainingConfig(
            name=name,
            lora_training_urls=lora_training_urls,
            concept_mode=concept_mode,
            sd_model_version=sd_model_version,
            max_train_steps=max_train_steps,
            checkpointing_steps=checkpointing_steps,
            resolution=resolution,
            unet_lr=unet_lr,
            ti_lr=ti_lr,
            lora_rank=lora_rank,
            n_tokens=n_tokens,
            train_batch_size=train_batch_size,
            n_sample_imgs=n_sample_imgs,
            validation_img_size=validation_img_size,
            sample_imgs_lora_scale=sample_imgs_lora_scale,
            seed=seed,
        )

        train_generator = train(config)
        while True:
            try:
                progress = next(train_generator)
                yield CogOutput(name=name, progress=round(progress, 2))
            except StopIteration as e:
                config, output_save_dir = e.value
                break

        attributes = dict(config.training_attributes)
        tarball = os.path.join(str(config.output_dir), f"{name}.tar")
        with tarfile.open(tarball, "w") as tar:
            tar.add(output_save_dir, arcname=name)
        yield CogOutput(
            files=[cogPath(tarball)],
            name=name,
            attributes=attributes,
            progress=1.0,
            isFinal=True,
        )
