"""ComfyUI node front-end of the port (counterpart of the root node.py).

Registers an `Eden_LoRa_trainer` node with the same widget schema, return
types, function and category; redirects the model cache paths into
ComfyUI's model folders when ComfyUI's `folder_paths` exists; drives the
port's `train` generator under a ProgressBar; and returns (the validation
grids as a float torch tensor [n, H, W, 3] in [0, 1], lora_path,
embedding_path, message). Importable without ComfyUI: registration happens
through sd_lora_trainer_tpu_torch/comfyui_init.py inside a ComfyUI install.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from sd_lora_trainer_tpu_torch.config import TrainingConfig, model_paths
from sd_lora_trainer_tpu_torch.main import train


class Eden_LoRa_trainer:
    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "name": ("STRING", {"default": "concept"}),
                "training_images_folder": ("STRING", {"default": ""}),
                "mode": (["style", "face", "object"],),
                "sd_model_version": (["sdxl", "sd15"],),
                "training_resolution": ("INT", {"default": 512, "min": 256, "max": 1536}),
                "train_batch_size": ("INT", {"default": 4, "min": 1, "max": 16}),
                "max_train_steps": ("INT", {"default": 300, "min": 10, "max": 10000}),
                "ti_lr": ("FLOAT", {"default": 0.001, "step": 0.0001}),
                "unet_lr": ("FLOAT", {"default": 0.0003, "step": 0.0001}),
                "lora_rank": ("INT", {"default": 16, "min": 1, "max": 128}),
                "n_tokens": ("INT", {"default": 3, "min": 1, "max": 4}),
                "seed": ("INT", {"default": 0}),
            }
        }

    RETURN_TYPES = ("IMAGE", "STRING", "STRING", "STRING")
    RETURN_NAMES = ("validation_grid", "lora_path", "embedding_path", "msg")
    FUNCTION = "train_lora"
    CATEGORY = "Eden"

    def train_lora(
        self,
        name,
        training_images_folder,
        mode,
        sd_model_version,
        training_resolution,
        train_batch_size,
        max_train_steps,
        ti_lr,
        unet_lr,
        lora_rank,
        n_tokens,
        seed,
    ):
        try:
            import folder_paths  # ComfyUI's runtime

            for key in ("SD", "CLIP", "BLIP", "FLORENCE", "SR"):
                model_paths.set_path(key, os.path.join(folder_paths.models_dir, "eden", key.lower()))
        except ImportError:
            pass

        config = TrainingConfig(
            name=name,
            lora_training_urls=training_images_folder,
            concept_mode=mode,
            sd_model_version=sd_model_version,
            resolution=training_resolution,
            train_batch_size=train_batch_size,
            max_train_steps=max_train_steps,
            ti_lr=ti_lr,
            unet_lr=unet_lr,
            lora_rank=lora_rank,
            n_tokens=n_tokens,
            seed=seed,
        )

        try:
            from comfy.utils import ProgressBar

            pbar = ProgressBar(100)
        except ImportError:
            pbar = None

        gen = train(config)
        while True:
            try:
                progress = next(gen)
                if pbar is not None:
                    pbar.update_absolute(int(progress * 100))
            except StopIteration as e:
                config, output_dir = e.value
                break

        lora_path, embedding_path = "", ""
        for f in os.listdir(output_dir):
            if f.endswith("_lora.safetensors"):
                lora_path = os.path.join(output_dir, f)
            elif f.endswith("embeddings.safetensors"):
                embedding_path = os.path.join(output_dir, f)

        from PIL import Image

        grids = [np.asarray(Image.open(os.path.join(output_dir, f)), np.float32)[None] / 255.0
                 for f in sorted(os.listdir(output_dir)) if "grid" in f and f.endswith(".jpg")]
        grid_stack = np.concatenate(grids, axis=0) if grids else np.zeros((1, 64, 64, 3), np.float32)

        msg = f"Trained LoRA '{config.name}' for {max_train_steps} steps -> {output_dir}"
        return (torch.from_numpy(grid_stack), lora_path, embedding_path, msg)


NODE_CLASS_MAPPINGS = {"Eden_LoRa_trainer": Eden_LoRa_trainer}
NODE_DISPLAY_NAME_MAPPINGS = {"Eden_LoRa_trainer": "Eden LoRa Trainer (PyTorch)"}
