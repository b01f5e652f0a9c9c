"""CLIP-metric evaluation of a trained checkpoint's renders.

    python -m sd_lora_trainer_tpu_torch.scripts.auto_eval_model CHECKPOINT_DIR
        [--training_images DIR] [--output PATH] [--device cuda]

Counterpart of the JAX package's scripts/auto_eval_model.py: scores the
checkpoint's rendered jpgs (validation grids left out) by pairwise CLIP
diversity (1 - cosine), image-text alignment with the validation prompts
in training_args.json, and similarity to the training images, and writes a
JSON report beside the checkpoint (eval_report.json). The scorer is a
transformers CLIPModel staged under model_paths["CLIP"]
(clip-vit-base-patch32 or clip); nothing is downloaded. Without one the
report carries the JAX script's "error" entry instead of the metrics.
The scorer runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import numpy as np
import torch
from PIL import Image

from sd_lora_trainer_tpu_torch.scripts import resolve_device


def get_all_jpg_filenames(folder: str) -> List[str]:
    files = [os.path.join(folder, f) for f in sorted(os.listdir(folder))
             if f.lower().endswith(".jpg")]
    if not files:
        raise FileNotFoundError(f"no jpg file in {folder}")
    return files


def _load_clip_scorer(device: torch.device):
    """(model on `device`, processor) of a staged CLIP scorer, or (None, None)."""
    from sd_lora_trainer_tpu_torch.config import model_paths

    base = model_paths.get_path("CLIP")
    for candidate in ("clip-vit-base-patch32", "clip"):
        path = os.path.join(base or ".", candidate)
        if os.path.isdir(path):
            from transformers import CLIPModel, CLIPProcessor

            model = CLIPModel.from_pretrained(path).eval().to(device)
            return model, CLIPProcessor.from_pretrained(path)
    return None, None


class Evaluation:
    """CLIP metrics of a list of generated images."""

    def __init__(self, image_filenames: List[str], device: torch.device):
        self.image_filenames = image_filenames
        self.device = device
        self.model, self.processor = _load_clip_scorer(device)
        self._image_features: Optional[np.ndarray] = None

    @property
    def available(self) -> bool:
        return self.model is not None

    def _on_device(self, inputs) -> dict:
        return {k: v.to(self.device) if torch.is_tensor(v) else v for k, v in inputs.items()}

    def _encode_images(self, filenames) -> np.ndarray:
        feats = []
        for f in filenames:
            inputs = self.processor(images=Image.open(f).convert("RGB"), return_tensors="pt")
            with torch.no_grad():
                feats.append(self.model.get_image_features(**self._on_device(inputs))
                             .float().cpu().numpy())
        return np.concatenate(feats, axis=0)

    def image_features(self) -> np.ndarray:
        if self._image_features is None:
            self._image_features = self._encode_images(self.image_filenames)
        return self._image_features

    def _encode_texts(self, prompts) -> np.ndarray:
        inputs = self.processor(text=prompts, return_tensors="pt", padding=True, truncation=True)
        with torch.no_grad():
            return self.model.get_text_features(**self._on_device(inputs)).float().cpu().numpy()

    @staticmethod
    def _cos_matrix(a: np.ndarray, b: np.ndarray, eps=1e-8) -> np.ndarray:
        a = a / np.maximum(np.linalg.norm(a, axis=1, keepdims=True), eps)
        b = b / np.maximum(np.linalg.norm(b, axis=1, keepdims=True), eps)
        return a @ b.T

    def clip_diversity(self) -> float:
        """Mean pairwise (1 - cosine) over the images: higher is more diverse."""
        f = self.image_features()
        sim = self._cos_matrix(f, f)
        off_diag = sim[~np.eye(sim.shape[0], dtype=bool)]
        return float((1.0 - off_diag).mean())

    def image_text_alignment(self, prompts: List[str]) -> float:
        return float(self._cos_matrix(self.image_features(), self._encode_texts(prompts))
                     .diagonal().mean())

    def training_image_alignment(self, training_image_filenames: List[str]) -> float:
        return float(self._cos_matrix(self.image_features(),
                                      self._encode_images(training_image_filenames)).mean())


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("checkpoint_dir", help="trained checkpoint folder")
    parser.add_argument("--training_images", default=None, help="folder of training jpgs")
    parser.add_argument("--output", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    image_files = [f for f in get_all_jpg_filenames(args.checkpoint_dir)
                   if "grid" not in os.path.basename(f)]
    with open(os.path.join(args.checkpoint_dir, "training_args.json")) as f:
        training_args = json.load(f)
    prompts = training_args.get("training_attributes", {}).get("validation_prompts", [])

    evaluation = Evaluation(image_files, device)
    report = {"checkpoint": args.checkpoint_dir, "n_images": len(image_files)}
    if not evaluation.available:
        report["error"] = "CLIP scorer weights not staged under model_paths['CLIP']"
    else:
        report["clip_diversity"] = evaluation.clip_diversity()
        if prompts and len(prompts) == len(image_files):
            report["image_text_alignment"] = evaluation.image_text_alignment(prompts)
        if args.training_images:
            report["training_image_alignment"] = evaluation.training_image_alignment(
                get_all_jpg_filenames(args.training_images))

    out = args.output or os.path.join(args.checkpoint_dir, "eval_report.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
