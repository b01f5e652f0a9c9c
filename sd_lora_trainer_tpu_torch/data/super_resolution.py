"""Swin2SR super-resolution for small, low-res datasets (host-side stage).

Counterpart of sd_lora_trainer_tpu/data/super_resolution.py: datasets under
50 images get every image below 0.75x the train size upscaled before
augmentation. Gated on weights staged under model_paths["SR"] and the
`transformers` package (imported when it runs); when the weights are absent
the stage passes the images through and the caller records a degradation.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image

from sd_lora_trainer_tpu_torch.config import model_paths

# Directory names probed under model_paths["SR"] for a staged Swin2SR model
# (any transformers save_pretrained dir with model_type=swin2sr works).
_SR_CANDIDATES = (
    "swin2SR-realworld-sr-x4-64-bsrgan-psnr",
    "swin2SR-classical-sr-x4-48",
    "swin2SR-classical-sr-x2-64",
    "swin2sr",
    "sr",
)


def sr_model_dir() -> Optional[str]:
    """Locate a staged Swin2SR model directory, or None."""
    base = model_paths.get_path("SR")
    if not base:
        return None
    candidates = list(_SR_CANDIDATES)
    if os.path.isdir(base):
        candidates += sorted(
            d for d in os.listdir(base) if "swin2sr" in d.lower()
        )
    for c in candidates:
        path = os.path.join(base, c)
        if os.path.isfile(os.path.join(path, "config.json")):
            return path
    # base itself may be the model dir
    if os.path.isfile(os.path.join(base, "config.json")):
        return base
    return None


def sr_available() -> bool:
    return sr_model_dir() is not None


def swin_ir_sr(
    images: List[Image.Image],
    target_size: Optional[Tuple[int, int]] = None,
    model_dir: Optional[str] = None,
) -> List[Image.Image]:
    """Upscale images below `target_size` with Swin2SR; larger images pass
    through unchanged (reference: trainer/preprocess.py:118-163).

    Raises if no model is staged — callers gate on `sr_available()`.
    """
    import torch
    from transformers import Swin2SRForImageSuperResolution, Swin2SRImageProcessor

    model_dir = model_dir or sr_model_dir()
    if model_dir is None:
        raise FileNotFoundError(
            "No Swin2SR weights staged under model_paths['SR'] "
            f"({model_paths.get_path('SR')})"
        )
    model = Swin2SRForImageSuperResolution.from_pretrained(model_dir)
    model.eval()
    processor = Swin2SRImageProcessor()

    out_images: List[Image.Image] = []
    with torch.no_grad():
        for image in images:
            ori_w, ori_h = image.size
            if target_size is not None and ori_w >= target_size[0] and ori_h >= target_size[1]:
                out_images.append(image)
                continue
            inputs = processor(image.convert("RGB"), return_tensors="pt")
            outputs = model(**inputs)
            rec = outputs.reconstruction.data.squeeze().float().cpu().clamp_(0, 1).numpy()
            rec = np.moveaxis(rec, 0, -1)
            out_images.append(Image.fromarray((rec * 255.0).round().astype(np.uint8)))
    del model
    return out_images


def maybe_upscale_small_dataset(
    images: List[Image.Image],
    train_img_size: Tuple[int, int],
    max_imgs_for_sr: int = 50,
    upscale_margin: float = 0.75,
) -> Tuple[List[Image.Image], Optional[str]]:
    """The preprocess-pipeline entry: upscale datasets under `max_imgs_for_sr`
    images whose dims fall below margin*train size (reference:
    trainer/preprocess.py:785-788). Returns (images, backend) where backend is
    'swin2sr', 'passthrough' (nothing needed upscaling), or None (degraded:
    weights not staged while upscaling WAS needed — caller records it)."""
    if len(images) >= max_imgs_for_sr:
        return images, "passthrough"
    threshold = (
        int(train_img_size[0] * upscale_margin),
        int(train_img_size[1] * upscale_margin),
    )
    needs = [im for im in images if im.size[0] < threshold[0] or im.size[1] < threshold[1]]
    if not needs:
        return images, "passthrough"
    if not sr_available():
        return images, None
    return swin_ir_sr(images, target_size=threshold), "swin2sr"
