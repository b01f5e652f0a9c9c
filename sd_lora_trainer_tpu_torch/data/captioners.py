"""Pluggable captioning and segmentation backends (host-side).

Counterpart of sd_lora_trainer_tpu/data/captioners.py, with its
availability gating and degradation record:

- "no_caption": always available (empty/user captions pass through);
- "blip" / "florence": need the HF weights staged under model_paths and the
  `transformers` package, imported when a captioner runs;
- "gpt4-v" and the GPT caption cleanup: need OPENAI_API_KEY;
- CLIPSeg masks need staged weights; otherwise masks degrade to all-ones
  (style mode uses uniform masks anyway).

Every fallback is recorded in `DEGRADATIONS`, which preprocess() copies
into config.training_attributes, so a weaker run shows in its saved
training_args.json.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
from PIL import Image

from sd_lora_trainer_tpu_torch.config import model_paths

# Every availability fallback of the host pipeline records what it degraded
# to; preprocess() resets the list and copies it into the config.

DEGRADATIONS: list = []


def reset_degradations() -> None:
    DEGRADATIONS.clear()


def record_degradation(stage: str, wanted: str, got: str, detail: str = "") -> None:
    import sys

    DEGRADATIONS.append({"stage": stage, "wanted": wanted, "got": got, "detail": detail})
    print(
        f"[DEGRADED] {stage}: wanted '{wanted}', running with '{got}'."
        + (f" {detail}" if detail else ""),
        file=sys.stderr,
        flush=True,
    )


def captioner_available(name: str) -> bool:
    if name == "no_caption":
        return True
    if name == "gpt4-v":
        return bool(os.environ.get("OPENAI_API_KEY"))
    if name in ("blip", "florence"):
        return _hf_model_dir(name) is not None
    return False


def _hf_model_dir(name: str) -> Optional[str]:
    base = model_paths.get_path("BLIP" if name == "blip" else "FLORENCE")
    if not base:
        return None
    candidates = {
        "blip": ["blip-image-captioning-large", "blip"],
        "florence": ["Florence-2-large", "florence"],
    }[name]
    for c in candidates:
        path = os.path.join(base, c)
        if os.path.isdir(path) and os.listdir(path):
            return path
    return None


def caption_dataset(
    images: List[Image.Image],
    captions: List[Optional[str]],
    caption_model: str = "no_caption",
    batch_size: int = 8,
) -> List[str]:
    """Fill None captions using the chosen backend
    (reference: preprocess.py:556-581)."""
    if all(c is not None for c in captions):
        return [c for c in captions]

    if caption_model == "no_caption" or not captioner_available(caption_model):
        if caption_model != "no_caption":
            record_degradation(
                "captioning", caption_model, "no_caption",
                "backend weights not staged / API key missing; captions are empty",
            )
        return [c if c is not None else "" for c in captions]

    if caption_model == "blip":
        return _blip_captions(images, captions, batch_size)
    if caption_model == "florence":
        return _florence_captions(images, captions)
    if caption_model == "gpt4-v":
        return _gpt4v_captions(images, captions)
    return [c if c is not None else "" for c in captions]


def _blip_captions(images, captions, batch_size):
    import torch
    from transformers import BlipForConditionalGeneration, BlipProcessor

    model_dir = _hf_model_dir("blip")
    processor = BlipProcessor.from_pretrained(model_dir)
    model = BlipForConditionalGeneration.from_pretrained(model_dir).eval()
    out = list(captions)
    todo = [i for i, c in enumerate(captions) if c is None]
    for start in range(0, len(todo), batch_size):
        idxs = todo[start : start + batch_size]
        inputs = processor(images=[images[i] for i in idxs], return_tensors="pt")
        with torch.no_grad():
            ids = model.generate(**inputs, max_new_tokens=50)
        texts = processor.batch_decode(ids, skip_special_tokens=True)
        for i, t in zip(idxs, texts):
            out[i] = t.strip()
    del model
    return out


def _florence_captions(images, captions):
    import torch
    from transformers import AutoModelForCausalLM, AutoProcessor

    model_dir = _hf_model_dir("florence")
    processor = AutoProcessor.from_pretrained(model_dir, trust_remote_code=True)
    model = AutoModelForCausalLM.from_pretrained(model_dir, trust_remote_code=True).eval()
    out = list(captions)
    prompt = "<CAPTION>"
    for i, c in enumerate(captions):
        if c is not None:
            continue
        inputs = processor(text=prompt, images=images[i], return_tensors="pt")
        with torch.no_grad():
            ids = model.generate(
                input_ids=inputs["input_ids"], pixel_values=inputs["pixel_values"],
                max_new_tokens=256, num_beams=3,
            )
        text = processor.batch_decode(ids, skip_special_tokens=False)[0]
        parsed = processor.post_process_generation(
            text, task=prompt, image_size=(images[i].width, images[i].height)
        )
        out[i] = str(parsed.get(prompt, "")).strip()
    del model
    return out


def _gpt4v_captions(images, captions):
    """GPT-4o vision captioning (reference: preprocess.py:443-498)."""
    import base64
    import io as _io
    from concurrent.futures import ThreadPoolExecutor

    from openai import OpenAI  # type: ignore

    client = OpenAI()
    out = list(captions)

    def one(i):
        buf = _io.BytesIO()
        images[i].save(buf, format="JPEG", quality=90)
        b64 = base64.b64encode(buf.getvalue()).decode()
        resp = client.chat.completions.create(
            model="gpt-4o",
            messages=[
                {
                    "role": "user",
                    "content": [
                        {"type": "text", "text": "Concisely describe this image without assumptions, max 20 words."},
                        {"type": "image_url", "image_url": {"url": f"data:image/jpeg;base64,{b64}"}},
                    ],
                }
            ],
            max_tokens=60,
        )
        return i, resp.choices[0].message.content.strip()

    todo = [i for i, c in enumerate(captions) if c is None]
    with ThreadPoolExecutor(max_workers=4) as pool:
        for i, text in pool.map(one, todo):
            out[i] = text
    return out


# ---------------------------------------------------------------------------
# Segmentation
# ---------------------------------------------------------------------------


def clipseg_available() -> bool:
    base = model_paths.get_path("CLIP")
    if not base:
        return False
    for c in ("clipseg-rd64-refined", "clipseg"):
        path = os.path.join(base, c)
        if os.path.isdir(path) and os.listdir(path):
            return True
    return False


def generate_masks(
    images: List[Image.Image],
    target_prompts: str,
    temperature: float = 0.5,
    bias: float = 0.05,
    use_face_detection: bool = False,
) -> List[Image.Image]:
    """CLIPSeg semantic masks (preprocess.py:166-232) with all-ones fallback.

    Empty prompt (style mode) => uniform masks, matching the reference's
    temp=999 uniform-softmax behavior (preprocess.py:834-838)."""
    if not target_prompts or not clipseg_available():
        if target_prompts and not use_face_detection:
            record_degradation(
                "segmentation", f"clipseg('{target_prompts}')", "full-image masks",
                "CLIPSeg weights not staged; masked loss weighting is inactive",
            )
        return [Image.new("L", img.size, 255) for img in images]

    import torch
    from transformers import CLIPSegForImageSegmentation, CLIPSegProcessor

    base = model_paths.get_path("CLIP")
    model_dir = None
    for c in ("clipseg-rd64-refined", "clipseg"):
        path = os.path.join(base, c)
        if os.path.isdir(path):
            model_dir = path
            break
    processor = CLIPSegProcessor.from_pretrained(model_dir)
    model = CLIPSegForImageSegmentation.from_pretrained(model_dir).eval()

    masks = []
    for img in images:
        inputs = processor(
            text=[target_prompts], images=[img], return_tensors="pt", padding=True
        )
        with torch.no_grad():
            logits = model(**inputs).logits
        probs = torch.sigmoid(logits / temperature)[0].numpy()
        probs = np.clip(probs + bias, 0.0, 1.0)
        mask = Image.fromarray((probs * 255).astype(np.uint8)).resize(img.size, Image.BICUBIC)
        masks.append(mask)
    del model
    return masks
