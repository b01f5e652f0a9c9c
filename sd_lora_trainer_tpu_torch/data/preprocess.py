"""One-shot dataset curation (counterpart of sd_lora_trainer_tpu/data/preprocess.py).

A host-side pipeline, run once before training: copy/unzip -> EXIF-aware
load -> (optional SR upscale) -> LR-flip augmentation -> captioning -> TOK
insertion / GPT cleanup -> color/crop/blur augmentation up to
`augment_imgs_up_to_n` -> CLIPSeg/face masks -> salience (center-of-mass)
crop to the train aspect ratio -> mask grow/blur -> writes `{i}.src.jpg`,
`{i}.mask.jpg`, `captions.csv` and fills `config.training_attributes`.

Every draw is Python's `random`, seeded from `seed` as in the JAX package,
and the image operations are the same Pillow calls, so both packages write
the same files from the same inputs. captions.csv is written with the
standard library's `csv` module.

Attribution: the geometry/augmentation helpers below (hue_augmentation,
color_jitter, random_crop, augment_image, grow_mask, center_of_mass,
crop_to_aspect_ratio) are behavior-pinned transcriptions of
edenartlab/sd-lora-trainer `trainer/preprocess.py:612-659, 945-1028` — the
constants and clamping logic ARE the augmentation-distribution spec this
rebuild reproduces. Those portions remain subject to the upstream OSNL v0.1
license; see LICENSE (Third-party notices #1).
"""

from __future__ import annotations

import os
import random
import shutil
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image, ImageChops, ImageEnhance, ImageFilter

from sd_lora_trainer_tpu_torch.data.captioners import (
    DEGRADATIONS,
    caption_dataset,
    generate_masks,
    record_degradation,
    reset_degradations,
)
from sd_lora_trainer_tpu_torch.data.io import (
    IMG_EXTENSIONS,
    load_image_with_orientation,
    prep_training_data,
    write_captions_csv,
)
from sd_lora_trainer_tpu_torch.utils.utils import fix_prompt


def round_to_nearest_multiple(x, multiple=64) -> int:
    return int(float(multiple) * round(float(x) / float(multiple)))


def calculate_new_dimensions(target_size: int, target_aspect_ratio: float) -> List[int]:
    """Fit target_size^2 pixels to the aspect ratio, /64-rounded
    (reference: preprocess.py:688-703)."""
    n_pixels = target_size**2
    new_width = (n_pixels * target_aspect_ratio) ** 0.5
    new_height = n_pixels / new_width
    return [round_to_nearest_multiple(new_width), round_to_nearest_multiple(new_height)]


def center_of_mass(mask: Image.Image) -> Tuple[float, float]:
    """(x, y) center of mass of a grayscale mask (preprocess.py:969-981)."""
    arr = np.asarray(mask.convert("L"), np.float64) + 0.01
    ys, xs = np.mgrid[0 : arr.shape[0], 0 : arr.shape[1]]
    total = arr.sum()
    return float((xs * arr).sum() / total), float((ys * arr).sum() / total)


def crop_to_aspect_ratio(
    image: Image.Image,
    com: Tuple[float, float],
    target_aspect_ratio: float = 1.0,
    resize_to: Optional[int] = None,
) -> Image.Image:
    """Aspect crop centered on the salience point, clamped to the image
    bounds (preprocess.py:983-1028)."""
    cx, cy = com
    width, height = image.size
    if target_aspect_ratio > 1:
        new_width = int(min(width, height * target_aspect_ratio))
        new_height = int(new_width / target_aspect_ratio)
    else:
        new_height = int(min(height, width / target_aspect_ratio))
        new_width = int(new_height * target_aspect_ratio)

    left = int(max(cx - new_width / 2, 0))
    right = int(min(left + new_width, width))
    top = int(max(cy - new_height / 2, 0))
    bottom = int(min(top + new_height, height))
    if right > width:
        left = max(0, left - (right - width))
        right = width
    if bottom > height:
        top = max(0, top - (bottom - height))
        bottom = height
    image = image.crop((left, top, right, bottom))

    if resize_to:
        if target_aspect_ratio > 1:
            image = image.resize((resize_to, int(resize_to / target_aspect_ratio)), Image.LANCZOS)
        else:
            image = image.resize((int(resize_to * target_aspect_ratio), resize_to), Image.LANCZOS)
    return image


def grow_mask(mask: Image.Image, dilation_radius: float = 5, blur_radius: float = 3) -> Image.Image:
    """Dilate + blur, clipped to the original minimum (preprocess.py:945-966)."""
    dilation_radius, blur_radius = int(dilation_radius), int(blur_radius)
    mask = mask.convert("L")
    min_value = int(np.min(np.asarray(mask)))
    if dilation_radius > 0:
        mask = mask.filter(ImageFilter.MinFilter(dilation_radius * 2 + 1))
    if blur_radius > 0:
        mask = mask.filter(ImageFilter.GaussianBlur(blur_radius))
    return ImageChops.lighter(mask, Image.new("L", mask.size, min_value))


# -- augmentation (preprocess.py:612-659) -----------------------------------


def hue_augmentation(image: Image.Image, hue_change_max: int = 4) -> Image.Image:
    hue_change = random.uniform(1, hue_change_max)
    h, s, v = image.convert("HSV").split()
    h = h.point(lambda i: (i + hue_change) % 256)
    return Image.merge("HSV", (h, s, v)).convert("RGB")


def color_jitter(image: Image.Image) -> Image.Image:
    for enhancer, (low, high) in zip(
        (ImageEnhance.Brightness, ImageEnhance.Contrast, ImageEnhance.Color),
        ([0.9, 1.1], [0.9, 1.25], [0.9, 1.2]),
    ):
        image = enhancer(image).enhance(random.uniform(low, high))
    return image


def random_crop(image: Image.Image, scale=(0.85, 0.95)) -> Image.Image:
    width, height = image.size
    new_w, new_h = width * random.uniform(*scale), height * random.uniform(*scale)
    left = random.uniform(0, width - new_w)
    top = random.uniform(0, height - new_h)
    return image.crop((left, top, left + new_w, top + new_h))


def augment_image(image: Image.Image) -> Image.Image:
    image = hue_augmentation(image)
    image = color_jitter(image)
    image = random_crop(image)
    if random.random() < 0.5:
        image = image.filter(ImageFilter.GaussianBlur(random.uniform(0.0, 1.0)))
    return image


# -- caption post-processing -------------------------------------------------


def post_process_captions(
    captions: List[str],
    caption_text: str,
    concept_mode: str,
    seed: int,
    skip_gpt_cleanup: bool = False,
):
    """TOK injection and (when OPENAI_API_KEY is set) GPT caption cleanup +
    concept-description extraction (reference: preprocess.py:235-383). The
    offline path prepends the trigger text like the reference's fallback."""
    trigger_text = caption_text or "TOK, "
    gpt_concept_description = None

    use_gpt = (not skip_gpt_cleanup) and bool(os.environ.get("OPENAI_API_KEY"))
    if use_gpt:
        try:
            return _gpt_cleanup(captions, caption_text, concept_mode, seed)
        except Exception as e:  # degrade gracefully, like the reference retry-exhaustion path

            record_degradation(
                "caption_cleanup", "gpt-4o rewrite", "prefix injection", str(e)
            )
    elif not skip_gpt_cleanup:

        record_degradation(
            "caption_cleanup", "gpt-4o rewrite", "prefix injection",
            "OPENAI_API_KEY not set; no concept_description will be extracted",
        )

    if concept_mode == "style":
        trigger_text = caption_text or "in the style of TOK, "
        captions = [trigger_text + c for c in captions]
    else:
        captions = [trigger_text + c for c in captions]
    return captions, trigger_text, gpt_concept_description


def _gpt_cleanup(captions, caption_text, concept_mode, seed):
    """GPT-4o rewrite injecting TOK, with TOK-coverage validation and retry
    (reference: preprocess.py:235-383)."""
    import json

    from openai import OpenAI  # type: ignore

    client = OpenAI()
    mode_prompts = {
        "face": "a person's face, refer to them as TOK",
        "object": "a specific object, refer to it as TOK",
        "style": "a visual style, refer to it as 'in the style of TOK'",
    }
    for attempt in range(5):
        resp = client.chat.completions.create(
            model="gpt-4o",
            messages=[
                {
                    "role": "system",
                    "content": (
                        "Rewrite these image captions for concept training of "
                        f"{mode_prompts[concept_mode]}. Every caption MUST contain TOK. "
                        "Also output one short 'concept_description'. Respond as JSON "
                        '{"captions": [...], "concept_description": "..."}'
                    ),
                },
                {"role": "user", "content": json.dumps(captions)},
            ],
            response_format={"type": "json_object"},
            seed=seed + attempt,
        )
        data = json.loads(resp.choices[0].message.content)
        new_captions = data.get("captions", [])
        if len(new_captions) == len(captions) and all("TOK" in c for c in new_captions):
            trigger = "in the style of TOK, " if concept_mode == "style" else "TOK, "
            return new_captions, trigger, data.get("concept_description")
    raise RuntimeError("GPT caption cleanup failed validation 5 times")


# -- the pipeline ------------------------------------------------------------


def preprocess(
    config,
    working_directory: str,
    concept_mode: str,
    input_zip_path: str,
    caption_text: str,
    mask_target_prompts: Optional[str],
    target_size: int,
    crop_based_on_salience: bool,
    use_face_detection_instead: bool,
    left_right_flip_augmentation: bool = False,
    augment_imgs_up_to_n: int = 0,
    caption_model: str = "no_caption",
    seed: int = 0,
):
    """Full curation pipeline; returns (config, output_dir)
    (reference: trainer/preprocess.py:66-118 + load_and_save_masks_and_captions)."""
    random.seed(seed)

    reset_degradations()
    temp_in = os.path.join(working_directory, "images_in")
    temp_out = os.path.join(working_directory, "images_out")
    for path in (temp_in, temp_out):
        if os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path)

    prep_training_data(input_zip_path, temp_in)

    files = sorted(
        os.path.join(temp_in, f)
        for f in os.listdir(temp_in)
        if f.lower().endswith(IMG_EXTENSIONS)
    )
    if not files:
        raise ValueError("No images were found... Are you sure you provided a valid dataset?")

    images, captions = [], []
    for f in files:
        images.append(load_image_with_orientation(f))
        caption_file = os.path.splitext(f)[0] + ".txt"
        if os.path.exists(caption_file):
            captions.append(open(caption_file).read().strip())
        else:
            captions.append(None)

    # train size from the average aspect ratio (preprocess.py:757-764)
    aspect_ratios = [img.size[0] / img.size[1] for img in images]
    avg_aspect_ratio = sum(aspect_ratios) / len(aspect_ratios)
    config.train_img_size = calculate_new_dimensions(target_size, avg_aspect_ratio)
    config.train_aspect_ratio = config.train_img_size[0] / config.train_img_size[1]
    target_size = max(config.train_img_size)

    if config.validation_img_size is None:
        multiplier = 2.0 if config.sd_model_version == "sdxl" else 1.0
        config.validation_img_size = [
            config.train_img_size[0] * multiplier,
            config.train_img_size[1] * multiplier,
        ]
    elif isinstance(config.validation_img_size, int):
        n_pixels = config.validation_img_size**2
        w = (n_pixels * config.train_aspect_ratio) ** 0.5
        config.validation_img_size = [w, n_pixels / w]
    config.validation_img_size = [
        round_to_nearest_multiple(config.validation_img_size[0]),
        round_to_nearest_multiple(config.validation_img_size[1]),
    ]

    n_training_imgs = len(images)

    # Swin2SR super-resolution for small low-res datasets (reference
    # preprocess.py:785-788): <50 images -> upscale anything under 0.75x the
    # train size. Gated on staged weights; degraded = loud + recorded.
    from sd_lora_trainer_tpu_torch.data.super_resolution import maybe_upscale_small_dataset

    images, sr_backend = maybe_upscale_small_dataset(images, config.train_img_size)
    if sr_backend is None:
        record_degradation(
            "super_resolution", "swin2sr 4x upscale", "passthrough",
            "dataset has <50 images below 0.75x train size but no Swin2SR "
            "weights are staged under model_paths['SR']; training on "
            "low-res originals",
        )
    config.training_attributes["sr_backend"] = sr_backend or "passthrough-degraded"

    if left_right_flip_augmentation:
        images = images + [img.transpose(Image.FLIP_LEFT_RIGHT) for img in images]
        captions = captions + captions

    captions = caption_dataset(images, captions, caption_model=caption_model)
    captions = [fix_prompt(c) for c in captions]

    trigger_text, gpt_concept_description = "", None
    if not config.disable_ti:
        captions, trigger_text, gpt_concept_description = post_process_captions(
            captions, caption_text, concept_mode, seed, skip_gpt_cleanup=config.skip_gpt_cleanup
        )

    if config.prompt_modifier:
        captions = [config.prompt_modifier.format(c) for c in captions]

    aug_imgs, aug_caps = [], []
    while len(images) + len(aug_imgs) < augment_imgs_up_to_n:
        aug_imgs.extend(augment_image(img) for img in images)
        aug_caps.extend(captions)
    images.extend(aug_imgs)
    captions.extend(aug_caps)

    # masks (preprocess.py:830-885)
    if gpt_concept_description and not mask_target_prompts:
        mask_target_prompts = gpt_concept_description
    if mask_target_prompts is None or concept_mode == "style":
        mask_target_prompts = ""
    if use_face_detection_instead:
        # face mode: dedicated face-localization chain
        # (reference: face_mask_google_mediapipe, preprocess.py:1033-1160)
        from sd_lora_trainer_tpu_torch.data.face_masks import generate_face_masks

        seg_masks, face_backend = generate_face_masks(images, blur_amount=0.0, bias=10.0)
        config.training_attributes["face_mask_backend"] = face_backend
        if face_backend != "mediapipe":
            record_degradation(
                "face_masks", "mediapipe face mesh", face_backend,
                "masks still localize the face but are coarser than the "
                "reference's landmark-oval masks",
            )
    else:
        seg_masks = generate_masks(
            images,
            mask_target_prompts,
            temperature=config.clipseg_temperature,
            bias=0.05,
        )

    if crop_based_on_salience:
        coms = [center_of_mass(m) for m in seg_masks]
    else:
        coms = [(img.size[0] / 2, img.size[1] / 2) for img in images]
    images = [
        crop_to_aspect_ratio(img, com, config.train_aspect_ratio, resize_to=target_size)
        for img, com in zip(images, coms)
    ]
    seg_masks = [
        crop_to_aspect_ratio(m, com, config.train_aspect_ratio, resize_to=target_size)
        for m, com in zip(seg_masks, coms)
    ]

    # mask grow/blur radii (preprocess.py:875-884)
    if use_face_detection_instead:
        dilation_radius = -0.02 * config.train_img_size[0]
        blur_radius = 0.02 * config.train_img_size[0]
    else:
        dilation_radius = 0.0
        blur_radius = 0.005 * config.train_img_size[0]
    seg_masks = [grow_mask(m, dilation_radius, blur_radius) for m in seg_masks]

    # TOK handling (preprocess.py:895-908)
    if config.disable_ti:
        replace_str = gpt_concept_description or ""
        captions = [c.replace("TOK, ", replace_str + ", ").replace("TOK", replace_str) for c in captions]
    else:
        captions = ["TOK, " + c if "TOK" not in c else c for c in captions]

    rows = []
    for idx, (image, mask, caption) in enumerate(zip(images, seg_masks, captions)):
        image_name, mask_name = f"{idx}.src.jpg", f"{idx}.mask.jpg"
        image.convert("RGB").save(os.path.join(temp_out, image_name), quality=95)
        mask.convert("L").save(os.path.join(temp_out, mask_name), quality=95)
        rows.append({"image_path": image_name, "mask_path": mask_name, "caption": caption})

    write_captions_csv(os.path.join(temp_out, "captions.csv"), rows)

    captions = [fix_prompt(c) for c in captions]
    config.training_attributes["n_training_imgs"] = n_training_imgs
    config.training_attributes["trigger_text"] = trigger_text
    config.training_attributes["segmentation_prompt"] = mask_target_prompts
    # a description the config supplies stays unless GPT wrote one (the JAX
    # package sets None here without GPT, so its TI warmup never runs offline)
    config.training_attributes["gpt_description"] = (
        gpt_concept_description or config.training_attributes.get("gpt_description"))
    config.training_attributes["captions"] = captions
    # availability fallbacks that fired during this run (loud-failure policy;
    # persisted into training_args.json so degraded runs are auditable)
    config.training_attributes["degradations"] = list(DEGRADATIONS)

    return config, temp_out
