"""Face masks for the face concept mode (host-side stage).

Counterpart of sd_lora_trainer_tpu/data/face_masks.py: a chain of
availability-gated backends, best first, the chosen one recorded by the
caller:

1. "mediapipe"      — detector bbox -> face-mesh oval landmarks -> fillPoly;
2. "clipseg-face"   — CLIPSeg with a face prompt, sharpened to a tight mask
                      (needs staged CLIPSeg weights);
3. "heuristic-skin" — YCrCb skin segmentation -> largest connected
                      component -> filled ellipse (needs OpenCV).

Every backend returns masks that are 255 on the face region, ~0 elsewhere,
plus `bias` added everywhere.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
from PIL import Image, ImageFilter

# the reference's face-oval landmark ring (mediapipe face mesh indices;
# see google/mediapipe#1615, reference preprocess.py:1081-1118)
FACE_OVAL_INDICES = [
    10, 338, 297, 332, 284, 251, 389, 356, 454, 323, 361, 288,
    397, 365, 379, 378, 400, 377, 152, 148, 176, 149, 150, 136,
    172, 58, 132, 93, 234, 127, 162, 21, 54, 103, 67, 109,
]


def mediapipe_available() -> bool:
    try:
        import mediapipe  # noqa: F401

        return True
    except ImportError:
        return False


def face_mask_backend() -> str:
    """Best available backend name (the order of the chain above)."""
    if mediapipe_available():
        return "mediapipe"
    from sd_lora_trainer_tpu_torch.data.captioners import clipseg_available

    if clipseg_available():
        return "clipseg-face"
    return "heuristic-skin"


def generate_face_masks(
    images: List[Image.Image], blur_amount: float = 0.0, bias: float = 10.0
) -> Tuple[List[Image.Image], str]:
    """Masks localizing the face in each image; returns (masks, backend)."""
    backend = face_mask_backend()
    if backend == "mediapipe":
        masks = _mediapipe_masks(images, blur_amount, bias)
    elif backend == "clipseg-face":
        masks = _clipseg_face_masks(images, bias)
    else:
        masks = _heuristic_skin_masks(images, bias)
    if blur_amount > 0:
        masks = [m.filter(ImageFilter.GaussianBlur(blur_amount)) for m in masks]
    return masks, backend


def _finalize(mask_np: np.ndarray, bias: float) -> Image.Image:
    if bias > 0:
        mask_np = np.clip(mask_np.astype(np.float32) + bias, 0, 255)
    return Image.fromarray(mask_np.astype(np.uint8)).convert("L")


def _mediapipe_masks(images, blur_amount, bias):
    """Reference-parity path (trainer/preprocess.py:1033-1160)."""
    import cv2
    import mediapipe as mp

    face_detection = mp.solutions.face_detection.FaceDetection(
        model_selection=1, min_detection_confidence=0.1
    )
    face_mesh = mp.solutions.face_mesh.FaceMesh(
        static_image_mode=True, max_num_faces=1, min_detection_confidence=0.1
    )
    masks = []
    for image in images:
        image_np = np.array(image.convert("RGB"))
        ih, iw, _ = image_np.shape
        detection = face_detection.process(image_np)
        mask_np = np.zeros((ih, iw), np.uint8)
        if detection.detections:
            d = detection.detections[0]
            bb = d.location_data.relative_bounding_box
            # mediapipe can emit out-of-range relative coords for faces at
            # the image edge; clamp AND require a non-empty crop — a 0-size
            # array would make face_mesh.process raise, not return empty.
            x, y = min(max(0, int(bb.xmin * iw)), iw - 1), min(max(0, int(bb.ymin * ih)), ih - 1)
            w = min(iw - x, int(bb.width * iw))
            h = min(ih - y, int(bb.height * ih))
            landmarks = None
            if w > 0 and h > 0:
                landmarks = face_mesh.process(image_np[y : y + h, x : x + w]).multi_face_landmarks
            if landmarks:
                pts = [
                    (int(landmarks[0].landmark[i].x * w) + x,
                     int(landmarks[0].landmark[i].y * h) + y)
                    for i in FACE_OVAL_INDICES
                ]
                mask_np = cv2.fillPoly(mask_np, [np.array(pts)], 255)
        masks.append(_finalize(mask_np, bias))
    return masks


def _clipseg_face_masks(images, bias):
    """CLIPSeg with a face prompt, sharpened toward a binary face region."""
    from sd_lora_trainer_tpu_torch.data.captioners import generate_masks

    soft = generate_masks(images, "the face of a person", temperature=0.3, bias=0.0)
    masks = []
    for m in soft:
        arr = np.asarray(m, np.float32) / 255.0
        # normalize then threshold: CLIPSeg logits vary in scale per image
        lo, hi = arr.min(), arr.max()
        if hi - lo > 1e-6:
            arr = (arr - lo) / (hi - lo)
        hard = (arr > 0.5).astype(np.uint8) * 255
        masks.append(_finalize(hard, bias))
    return masks


def _heuristic_skin_masks(images, bias):
    """Model-free localization: YCrCb skin threshold -> morphology ->
    largest component -> filled ellipse over its bounding box. Falls back
    to a portrait-composition ellipse prior if no skin-like region exists
    (still non-uniform, so downstream crop/dilation keep operating)."""
    import cv2

    masks = []
    for image in images:
        rgb = np.array(image.convert("RGB"))
        ih, iw, _ = rgb.shape
        ycrcb = cv2.cvtColor(rgb, cv2.COLOR_RGB2YCrCb)
        skin = cv2.inRange(ycrcb, (0, 133, 77), (255, 173, 127))
        k = max(3, int(0.01 * max(ih, iw)) | 1)
        kernel = np.ones((k, k), np.uint8)
        skin = cv2.morphologyEx(skin, cv2.MORPH_OPEN, kernel)
        skin = cv2.morphologyEx(skin, cv2.MORPH_CLOSE, kernel)
        n, _, stats, _ = cv2.connectedComponentsWithStats(skin)
        mask_np = None
        if n > 1:
            i = 1 + int(np.argmax(stats[1:, cv2.CC_STAT_AREA]))
            x, y, w, h = stats[i, :4]
            if stats[i, cv2.CC_STAT_AREA] >= 0.005 * ih * iw:
                mask_np = np.zeros((ih, iw), np.uint8)
                cv2.ellipse(
                    mask_np,
                    (x + w // 2, y + h // 2),
                    (max(w // 2, 1), max(h // 2, 1)),
                    0, 0, 360, 255, -1,
                )
        if mask_np is None:
            # portrait prior: faces sit in the upper-center third
            mask_np = np.zeros((ih, iw), np.uint8)
            cv2.ellipse(
                mask_np,
                (iw // 2, int(ih / 2.8)),
                (iw // 4, int(ih / 3.5)),
                0, 0, 360, 255, -1,
            )
        masks.append(_finalize(mask_np, bias))
    return masks
