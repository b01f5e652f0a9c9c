"""Host-side dataset IO (counterpart of sd_lora_trainer_tpu/data/io.py).

Downloading, archive extraction, EXIF-aware loading, re-encoding, and the
validation image grid. Local paths always work; a URL needs the network and
the `requests` package. CSV files are read and written with the standard
library's `csv` module (no pandas).
"""

from __future__ import annotations

import csv
import os
import shutil
import tarfile
import zipfile
from typing import Dict, List, Optional

from PIL import Image, ImageOps

IMG_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")
CSV_COLUMNS = ("image_path", "mask_path", "caption")


def load_image_with_orientation(path: str, mode: str = "RGB") -> Image.Image:
    """Open + apply EXIF orientation (reference: preprocess.py:583-610)."""
    image = Image.open(path)
    image = ImageOps.exif_transpose(image)
    return image.convert(mode)


def download(url: str, folder: str, filepath: Optional[str] = None) -> str:
    """URL download with content-type extension sniffing (io.py:180-231)."""
    import requests

    os.makedirs(folder, exist_ok=True)
    response = requests.get(url, stream=True, timeout=600)
    response.raise_for_status()
    if not filepath:
        name = os.path.basename(url.split("?")[0]) or "download"
        ctype = response.headers.get("content-type", "")
        if "." not in name:
            ext = {
                "application/zip": ".zip",
                "image/jpeg": ".jpg",
                "image/png": ".png",
                "application/x-tar": ".tar",
            }.get(ctype.split(";")[0], "")
            name += ext
        filepath = os.path.join(folder, name)
    with open(filepath, "wb") as f:
        for chunk in response.iter_content(chunk_size=1 << 20):
            f.write(chunk)
    return filepath


def is_zip_or_tar(path: str) -> bool:
    return zipfile.is_zipfile(path) or tarfile.is_tarfile(path)


def extract_archive(path: str, out_dir: str) -> None:
    """Zip/tar extraction (io.py:234-264)."""
    os.makedirs(out_dir, exist_ok=True)
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as zf:
            zf.extractall(out_dir)
    elif tarfile.is_tarfile(path):
        with tarfile.open(path) as tf:
            tf.extractall(out_dir)
    else:
        raise ValueError(f"Not an archive: {path}")


def flatten_dir(directory: str) -> None:
    """Move nested files up to the top level, drop junk dirs (io.py:317-342)."""
    for root, dirs, files in os.walk(directory):
        if root == directory:
            continue
        for f in files:
            src = os.path.join(root, f)
            dst = os.path.join(directory, f)
            if not os.path.exists(dst):
                shutil.move(src, dst)
    for entry in os.listdir(directory):
        full = os.path.join(directory, entry)
        if os.path.isdir(full):
            shutil.rmtree(full)
        elif entry.startswith("._") or entry == ".DS_Store":
            os.remove(full)


def reencode_images(directory: str, max_size: int = 2048, quality: int = 95) -> int:
    """Re-encode every image to jpg <= max_size^2, drop non-images
    (io.py:344-362). Returns the number of images kept."""
    kept = 0
    for entry in sorted(os.listdir(directory)):
        full = os.path.join(directory, entry)
        base, ext = os.path.splitext(entry)
        if ext.lower() == ".txt" or os.path.isdir(full):
            continue
        try:
            img = load_image_with_orientation(full)
        except Exception:
            os.remove(full)
            continue
        if max(img.size) > max_size:
            scale = max_size / max(img.size)
            img = img.resize((int(img.size[0] * scale), int(img.size[1] * scale)), Image.LANCZOS)
        out = os.path.join(directory, f"{base}.jpg")
        if out != full:
            os.remove(full)
        img.save(out, quality=quality)
        kept += 1
    return kept


def prep_training_data(source: str, out_dir: str) -> int:
    """download_and_prep_training_data equivalent (io.py:385-406): accepts a
    local dir, a local/remote archive, pipe-separated multi-sources, or plain
    image URLs; normalizes everything into flat jpgs in out_dir."""
    os.makedirs(out_dir, exist_ok=True)
    sources = [s.strip() for s in str(source).split("|") if s.strip()]
    for src in sources:
        if src.startswith("http://") or src.startswith("https://"):
            path = download(src, out_dir)
            if is_zip_or_tar(path):
                extract_archive(path, out_dir)
                os.remove(path)
        elif os.path.isdir(src):
            for entry in os.listdir(src):
                full = os.path.join(src, entry)
                if os.path.isfile(full):
                    shutil.copy(full, os.path.join(out_dir, entry))
                elif os.path.isdir(full):
                    shutil.copytree(full, os.path.join(out_dir, entry), dirs_exist_ok=True)
        elif os.path.isfile(src) and is_zip_or_tar(src):
            extract_archive(src, out_dir)
        elif os.path.isfile(src):
            shutil.copy(src, out_dir)
        else:
            raise FileNotFoundError(f"Training data source not found: {src}")
    flatten_dir(out_dir)
    return reencode_images(out_dir)


def read_captions_csv(path: str) -> List[Dict[str, str]]:
    """The rows of a captions.csv ({"image_path", "mask_path", "caption"});
    an empty cell reads as "" (pandas would give NaN)."""
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def write_captions_csv(path: str, rows: List[Dict[str, Optional[str]]]) -> None:
    """captions.csv as the JAX package's pandas `to_csv(index=False)` writes
    it: a header line, minimal quoting, "\n" line ends, None as ""."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(CSV_COLUMNS)
        for row in rows:
            writer.writerow(["" if row.get(c) is None else row[c] for c in CSV_COLUMNS])


def merge_datasets(dataset_dirs, out_dir: str, token_names=None, balance: bool = True) -> str:
    """Merge preprocessed datasets for multi-concept training: each
    dataset's {i}.src.jpg / {i}.mask.jpg / captions.csv, "TOK" optionally
    rewritten to a per-concept token, and (with `balance`) smaller datasets
    repeated so every concept contributes as many rows as the largest."""
    os.makedirs(out_dir, exist_ok=True)
    frames = []
    for d in dataset_dirs:
        frames.append([dict(row, _src_dir=d)
                       for row in read_captions_csv(os.path.join(d, "captions.csv"))])
    if balance:
        target = max(len(rows) for rows in frames)
        frames = [(rows * -(-target // len(rows)))[:target] for rows in frames]
    out_rows = []
    idx = 0
    for concept_i, rows in enumerate(frames):
        token = (token_names or [None] * len(frames))[concept_i]
        for row in rows:
            image_name, mask_name = f"{idx}.src.jpg", f"{idx}.mask.jpg"
            shutil.copy(os.path.join(row["_src_dir"], row["image_path"]),
                        os.path.join(out_dir, image_name))
            if row.get("mask_path"):
                shutil.copy(os.path.join(row["_src_dir"], row["mask_path"]),
                            os.path.join(out_dir, mask_name))
            else:
                mask_name = None
            caption = row["caption"]
            if token:
                caption = caption.replace("TOK", token)
            out_rows.append({"image_path": image_name, "mask_path": mask_name, "caption": caption})
            idx += 1
    write_captions_csv(os.path.join(out_dir, "captions.csv"), out_rows)
    return out_dir


def make_validation_img_grid(img_folder: str) -> str:
    """4-wide jpg grid of the validation renders (io.py:99-136)."""
    paths = sorted(
        os.path.join(img_folder, f)
        for f in os.listdir(img_folder)
        if f.endswith(".jpg") and "grid" not in f and f.split(".")[0].isdigit() is False
    )
    # validation renders are saved as {i}_{prompt_hash}.jpg — fall back to all jpgs
    if not paths:
        paths = sorted(
            os.path.join(img_folder, f) for f in os.listdir(img_folder) if f.endswith(".jpg")
        )
    if not paths:
        raise FileNotFoundError(f"no validation images in {img_folder}")
    imgs = [Image.open(p) for p in paths]
    w, h = imgs[0].size
    cols = min(4, len(imgs))
    rows = (len(imgs) + cols - 1) // cols
    grid = Image.new("RGB", (cols * w, rows * h))
    for i, img in enumerate(imgs):
        grid.paste(img.resize((w, h)), ((i % cols) * w, (i // cols) * h))
    out_path = os.path.join(img_folder, "validation_grid.jpg")
    grid.save(out_path, quality=90)
    return out_path
