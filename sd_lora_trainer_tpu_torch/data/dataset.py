"""Latent-cached training dataset (counterpart of sd_lora_trainer_tpu/data/dataset.py).

Reads the preprocessed directory ({i}.src.jpg, {i}.mask.jpg, captions.csv),
lowercases the captions and substitutes TOK -> "<s0><s1>...", and encodes
every image through the VAE once, caching its latent distribution (mean,
logvar) so the train step draws a fresh latent each time.

- the encode runs on the VAE's device under `torch.no_grad`, `encode_batch`
  images at a time, in float32 (the JAX package's dtype there);
- the cache is a pair of [N, h, w, 4] float32 numpy arrays plus [N, h, w, 1]
  masks; past `max_in_ram` images they are disk-backed memmaps filled chunk
  by chunk;
- with bucketing, each image is encoded at its bucket's resolution;
- `EpochSampler` and `BucketPlan` draw with numpy's RandomState from the
  seed, so both packages see the same batches.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from PIL import Image

from sd_lora_trainer_tpu_torch.data.bucketing import BucketPlan
from sd_lora_trainer_tpu_torch.data.io import read_captions_csv
from sd_lora_trainer_tpu_torch.models.vae import VAEConfig, downsample_factor, vae_encode


def load_image_for_vae(path: str, w: int, h: int) -> np.ndarray:
    """Bicubic resize + [-1, 1] normalization, HWC float32."""
    img = Image.open(path).convert("RGB").resize((w, h), resample=Image.BICUBIC, reducing_gap=1)
    return np.asarray(img, np.float32) / 255.0 * 2.0 - 1.0


def load_mask(path: str, w: int, h: int) -> np.ndarray:
    """Grayscale [0, 1] mask at (w, h); downsampled to the latent grid later."""
    img = Image.open(path).convert("L").resize((w, h), resample=Image.BICUBIC, reducing_gap=1)
    return np.asarray(img, np.float32) / 255.0


def _downsample_mask_nearest(mask: np.ndarray, lh: int, lw: int) -> np.ndarray:
    h, w = mask.shape
    ys = (np.arange(lh) * (h / lh)).astype(np.int32)
    xs = (np.arange(lw) * (w / lw)).astype(np.int32)
    return mask[ys][:, xs]


class EpochSampler:
    """Shuffled epoch-coverage sampler: every index once per epoch, batches
    drawn in order from a per-epoch permutation; a batch that straddles an
    epoch boundary borrows the head of the next permutation (static batch
    shapes). Deterministic from (n, seed), so a resume replays it."""

    def __init__(self, n: int, seed: int):
        self.n = int(n)
        self._rng = np.random.RandomState(seed)
        self.perm = self._rng.permutation(self.n)
        self.pos = 0
        self.epoch = 0

    def next_batch(self, batch_size: int) -> List[int]:
        out: List[int] = []
        while len(out) < batch_size:
            take = min(batch_size - len(out), self.n - self.pos)
            out.extend(int(i) for i in self.perm[self.pos:self.pos + take])
            self.pos += take
            if self.pos == self.n:
                self.perm = self._rng.permutation(self.n)
                self.pos = 0
                self.epoch += 1
        return out


class BucketStore:
    """img_id -> (mean, logvar, mask) rows of stacked arrays (RAM or memmap)."""

    def __init__(self, ids: List[int], mean, logvar, mask):
        self._rows = {int(img_id): j for j, img_id in enumerate(ids)}
        self.mean, self.logvar, self.mask = mean, logvar, mask

    def keys(self):
        return self._rows.keys()

    def __contains__(self, i):
        return int(i) in self._rows

    def __len__(self):
        return len(self._rows)

    def __getitem__(self, i):
        j = self._rows[int(i)]
        return self.mean[j], self.logvar[j], self.mask[j]


@dataclasses.dataclass
class LatentDataset:
    captions: List[str]
    # square path: single-resolution caches
    latent_mean: Optional[np.ndarray] = None  # [N, h, w, 4]
    latent_logvar: Optional[np.ndarray] = None
    masks: Optional[np.ndarray] = None  # [N, h, w, 1]
    vae_scaling_factor: float = 0.18215
    train_img_size: Tuple[int, int] = (512, 512)
    # bucketed path: per-resolution caches keyed by (w, h)
    bucket_plan: Optional[BucketPlan] = None
    bucket_latents: Optional[Dict[Tuple[int, int], BucketStore]] = None
    # the VAE encode's numbers: images, seconds, device bytes (CUDA)
    encode_stats: Dict[str, float] = dataclasses.field(default_factory=dict)

    def __len__(self):
        return len(self.captions)

    @classmethod
    def from_directory(
        cls,
        data_dir: str,
        vae_params,
        vae_config: VAEConfig,
        size: Tuple[int, int],
        substitute_caption_map: Optional[Dict[str, str]] = None,
        aspect_ratio_bucketing: bool = False,
        train_batch_size: int = 4,
        encode_batch: int = 8,
        seed: int = 42,
        world_size: int = 1,
        global_rank: int = 0,
        max_in_ram: int = 500,
    ) -> "LatentDataset":
        import time

        rows = read_captions_csv(os.path.join(data_dir, "captions.csv"))
        captions = []
        for row in rows:
            c = (row.get("caption") or "").lower()
            for key, value in (substitute_caption_map or {}).items():
                c = c.replace(key.lower(), value)
            captions.append(c)
        image_paths = [os.path.join(data_dir, r["image_path"]) for r in rows]
        mask_paths = ([os.path.join(data_dir, r["mask_path"]) for r in rows]
                      if rows and "mask_path" in rows[0] else None)
        device = next(_tensors(vae_params)).device
        factor = downsample_factor(vae_config)

        spill_dir = None
        if len(image_paths) > max_in_ram:
            spill_dir = os.path.join(data_dir, "latent_cache")
            os.makedirs(spill_dir, exist_ok=True)
            print(f"[latent-cache] {len(image_paths)} images > {max_in_ram}: "
                  f"spilling latents to {spill_dir}")

        def _alloc(shape, name):
            if spill_dir is None:
                return np.empty(shape, np.float32)
            return np.lib.format.open_memmap(os.path.join(spill_dir, name), mode="w+",
                                             shape=shape, dtype=np.float32)

        # peak_bytes: the device's peak during the encode, resident weights
        # included (resident_bytes, at its start)
        stats = {"images": 0, "seconds": 0.0, "peak_bytes": 0, "resident_bytes": 0}
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
            stats["resident_bytes"] = torch.cuda.memory_allocated(device)

        def encode_at(paths, mpaths, w, h, tag="sq"):
            lh, lw = h // factor, w // factor
            n = len(paths)
            mean_a = logvar_a = None
            for start in range(0, n, encode_batch):
                chunk = paths[start:start + encode_batch]
                imgs = torch.from_numpy(np.stack([load_image_for_vae(p, w, h) for p in chunk]))
                t0 = time.perf_counter()
                with torch.no_grad():
                    mean, logvar = vae_encode(vae_params, imgs.to(device), vae_config)
                    mean, logvar = mean.float().cpu().numpy(), logvar.float().cpu().numpy()
                stats["seconds"] += time.perf_counter() - t0
                stats["images"] += len(chunk)
                if mean_a is None:
                    mean_a = _alloc((n,) + mean.shape[1:], f"{tag}_{w}x{h}_mean.npy")
                    logvar_a = _alloc((n,) + logvar.shape[1:], f"{tag}_{w}x{h}_logvar.npy")
                mean_a[start:start + len(chunk)] = mean
                logvar_a[start:start + len(chunk)] = logvar
            mask_a = _alloc((n, lh, lw, 1), f"{tag}_{w}x{h}_mask.npy")
            for i in range(n):
                if mpaths is None:
                    mask_a[i] = 1.0
                else:
                    mask_a[i] = _downsample_mask_nearest(load_mask(mpaths[i], w, h), lh, lw)[..., None]
            return mean_a, logvar_a, mask_a

        def done(**fields):
            if device.type == "cuda":
                stats["peak_bytes"] = torch.cuda.max_memory_allocated(device)
            return cls(captions=captions, vae_scaling_factor=vae_config.scaling_factor,
                       encode_stats=stats, **fields)

        if not aspect_ratio_bucketing:
            w, h = size
            mean, logvar, masks = encode_at(image_paths, mask_paths, w, h)
            return done(latent_mean=mean, latent_logvar=logvar, masks=masks,
                        train_img_size=(w, h))

        image_sizes = {}
        for i, p in enumerate(image_paths):
            with Image.open(p) as im:
                image_sizes[i] = im.size
        plan = BucketPlan.build(
            image_sizes, batch_size=train_batch_size, base_res=tuple(size),
            max_size=(int(size[0] * 1.5), size[1]), seed=seed, world_size=world_size,
            global_rank=global_rank,
        )
        bucket_latents: Dict[Tuple[int, int], BucketStore] = {}
        resolutions = set(plan.used_resolutions())
        resolutions.add(tuple(size))  # leftover batches use the base resolution
        for res in resolutions:
            w, h = res
            if res == tuple(size):
                ids = list(range(len(image_paths)))  # covers every image (leftovers)
            else:
                ids = [i for i in range(len(image_paths))
                       if i in plan.assignments and plan.resolution_of(i) == res]
            if not ids:
                continue
            mean, logvar, masks = encode_at(
                [image_paths[i] for i in ids],
                [mask_paths[i] for i in ids] if mask_paths else None, w, h, tag="bucket")
            bucket_latents[res] = BucketStore(ids, mean, logvar, masks)
        return done(train_img_size=tuple(size), bucket_plan=plan, bucket_latents=bucket_latents)

    def batch(self, indices: List[int]) -> Dict[str, np.ndarray]:
        """Square-resolution batch of latent distributions, masks, captions."""
        idx = np.asarray(indices)
        return {
            "latent_mean": self.latent_mean[idx],
            "latent_logvar": self.latent_logvar[idx],
            "mask": self.masks[idx],
            "captions": [self.captions[i] for i in indices],
        }

    def bucketed_batch(self) -> Tuple[Dict[str, np.ndarray], Tuple[int, int]]:
        if self.bucket_plan is None:
            raise ValueError("bucketed_batch needs a dataset built with aspect_ratio_bucketing")
        ids, res = self.bucket_plan.get_batch()
        res = tuple(res)
        store = self.bucket_latents[res]
        return {
            "latent_mean": np.stack([store[i][0] for i in ids]),
            "latent_logvar": np.stack([store[i][1] for i in ids]),
            "mask": np.stack([store[i][2] for i in ids]),
            "captions": [self.captions[i] for i in ids],
        }, res


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
