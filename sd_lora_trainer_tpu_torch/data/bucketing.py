"""Aspect-ratio bucketing (NovelAI-style algorithm).

A copy of sd_lora_trainer_tpu/data/bucketing.py: both packages must build
the same plan and draw the same batches from the same seed. A /64-divisible
resolution grid under a max-latent-token budget, nearest-aspect assignment
with an error cutoff, per-epoch shuffling with rank sharding, weighted
bucket sampling and leftover handling, all with numpy's RandomState.

Each distinct resolution is one set of train-step shapes; the grid is
bounded (a few dozen resolutions) and an image's resolution is fixed when
it is assigned.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


def generate_resolutions(
    max_size: Tuple[int, int] = (768, 512),
    divisible: int = 64,
    min_dim: int = 256,
    base_res: Tuple[int, int] = (512, 512),
    dim_limit: int = 2048,
    latent_factor: int = 8,
) -> List[Tuple[int, int]]:
    """All (w, h) with w,h multiples of `divisible` whose latent token count
    (w/8)*(h/8) fits the budget of max_size, plus the base resolution."""
    max_tokens = (max_size[0] / latent_factor) * (max_size[1] / latent_factor)

    out = set()
    # widest-h for each w, and widest-w for each h (the grid's pareto edge)
    for first_dim in ("w", "h"):
        a = min_dim
        while (a / latent_factor) * (min_dim / latent_factor) <= max_tokens and a <= dim_limit:
            b = min_dim
            while (
                (a / latent_factor) * ((b + divisible) / latent_factor) <= max_tokens
                and (b + divisible) <= dim_limit
            ):
                b += divisible
            res = (a, b) if first_dim == "w" else (b, a)
            out.add(res)
            a += divisible
    out.add(tuple(base_res))
    return sorted(out, key=lambda r: (r[0] * 4096 - r[1]))


@dataclasses.dataclass
class BucketPlan:
    """Deterministic assignment of image ids to resolution buckets + an epoch
    batch sampler."""

    resolutions: np.ndarray  # [n_buckets, 2]
    aspects: np.ndarray  # [n_buckets]
    assignments: Dict[int, int]  # image_id -> bucket index
    buckets: Dict[int, List[int]]  # bucket index -> image ids
    batch_size: int
    world_size: int = 1
    global_rank: int = 0
    seed: int = 42
    base_res: Tuple[int, int] = (512, 512)

    # epoch state
    _epoch: Optional[Dict[int, List[int]]] = None
    _left_over: Optional[List[int]] = None
    _batch_total: int = 0
    _batch_delivered: int = 0
    _prng: Optional[np.random.RandomState] = None
    _epoch_prng: Optional[np.random.RandomState] = None

    @classmethod
    def build(
        cls,
        image_sizes: Dict[int, Tuple[int, int]],  # id -> (w, h)
        batch_size: int,
        max_size: Tuple[int, int] = (768, 512),
        divisible: int = 64,
        min_dim: int = 256,
        base_res: Tuple[int, int] = (512, 512),
        dim_limit: int = 2048,
        max_ar_error: float = 4.0,
        world_size: int = 1,
        global_rank: int = 0,
        seed: int = 42,
    ) -> "BucketPlan":
        res_list = generate_resolutions(max_size, divisible, min_dim, base_res, dim_limit)
        resolutions = np.array(res_list)
        aspects = resolutions[:, 0] / resolutions[:, 1]

        assignments: Dict[int, int] = {}
        buckets: Dict[int, List[int]] = {}
        for img_id, (w, h) in image_sizes.items():
            aspect = float(w) / float(h)
            bucket = int(np.abs(aspects - aspect).argmin())
            if abs(aspects[bucket] - aspect) >= max_ar_error:
                continue  # aspect too extreme: drop (reference drops too)
            assignments[img_id] = bucket
            buckets.setdefault(bucket, []).append(img_id)

        plan = cls(
            resolutions=resolutions,
            aspects=aspects,
            assignments=assignments,
            buckets=buckets,
            batch_size=batch_size,
            world_size=world_size,
            global_rank=global_rank,
            seed=seed,
            base_res=tuple(base_res),
        )
        plan._prng = np.random.RandomState(seed)
        epoch_seed = int(plan._prng.randint(0, 2**31 - 1))
        plan._epoch_prng = np.random.RandomState(epoch_seed)
        plan.start_epoch()
        return plan

    def resolution_of(self, img_id: int) -> Tuple[int, int]:
        return tuple(self.resolutions[self.assignments[img_id]])

    def used_resolutions(self) -> List[Tuple[int, int]]:
        """Distinct resolutions actually assigned (the compile shape set)."""
        return sorted({tuple(self.resolutions[b]) for b in self.buckets if self.buckets[b]})

    # -- epoch sampling ------------------------------------------------------

    def start_epoch(self, world_size: Optional[int] = None, global_rank: Optional[int] = None):
        if world_size is not None:
            self.world_size = world_size
        if global_rank is not None:
            self.global_rank = global_rank

        ids = np.array(sorted(self.assignments.keys()))
        ids = self._epoch_prng.permutation(ids)
        usable = len(ids) - (len(ids) % (self.batch_size * self.world_size))
        ids = ids[:usable]
        ids = ids[self.global_rank :: self.world_size]
        self._batch_total = len(ids) // self.batch_size
        chosen = set(int(i) for i in ids)

        self._epoch = {}
        self._left_over = []
        self._batch_delivered = 0
        for bucket in sorted(self.buckets.keys()):
            members = [i for i in self.buckets[bucket] if i in chosen]
            if not members:
                continue
            members = list(self._prng.permutation(members))
            overhang = len(members) % self.batch_size
            if overhang:
                self._left_over.extend(int(i) for i in members[:overhang])
                members = members[overhang:]
            if members:
                self._epoch[bucket] = [int(i) for i in members]

    def batches_per_epoch(self) -> int:
        return self._batch_total

    def get_batch(self) -> Tuple[List[int], Tuple[int, int]]:
        """(image ids, (w, h)) — leftover batches fall back to base_res."""
        if (
            self._epoch is None
            or (not self._epoch and not self._left_over)
            or self._batch_delivered >= self._batch_total
        ):
            self.start_epoch()

        while True:
            bucket_ids = list(self._epoch.keys())
            weights = [len(self._epoch[b]) for b in bucket_ids]
            if len(self._left_over) >= self.batch_size:
                bucket_ids = [-1] + bucket_ids
                weights = [len(self._left_over)] + weights
            probs = np.asarray(weights, np.float64)
            probs = probs / probs.sum()
            chosen = int(self._prng.choice(np.asarray(bucket_ids), 1, p=probs)[0]) if self._epoch else -1

            if chosen == -1:
                self._prng.shuffle(self._left_over)
                batch = self._left_over[: self.batch_size]
                self._left_over = self._left_over[self.batch_size :]
                self._batch_delivered += 1
                return batch, self.base_res
            members = self._epoch[chosen]
            if len(members) >= self.batch_size:
                batch, self._epoch[chosen] = members[: self.batch_size], members[self.batch_size :]
                if not self._epoch[chosen]:
                    del self._epoch[chosen]
                self._batch_delivered += 1
                return batch, tuple(self.resolutions[chosen])
            # not enough for a full batch: demote to leftovers, resample
            self._left_over.extend(members)
            del self._epoch[chosen]

    def generator(self):
        if self._batch_delivered >= self._batch_total:
            self.start_epoch()
        while self._batch_delivered < self._batch_total:
            yield self.get_batch()
