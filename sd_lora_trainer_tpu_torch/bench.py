"""Throughput benchmark of the port: SDXL LoRA+TI training imgs/s at 1024px.

    python -m sd_lora_trainer_tpu_torch.bench

Counterpart of the JAX package's bench.py, with its environment knobs and
their meanings. It runs the port's real train step (training/step.py): both
text encoders with TI rows, the full-width UNet forward and backward through
rank-16 LoRA on every default site (577 on SDXL, created before the qkv
fusion, as the product does), DAAM capture, every loss term and the
three-group update, on random weights built on the card from a seed, with
cached-latent batches. Nothing is downloaded.

Knobs: BENCH_MODEL (sdxl | sd15), BENCH_BS (8), BENCH_RES (1024; 512 for
sd15), BENCH_STEPS (10), BENCH_SCAN (4: steps per call, the port's
`run_steps` over K batches, `config.steps_per_call`; on the card a step is
one CUDA graph, so a call is K replays, as JAX's call is one K-step scan),
BENCH_REMAT (auto | full | off | light |
dots | save:<names> | offload:<names> | light+save:<names>), BENCH_FLASH (1),
BENCH_FUSE_QKV (1), BENCH_STASH8 (names kept as int8; the save: plan must
list them), BENCH_BASEQ ("" | int8 | int8+te), BENCH_BUCKETS
('1024x1024,832x1216': bucketed throughput, HxW, 64-px multiples, one step
config per bucket with its own DAAM ratio w/h, calls alternating
round-robin), BENCH_GRAPH (1: the step as one CUDA graph, as the trainer
runs it; 0: the eager step, to compare the two on one card),
BENCH_LOG_LOSSES=1 (every call's losses on stderr),
BENCH_TINY=1 (the tiny configs: the whole code path in seconds, for tests;
never for numbers) and BENCH_PLATFORM=cpu (run on the CPU). Without a card,
and without BENCH_PLATFORM=cpu, it prints an error line and exits 1.

The warm-up call holds each bucket's eager first step and its capture
(training/step.py), so the timed calls are replays; stderr says whether
the step ran as a graph or eagerly, and the capture's seconds.

stdout carries one JSON line: `metric`, `value`, `unit`, `vs_baseline`
(against the reference's A100 anchor, 6.0 imgs/s at 512px,
pixel-normalized), `config` (every lever, the device's name and power
limit, `flops_per_step`) and `mfu` where the card's peak is known
(utils/profiling.py). Diagnostics go to stderr: per-step seconds (from
CUDA events at each step's end, so no extra synchronization), flash
launches per step, peak memory, and the device's busy share over one
profiled step after the timed ones.

MFU = model FLOPs per step x steps / seconds / the card's dense bf16 peak.
The FLOPs are the model's: the forward and backward of the conditioning and
the UNet, counted by FlopCounterMode with remat off at batch 1, times the
batch size; recomputation and the update are not counted. The JAX bench
counted XLA's executed operations, recomputation included, so the two MFUs
are not comparable.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# the reference's A100-class anchor: 6.0 imgs/s at bs=4, at its 512px default
ANCHOR_IMGS_PER_S_512 = 6.0
LORA_RANK = 16
FLOPS_CONVENTION = "model, fwd+bwd, remat off"
REMAT_WORDS = {"full": True, "off": False, "light": "light", "dots": "dots"}
REMAT_PREFIXES = ("save:", "offload:", "light+save:")


class BenchError(Exception):
    """A knob the bench cannot run with, or no card."""


@dataclasses.dataclass
class Levers:
    model: str
    batch_size: int
    resolution: int
    steps: int
    scan_k: int
    remat: str
    flash: bool
    fuse_qkv: bool
    stash8: str
    baseq: str
    buckets: List[Tuple[int, int]]  # (H, W) each
    log_losses: bool
    tiny: bool
    device: torch.device
    graph: bool = True

    @classmethod
    def from_env(cls, env=os.environ) -> "Levers":
        model = env.get("BENCH_MODEL", "sdxl")
        if model not in ("sdxl", "sd15"):
            raise BenchError(f"unknown BENCH_MODEL={model!r}")
        baseq = env.get("BENCH_BASEQ", "")
        if baseq not in ("", "int8", "int8+te"):
            raise BenchError(f"unknown BENCH_BASEQ={baseq!r}")
        if env.get("BENCH_GRAPH", "1") not in ("0", "1"):
            raise BenchError(f"unknown BENCH_GRAPH={env['BENCH_GRAPH']!r}")
        remat = env.get("BENCH_REMAT", "auto")
        if remat != "auto" and remat not in REMAT_WORDS and not remat.startswith(REMAT_PREFIXES):
            raise BenchError(f"unknown BENCH_REMAT={remat!r}")
        raw = env.get("BENCH_BUCKETS", "")
        buckets = [tuple(int(v) for v in s.split("x")) for s in raw.split(",") if s]
        if any(len(b) != 2 or b[0] % 64 or b[1] % 64 for b in buckets):
            raise BenchError(f"BENCH_BUCKETS={raw!r}: each bucket is HxW in 64-px multiples")
        if env.get("BENCH_PLATFORM", "") == "cpu":
            device = torch.device("cpu")
        elif torch.cuda.is_available():
            device = torch.device("cuda", torch.cuda.current_device())
        else:
            raise BenchError("no CUDA device (torch.cuda.is_available() is false); "
                             "BENCH_PLATFORM=cpu runs on the CPU")
        return cls(
            model=model, batch_size=int(env.get("BENCH_BS", "8")),
            resolution=int(env.get("BENCH_RES", "1024" if model == "sdxl" else "512")),
            steps=int(env.get("BENCH_STEPS", "10")), scan_k=int(env.get("BENCH_SCAN", "4")),
            remat=remat, flash=env.get("BENCH_FLASH", "1") != "0",
            fuse_qkv=env.get("BENCH_FUSE_QKV", "1") == "1", stash8=env.get("BENCH_STASH8", ""),
            baseq=baseq, buckets=buckets,
            log_losses=env.get("BENCH_LOG_LOSSES") == "1", tiny=env.get("BENCH_TINY") == "1",
            device=device, graph=env.get("BENCH_GRAPH", "1") == "1",
        )


@dataclasses.dataclass
class BenchRun:
    """The built models, train state and step config of one bench."""

    levers: Levers
    config: object
    frozen: object
    state: object
    sc: object
    adapter_targets: int
    te1_config: object

    def batch(self, lat_h: int, lat_w: int, rng: np.random.RandomState) -> Dict[str, torch.Tensor]:
        """One [1, B, ...] batch as the latent cache yields it: token ids
        from the encoder's vocab (BOS/EOS, 9 content tokens, the 3 TI rows
        appended after the vocab at positions 3-5)."""
        bs, dev = self.levers.batch_size, self.levers.device
        vocab, eos = self.te1_config.vocab_size, self.te1_config.eos_token_id
        ids = np.full((1, bs, 77), eos, np.int64)
        ids[..., 0] = eos - 1
        ids[..., 1:10] = rng.randint(4, vocab - 8, size=(1, bs, 9))
        ids[..., 3:6] = [vocab, vocab + 1, vocab + 2]
        shape = (1, bs, lat_h, lat_w, 4)
        return {
            "latent_mean": torch.as_tensor(rng.randn(*shape), device=dev).to(torch.bfloat16),
            "latent_logvar": torch.full(shape, -6.0, dtype=torch.bfloat16, device=dev),
            "mask": torch.ones(shape[:-1] + (1,), dtype=torch.bfloat16, device=dev),
            "input_ids": torch.as_tensor(ids, device=dev),
            "input_ids_2": torch.as_tensor(ids, device=dev),
            "caption_token_lengths": torch.full((1, bs), 12, dtype=torch.long, device=dev),
            "ti_token_positions": torch.tensor([3, 4, 5], device=dev).repeat(1, bs, 1),
            "latent_scale": torch.tensor(0.13025, dtype=torch.float32, device=dev),
        }

    def lever_config(self) -> dict:
        lv = self.levers
        return {
            "model": lv.model, "resolution": lv.resolution, "batch_size": lv.batch_size,
            "remat": self.sc.remat, "stash8": self.sc.stash8 or "", "baseq": lv.baseq or "none",
            "fuse_qkv": lv.fuse_qkv, "flash": self.sc.use_flash, "scan_k": lv.scan_k,
            "buckets": ",".join(f"{h}x{w}" for h, w in lv.buckets),
            "adapter_targets": self.adapter_targets,
            "lora_rank": LORA_RANK,
        }


_T0 = time.perf_counter()


def log(*args) -> None:
    """A diagnostic line on stderr, with the seconds since the bench started."""
    print(f"[bench +{time.perf_counter() - _T0:.1f}s]", *args, file=sys.stderr, flush=True)


def setup(levers: Levers) -> BenchRun:
    """Random full-width (or tiny) weights on the device from seed 0, the
    adapters and TI rows, the optional int8 base and fused qkv, the
    optimizer and the step config the levers ask for."""
    from sd_lora_trainer_tpu_torch.config import TrainingConfig
    from sd_lora_trainer_tpu_torch.diffusion.schedulers import DDPMSchedule
    from sd_lora_trainer_tpu_torch.models import clip
    from sd_lora_trainer_tpu_torch.models.fuse import fuse_attention_projections
    from sd_lora_trainer_tpu_torch.models.lora import UNET_TARGETS, create_lora_params, iter_lora_leaves
    from sd_lora_trainer_tpu_torch.models.quant import quantize_frozen
    from sd_lora_trainer_tpu_torch.models import unet as unet_mod
    from sd_lora_trainer_tpu_torch.training.embeddings import initialize_new_tokens
    from sd_lora_trainer_tpu_torch.training.optimizers import GroupOptimizer
    from sd_lora_trainer_tpu_torch.training.step import FrozenModels, StepConfig, TrainState

    lv, dev = levers, levers.device
    sdxl = lv.model == "sdxl"
    if lv.tiny:
        te1_cfg, te2_cfg = clip.TINY_CLIP_L_CONFIG, clip.TINY_CLIP_G_CONFIG
        # the tiny SD1.5 UNet's cross-attention takes the tiny CLIP-L's width
        unet_cfg = (unet_mod.TINY_SDXL_UNET_CONFIG if sdxl else dataclasses.replace(
            unet_mod.TINY_SD15_UNET_CONFIG, cross_attention_dim=te1_cfg.hidden_size))
    else:
        unet_cfg = unet_mod.SDXL_UNET_CONFIG if sdxl else unet_mod.SD15_UNET_CONFIG
        te1_cfg, te2_cfg = clip.CLIP_L_CONFIG, clip.CLIP_BIG_G_CONFIG
    if not sdxl:
        te2_cfg = None
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    unet = unet_mod.init_unet_params(unet_cfg, gen, dtype=torch.bfloat16, device=dev)
    te1 = clip.init_clip_params(te1_cfg, gen, dtype=torch.bfloat16, device=dev)
    te2 = clip.init_clip_params(te2_cfg, gen, dtype=torch.bfloat16, device=dev) if sdxl else None
    # the adapters come from the unfused tree (fusion removes the q/k/v
    # kernels the targets name), as the product creates them
    lora = create_lora_params(unet, LORA_RANK, gen, targets=UNET_TARGETS)
    tables = [t["text_model"]["embeddings"]["token_embedding"]["weight"] if t else None
              for t in (te1, te2)]
    rows, targets = initialize_new_tokens(tables, 3, gen)
    trainable = {"unet": lora, "ti": {"te1": rows[0]}}
    if sdxl:
        trainable["ti"]["te2"] = rows[1]
    adapter_targets = len(list(iter_lora_leaves(lora)))
    frozen = FrozenModels(
        unet_params=unet, te1_params=te1, te2_params=te2,
        schedule=DDPMSchedule.create(device=dev), distribution_targets=targets,
        unet_config=unet_cfg, te1_config=te1_cfg, te2_config=te2_cfg, version=lv.model,
        resolution=(lv.resolution, lv.resolution),
    )
    del unet, te1, te2
    if lv.baseq:
        freed = quantize_frozen(frozen, lv.baseq)
        log(f"frozen base kernels -> {lv.baseq} ({freed:.2f} GiB freed)")
    if lv.fuse_qkv:
        frozen.unet_params = fuse_attention_projections(frozen.unet_params)
        log("fused qkv/kv projections")
    config = TrainingConfig(
        lora_training_urls="bench", concept_mode="style", sd_model_version=lv.model,
        max_train_steps=400, lora_rank=LORA_RANK, train_batch_size=lv.batch_size,
        resolution=lv.resolution, quantize_base=lv.baseq or "none", seed=0,
        device=dev.type, _testing_no_output_dir=True,
    )
    sc = StepConfig.from_config(config, 1.0)
    if not lv.flash:
        sc = dataclasses.replace(sc, use_flash=False)
        log("flash attention off (plain attention)")
    if lv.remat == "auto":
        log(f"remat auto -> {sc.remat!r}")
    else:
        sc = dataclasses.replace(sc, remat=REMAT_WORDS.get(lv.remat, lv.remat))
        log(f"remat {sc.remat!r}")
    if lv.stash8:
        sc = dataclasses.replace(sc, stash8=lv.stash8)
        log(f"stash8 {lv.stash8!r}")
    state = TrainState(step=0, trainable=trainable, optimizer=GroupOptimizer(config, trainable),
                       generator=torch.Generator(device=dev).manual_seed(1))
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = config.allow_tf32
        torch.backends.cudnn.allow_tf32 = config.allow_tf32
        torch.cuda.synchronize(dev)
    log(f"built {'tiny ' if lv.tiny else 'full-width '}{lv.model} on {dev} in "
        f"{time.perf_counter() - t0:.1f} s: {adapter_targets} LoRA sites, rank {LORA_RANK}")
    return BenchRun(levers=lv, config=config, frozen=frozen, state=state, sc=sc,
                    adapter_targets=adapter_targets, te1_config=te1_cfg)


class StepClock:
    """Marks each step's end on the device's timeline (a CUDA event, or the
    host clock on the CPU); `seconds()` gives each step's duration after the
    caller has synchronized."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: List[object] = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def seconds(self) -> List[float]:
        if self.cuda:
            return [a.elapsed_time(b) / 1e3 for a, b in zip(self.marks, self.marks[1:])]
        return [b - a for a, b in zip(self.marks, self.marks[1:])]


def make_call(run: BenchRun, sc, clock: Optional[StepClock] = None):
    """One bench call: `run_steps` over K batches, each step marked on `clock`."""
    from sd_lora_trainer_tpu_torch.training.step import make_train_step, run_steps

    step = make_train_step(sc, capture=run.levers.graph)
    k = run.levers.scan_k

    def marked(state, batch, frozen):
        metrics = step(state, batch, frozen)
        if clock is not None:
            clock.mark()
        return metrics

    def call(batch):
        return run_steps(marked, run.state, [batch] * k, run.frozen, k)

    return call, step


def launches_per_step(before: Dict[str, int], steps: int) -> Dict[str, float]:
    from sd_lora_trainer_tpu_torch.ops import flash_attention as fa

    now = fa.launch_counts()
    return {k: (now[k] - before[k]) / steps for k in now}


def step_flops(run: BenchRun, batch: Dict[str, torch.Tensor]) -> int:
    """Model FLOPs of one step at the bench's batch size: one row counted, times B."""
    from sd_lora_trainer_tpu_torch.utils.profiling import count_step_flops

    row = {k: (v[0, :1] if v.ndim > 0 else v) for k, v in batch.items()}
    return count_step_flops(run.sc, run.state.trainable, run.frozen, row) * run.levers.batch_size


def _loss(metrics) -> float:
    return float(metrics[-1]["tot_loss"])


def log_step_mode(step, what: str = "") -> None:
    """The step's mode (graph or eager, with the reason) and its captures."""
    caps = step.captures()
    secs = ", ".join(f"{c['capture_s']:.2f}" for c in caps)
    first = ", ".join(f"{c['warmup_s']:.2f}" for c in caps)
    log(f"{what}step mode {step.mode}"
        + (f" ({step.eager_reason})" if step.eager_reason else "")
        + (f", eager first step {first} s, captured in {secs} s, pool "
           f"+{sum(c['pool_gib'] for c in caps):.2f} GiB" if caps else ""))


def warmup_calls(lv: "Levers") -> int:
    """Calls that hold a key's eager first step and its capture: 2 steps."""
    return -(-2 // lv.scan_k)


def run_uniform(run: BenchRun) -> dict:
    """Warm-up call, FLOP count, timed calls, one profiled step."""
    from sd_lora_trainer_tpu_torch.ops import flash_attention as fa
    from sd_lora_trainer_tpu_torch.utils import profiling

    lv, dev = run.levers, run.levers.device
    latent = lv.resolution // 8
    batch = run.batch(latent, latent, np.random.RandomState(0))
    t0 = time.perf_counter()
    flops = step_flops(run, batch)
    log(f"model FLOPs counted in {time.perf_counter() - t0:.1f} s")
    clock = StepClock(dev)
    call, step = make_call(run, run.sc, clock)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(warmup_calls(lv)):  # the eager first step and the capture
        loss = _loss(call(batch))
    log(f"warm-up ({warmup_calls(lv) * lv.scan_k} steps) {time.perf_counter() - t0:.2f} s "
        f"(loss {loss:.4f})")
    log_step_mode(step)
    n_calls = max(lv.steps // lv.scan_k, 1)
    before = fa.launch_counts()
    clock.marks.clear()
    profiling.synchronize(dev)
    clock.mark()
    t0 = time.perf_counter()
    for i in range(n_calls):
        metrics = call(batch)
        if lv.log_losses:
            log(f"losses call {i}: " + ",".join(f"{float(m['tot_loss']):.6f}" for m in metrics))
    loss = _loss(metrics)  # a host fetch: waits for the device
    profiling.synchronize(dev)
    dt = time.perf_counter() - t0
    n_steps = n_calls * lv.scan_k
    per_step = clock.seconds()
    launches = launches_per_step(before, n_steps)
    out = {"seconds": dt, "steps": n_steps, "loss": loss, "per_step_s": per_step,
           "launches_per_step": launches, "flops_per_step": flops, "step_mode": step.mode}
    log(f"{n_steps} steps in {dt:.3f} s ({dt / n_steps:.3f} s/step, "
        f"{lv.batch_size * n_steps / dt:.3f} imgs/s), final loss {loss:.4f}")
    log("per-step s: " + ", ".join(f"{s:.3f}" for s in per_step))
    log(f"flash launches per step {launches}")
    if dev.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        log(f"peak memory {out['peak_gib']:.2f} GiB")
        wall, table = profiling.profile_device(lambda: step(run.state, batch, run.frozen), dev)
        # the profiler slows the host, not the device: the share is of an
        # unprofiled step's time
        out["busy_share"] = table.device_s / (dt / n_steps)
        log(f"one profiled step: device busy {table.device_s:.3f} s, "
            f"{out['busy_share']:.1%} of the mean timed step (wall {wall:.3f} s with the "
            "profiler on)")
        for line in table.lines("[bench] profile"):
            print(line, file=sys.stderr, flush=True)
    else:
        log("device busy share: not measured (no card)")
    return out


def run_bucketed(run: BenchRun) -> dict:
    """One step config per bucket (its own DAAM ratio w/h), a warm-up call
    each, then calls alternating round-robin."""
    from sd_lora_trainer_tpu_torch.ops import flash_attention as fa
    from sd_lora_trainer_tpu_torch.utils import profiling

    lv, dev = run.levers, run.levers.device
    rng = np.random.RandomState(0)
    clock = StepClock(dev)
    calls, steps, batches = [], [], []
    for h, w in lv.buckets:
        sc_b = dataclasses.replace(run.sc, daam_img_ratio=w / h)
        call, step = make_call(run, sc_b, clock)
        calls.append(call)
        steps.append(step)
        batches.append(run.batch(h // 8, w // 8, rng))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for (h, w), call, batch in zip(lv.buckets, calls, batches):
        t0 = time.perf_counter()
        for _ in range(warmup_calls(lv)):
            loss = _loss(call(batch))
        log(f"bucket {h}x{w} warm-up {time.perf_counter() - t0:.2f} s (loss {loss:.4f})")
    for (h, w), step in zip(lv.buckets, steps):
        log_step_mode(step, f"bucket {h}x{w}: ")
    n_calls = max(lv.steps // lv.scan_k, 2)
    before = fa.launch_counts()
    clock.marks.clear()
    profiling.synchronize(dev)
    clock.mark()
    t0 = time.perf_counter()
    for i in range(n_calls):
        metrics = calls[i % len(calls)](batches[i % len(calls)])
    loss = _loss(metrics)
    profiling.synchronize(dev)
    dt = time.perf_counter() - t0
    n_steps = n_calls * lv.scan_k
    per_step = clock.seconds()
    by_bucket: Dict[str, List[float]] = {}
    for i, s in enumerate(per_step):
        h, w = lv.buckets[(i // lv.scan_k) % len(lv.buckets)]
        by_bucket.setdefault(f"{h}x{w}", []).append(s)
    launches = launches_per_step(before, n_steps)
    log(f"{n_steps} bucketed steps in {dt:.3f} s (final loss {loss:.4f}); flash launches "
        f"per step {launches}")
    for name, secs in by_bucket.items():
        log(f"bucket {name}: {sum(secs) / len(secs):.3f} s/step over {len(secs)} steps "
            f"({', '.join(f'{s:.3f}' for s in secs)})")
    out = {"seconds": dt, "steps": n_steps, "loss": loss, "launches_per_step": launches,
           "s_per_step_by_bucket": {k: sum(v) / len(v) for k, v in by_bucket.items()},
           "step_mode": steps[0].mode}
    if dev.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        log(f"peak memory {out['peak_gib']:.2f} GiB")
    return out


def result_line(run: BenchRun, timed: dict) -> dict:
    """The JSON line of bench.py's schema."""
    from sd_lora_trainer_tpu_torch.utils import profiling

    lv = run.levers
    imgs_per_s = lv.batch_size * timed["steps"] / timed["seconds"]
    config = run.lever_config()
    config["device"] = profiling.device_description(lv.device)
    # what the run did, beside the levers: the step's mode (graph or eager),
    # its timed steps, their seconds and flash launches, and on a card its
    # peak memory and the profiled step's busy share
    config.update(step_mode=timed["step_mode"], timed_steps=timed["steps"],
                  flash_launches_per_step=timed["launches_per_step"],
                  **{k: timed[k] for k in ("per_step_s", "peak_gib", "busy_share") if k in timed})
    if lv.buckets:
        mean_px = sum(h * w for h, w in lv.buckets) / len(lv.buckets)
        anchor = ANCHOR_IMGS_PER_S_512 * (512.0**2 / mean_px)
        config["s_per_step_by_bucket"] = timed["s_per_step_by_bucket"]
        return {"metric": "train_throughput_bucketed", "value": round(imgs_per_s, 3),
                "unit": "imgs/sec/chip", "vs_baseline": round(imgs_per_s / anchor, 3),
                "config": config}
    anchor = ANCHOR_IMGS_PER_S_512 * (512.0 / lv.resolution) ** 2
    log(f"A100 anchor at {lv.resolution}px (pixel-normalized from 6.0 imgs/s at 512px): "
        f"{anchor:.2f} imgs/s")
    config.update(flops_per_step=timed["flops_per_step"], flops=FLOPS_CONVENTION)
    out = {"metric": f"{lv.model}_lora_train_imgs_per_sec_chip_{lv.resolution}px_bs{lv.batch_size}",
           "value": round(imgs_per_s, 3), "unit": "imgs/s",
           "vs_baseline": round(imgs_per_s / anchor, 3), "config": config}
    peak = (profiling.peak_bf16_flops(torch.cuda.get_device_name(lv.device))
            if lv.device.type == "cuda" else None)
    rate = timed["flops_per_step"] * timed["steps"] / timed["seconds"]
    if peak is None:
        log(f"mfu left out: no published peak for {config['device']!r} "
            f"({rate / 1e12:.2f} TFLOP/s achieved)")
    else:
        out["mfu"] = round(rate / peak, 4)
        log(f"step FLOPs {timed['flops_per_step'] / 1e12:.3f} TF ({FLOPS_CONVENTION}), "
            f"{rate / 1e12:.1f} TF/s, MFU {rate / peak:.2%} of {peak / 1e12:.0f} TF/s")
    return out


def main() -> int:
    stdout = sys.stdout
    try:
        levers = Levers.from_env()
    except BenchError as e:
        print(json.dumps({"metric": "train_throughput", "value": None, "unit": "imgs/s",
                          "vs_baseline": None, "error": str(e)}), file=stdout, flush=True)
        log(f"FATAL: {e}")
        return 1
    # the package's own prints (and anything else) go to stderr: stdout
    # carries the one JSON line
    with contextlib.redirect_stdout(sys.stderr):
        log(f"{levers.model} bs={levers.batch_size} {levers.resolution}px on {levers.device}, "
            f"K={levers.scan_k}" + (f", buckets {levers.buckets}" if levers.buckets else ""))
        run = setup(levers)
        timed = run_bucketed(run) if levers.buckets else run_uniform(run)
        out = result_line(run, timed)
    print(json.dumps(out), file=stdout, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
