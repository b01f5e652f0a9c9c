#!/usr/bin/env python3
"""Drive the PyTorch port's SDXL LoRA+TI train step on one CUDA card.

    python3 chip_smoke.py [--plan auto|full|off]

With no arguments it trains the batch of 4 of
train_configs/training_args_style_sdxl.json under two memory plans, one
after the other: "full" (a bf16 base, every layer recomputed in the
backward: the plan of the port's first slices), then "auto", the product
default that `StepConfig.from_config` resolves (the base quantized to int8
in place, `light+save:flash_out*,flash_lse*`: the plain resnet layers keep
their activations, the attention layers keep the flash residuals). `--plan`
runs one plan alone ("off": a bf16 base, nothing recomputed). Every
single-process step runs as the trainer runs it on a card: one CUDA graph
per step function and batch shape (training/step.py), its first step eager,
its second captured and replayed, every later one a replay; the train,
graph, optim, cli, sd15 and tools paths check that their steps ran so, and
time only replays. Phases, each fatal on failure (the script exits non-zero
and prints no result):
1. device: refuses to run without CUDA; prints the card's name and power
   limit, builds the flash kernels (flash_fwd, the fused flash_bwd) from
   csrc/ with nvcc, one unit per padded head dim 16-256 and kernel, all at
   once (the seconds of a cold build on a `[build]` line), and prints each
   instance's registers and spills;
2. kernels: each kernel against its plain PyTorch version in bf16 at the
   shapes the UNet gives it (SDXL 1024px bs=4, ragged buckets, SD1.5 head
   dims, the tp split's [4,5,4096,64] and [4,10,1024,64], SD1.5's face
   recipe at 768px: 9216 tokens at d=40, 2304 -> 3072 at 80, 576 -> 1024
   at 160) and at the rest of the JAX gate's head dims (16, 32, 36, 96,
   128, 192, 256, and 256 ragged), with its time, the plain version's and PyTorch SDPA's (forward
   beside flash_fwd, backward beside flash_bwd), and equal bits from every
   launch on the same inputs (flash_bwd's dq, dk and dv over
   RUN_TO_RUN_LAUNCHES);
3. reference: the self-attention LoRA-B gradients of a small SDXL-topology
   train loss (the JAX package's tiny SDXL UNet, head dim 32) on the card
   (flash kernels) against the same computation on the
   CPU (plain attention); on the card, the named plan keeping the flash
   residuals against full remat (and half the forward launches), and an int8
   base against the float32 one;
4. train: the full-width SDXL UNet (random weights from a seed, bf16), both
   text encoders, rank-16 LoRA on the 577 default sites, 3 TI rows per
   encoder and the three-group AdamW; per plan the eager first step, the
   capture, and 3 timed replays at 1024px, DAAM on, then one step under
   torch.profiler (device time by kernel family, the graph's kernels
   included), with the kernel launches counted per step (a replay's on the
   device, ops/flash_attention.py) and, in the profiled step, as the
   device ran them;
11. graph (after phase 4): the captured step against the eager one on phase
   4's trained state, under PyTorch's deterministic settings (`Deterministic`,
   one `[determinism]` line naming any op without a deterministic
   implementation): GRAPH_STEPS steps eagerly GRAPH_EAGER_RUNS times and as
   the capture and its replays twice, each from the same saved train state;
   every run's losses, update, generator state and flash launches equal to
   the first eager run's bit for bit (where an op warned: the spread gates,
   each graph loss and the update within GRAPH_FACTOR times the eager runs'
   largest difference); the same flash launches in a profiled step of each;
   s/step, device s/step, busy share, kernels a step, capture seconds and
   peak memory of both;
12. options (after phase 11): the training options beyond LoRA+TI inside
   the captured step. TE-LoRA (`text_encoder_lora_optimizer` "adamw": a
   third optimizer group whose LR warms up, both text encoders under
   autograd), int8+te (`quantize_base` "int8+te": int8 text encoders, the
   conditioning recomputed in the backward) and DoRA (`use_dora`: a
   per-output norm of W0 + s·BA at every LoRA'd projection, on the int8
   base, unfused). At the reference phase's small shape, under phase 11's
   deterministic settings: the LoRA+TI baseline and each option's
   first-step gradients of every group (UNet LoRA A, B and DoRA
   magnitudes, TI rows, TE-LoRA A, B) on the card against the CPU (rel L2
   <= OPTION_GRAD_TOL, int8+te quantized alike on both sides); then, per
   option, phase 11's graph-against-eager gates over OPTION_EAGER_RUNS
   eager runs, with each group's tensors after every step equal bit for bit
   (a replay must follow each group's LR schedule, not its capture's step;
   where an op warned: each group's update within the spread gates, over
   the run and at each step).
   At full width, on
   phase 4's run recast under each option: GRAPH_WARM steps and
   OPTION_TIMED timed replays, then a profiled one; finite metrics, every
   group moved, 70/70 flash launches a step (a replay's counted on the
   device); one `[options] {...}` line each with s/step, device s/step,
   busy share, peak GiB and capture seconds;
5. export: the trained adapters and TI rows through `save_checkpoint` (the
   kohya LoRA, the embeddings, special_params.json) and back through
   `load_checkpoint`, and the train state through `save_train_state` and
   `restore_train_state`, each equal bit for bit;
6. optim: the remaining training options at full SDXL width (random weights
   from a seed, bf16): Prodigy's updates and d and quantize_blockwise's
   indices on the card against the CPU (small seeded inputs); the TI warmup
   with both full-width encoders, 20 steps, its loss falling; the full
   finetune of train_configs/full_finetuning_example.json at 1024px bs=4
   (sharding_mode "fsdp" on one card, the plan "auto" resolves to there, a
   bf16 base) under AdamW, then AdamW8bit, a few steps each, with s/step,
   peak memory, the optimizer state's bytes and the update's own time
   (CUDA events around two eager updates after the steps); the 8-bit state must be uint8
   with one fp32 scale per 2048-element block and peak below AdamW's; then
   LoRA+TI on the default plan (fused qkv, int8 base) under Prodigy (UNet
   and TI, d of each group printed per step, above d0 once the first update
   has moved the tensors) and under AdamW, each saved after step 2, run to
   step 4, restored and rerun through steps 3-4 twice under deterministic
   settings, each rerun equal to the whole run bit for bit (within
   RESUME_TOL where an op warned);
7. cli: the product's own path, `python -m sd_lora_trainer_tpu_torch.main
   cfg.json` in a subprocess, on a full-width SDXL checkpoint file written
   here in fp16 (random weights from a seed, `synthesize_checkpoint`) and a
   folder of 8 synthetic 1024x1024 PNGs with captions, under the config of
   train_configs/training_args_style_sdxl.json cut to 10 steps and 2
   validation renders at 1024px (checkpointing_steps=5 cannot fire: the
   trainer skips checkpoints in the last 25 steps, so only the final save
   checkpoints and renders; no captioner, no GPT cleanup; everything
   else the product's defaults: bucketing, the "auto" plan, the int8 base,
   fused qkv, TI). Checks the artifact set, the LoRA read back bit for bit,
   finite losses, and flash launches by the train steps and by the render;
   prints each phase's time from the trainer's `[train-summary]` line;
10. sd15 (after phase 7): SD1.5 end to end. The CLI as in phase 7 on a
   full-width SD1.5 checkpoint file in fp16 (2.13 GB) under
   train_configs/training_args_face_sd15.json as published (768px, bs=4,
   rank 16, TI, face mode) but for the offline overrides: no captioner, a
   folder of 8 synthetic 768px PNGs (each with a skin-toned ellipse),
   10 steps, 2 renders, and the face-detection chain for CLIPSeg's face
   masks (no CLIPSeg weights offline; the heuristic-skin backend without
   mediapipe). Checks finite losses, the LoRA's keys and shapes against the
   JAX package's SD1.5 export (tests/golden/kohya_sd15_rank16.json), the TI
   rows, 15 flash_fwd + 15 flash_bwd a step and 375 flash_fwd a render
   call; prints `[sd15]` lines (load, preprocess and the face-mask backend,
   latent cache, s/step and peak, checkpoint, render s/img, launches) and
   the step's model FLOPs;
8. parallel: the parallel code, each run launched by
   `python -m torch.distributed.run` with this script's `--parallel-rank`
   as the ranks (one JSON file each, collected here; on a failure the tail
   of the ranks' output): "nccl1", 3 default-plan LoRA+TI steps of phase 4
   on one rank over NCCL; "dp2", the same with 2 ranks sharing the card over
   gloo (2 rows a rank); "tp2", LoRA+TI on a bf16 unfused base with the
   frozen UNet split over a model group of 2 (the flash kernels on each
   rank's 5 and 10 heads); "fsdp2", the full finetune of phase 6 sharded
   over 2 ranks, 2 steps under AdamW and 2 under AdamW8bit (tp2 and fsdp2
   at SDXL's widths with its depth cut, PARALLEL_CUT_DEPTH). Rank 0 then runs
   the same steps on one process, twice: the first step's gradients must
   agree within PARALLEL_GRAD_TOL, every step's loss within
   PARALLEL_LOSS_TOL, and the update within PARALLEL_UPDATE_FACTOR times
   the two one-process runs' own difference (at least PARALLEL_SPREAD_FLOOR);
   every rank prints s/step, peak memory, collective calls and bytes by
   kind (> 0 on the 2-rank runs) and flash launches (> 0 for both kernels);
9. tools (run before phase 8): the port's measurement tools as a user runs
   them, each a `python -m` subprocess: the bench at its defaults (SDXL
   1024px bs=8, K=4: exactly one JSON line, value > 0, 0 < mfu <= 1, 70/70
   flash launches a step), then with BENCH_MODEL=sd15 at its defaults
   (512px, bs=8, no remat: 15/15 a step), then bucketed (bs=4, 1024x1024 and 832x1216: the
   ragged full-width step, s/step per bucket); the model FLOP count at
   1024px bs=1 through the flash ops' formulas against plain attention's
   matmuls (within FLOP_TOL); the render bench (1024px, 25 steps, batch 4:
   s/img, 1750 flash_fwd a call); profile_step over 2 bench steps, its
   family table against `--summarize` of its exported trace (within
   PROFILE_TOL); the seeded tiny convergence run (the JAX recipe itself,
   its tiny SDXL UNet at 128px, cut to CONVERGENCE_STEPS steps: both
   quality trends improved, the loss drop beside the JAX run's).
After phase 5 an offload check runs on the trained state: one LoRA+TI loss
and backward under `offload:flash_out*,flash_lse*` against
`save:flash_out*,flash_lse*` (gradients within 1e-3, the kept tensors in
pinned host memory, the peak below save:'s; s/step of each).
It then prints the `kernels` JSON line (launches from the cli run, by path
in `launches_by_path`: the train plans, the options (`opt_*`), the optim
phase's paths, the cli run, the sd15 run, the tools of phase 9 and rank 0 of each parallel run,
a captured step's replays counted on the device where they launch; each
kernel's every case under `cases`), the nvidia-smi
line, and as the last line the result object. A `[time]` line after each
phase gives the seconds since the start and the phase's own.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import gc
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from typing import Optional

import torch

KERNEL_TOL = 2e-2  # max |kernel - plain| <= KERNEL_TOL * max |plain| (bf16 P and dS)
ROOT = os.path.dirname(os.path.abspath(__file__))
TRAIN_CONFIG = os.path.join(ROOT, "train_configs", "training_args_style_sdxl.json")
# the flash launches of one step per plan: 70 blocks per UNet pass, and full
# remat runs each forward once more in the backward
PLAN_LAUNCHES = {"full": {"flash_fwd": 140, "flash_bwd": 70},
                 "auto": {"flash_fwd": 70, "flash_bwd": 70},
                 "off": {"flash_fwd": 70, "flash_bwd": 70}}
REPLACES = {
    "flash_fwd": "sd_lora_trainer_tpu/ops/flash_attention.py:139,144",
    "flash_bwd": "sd_lora_trainer_tpu/ops/flash_attention.py:174,180",
}
# the PyTorch call timed as each kernel's library_ms (timed here, never used by the port)
LIBRARY_CALLS = {
    "flash_fwd": "F.scaled_dot_product_attention forward",
    "flash_bwd": "F.scaled_dot_product_attention backward (dq, dk, dv in one call)",
}
# how `ms`, `plain_ms` and `library_ms` are taken (see cuda_ms); the `kernels`
# line carries it so that numbers taken another way are not compared with them
TIMING = "device, queued behind a sleep kernel"
# (name, batch, heads, real length, head dim); the first two are SDXL 1024px bs=4
KERNEL_CASES = [
    ("sdxl_4096", 4, 10, 4096, 64),
    ("sdxl_1024", 4, 20, 1024, 64),
    ("ragged_3952", 4, 10, 3952, 64),
    ("ragged_300", 4, 20, 300, 64),
    ("sd15_d40_4096", 4, 8, 4096, 40),
    ("sd15_d80_1024", 4, 8, 1024, 80),
    ("sd15_d160_256", 4, 8, 256, 160),
    # the tp split's shapes: SDXL's 10 and 20 heads, 5 and 10 a rank of 2
    ("tp2_4096", 4, 5, 4096, 64),
    ("tp2_1024", 4, 10, 1024, 64),
    # SD1.5's face recipe at 768px bs=4 (the sd15 phase): 9216 tokens at
    # d=40 (batch 2 here: the plain version's fp32 logits take 5.4 GB a
    # tensor), 2304 padded to 3072 at d=80, 576 padded to 1024 at d=160
    ("sd15_face_9216", 2, 8, 9216, 40),
    ("sd15_face_2304", 4, 8, 2304, 80),
    ("sd15_face_576", 4, 8, 576, 160),
    # the rest of the JAX gate's head dims: the tiny UNets' 16 and 32, 36
    # (padded to 40 in device memory), 96, 128, 192, 256, and 256 ragged
    ("d16", 2, 4, 1024, 16),
    ("d32", 2, 4, 1024, 32),
    ("d36", 2, 4, 1024, 36),
    ("d96", 2, 4, 1024, 96),
    ("d128", 2, 4, 1024, 128),
    ("d192", 2, 4, 1024, 192),
    ("d256", 2, 4, 1024, 256),
    ("d256_ragged_1000", 2, 4, 1000, 256),
]
# calls per UNet pass at SDXL 1024px: 10 blocks at 4096 tokens, 60 at 1024
MAIN_PATH_CALLS = {"sdxl_4096": 10, "sdxl_1024": 60}
# flash_bwd's launches a case held bit-equal to the first (2 elsewhere, and
# for flash_fwd): more at SDXL's main shape and the longest sequence, where
# the most adders share a q tile
RUN_TO_RUN_LAUNCHES = {"sdxl_4096": 10, "sd15_face_9216": 10}


# a step function's first step for a batch shape runs eagerly and its second
# is captured (training/step.py): timed steps come after these
GRAPH_WARM = 2
GRAPH_STEPS = 4
# Phases 11 and 12 (graph against eager) and phase 6's resume run under
# PyTorch's deterministic settings (`Deterministic`). Where no op warned that
# it has no deterministic implementation, every run must equal the first
# eager run bit for bit: GRAPH_EAGER_RUNS and OPTION_EAGER_RUNS eager runs
# (which must equal each other), then the capture and its replays twice.
GRAPH_EAGER_RUNS = 2  # phase 11, full width
OPTION_EAGER_RUNS = 2  # phase 12, small shape
# Where an op warned, a phase keeps the spread gates it had while flash_bwd
# added dq by atomics (`_graph_gates`, `_option_gates`): the graph run within GRAPH_FACTOR
# times the eager runs' largest difference at the same step, with a floor of
# GRAPH_ULPS float32 roundings of each loss, over this many eager runs, which
# sample the outcomes that an Adam step of a gradient near eps takes (PERF.md,
# Findings); the second graph run is only printed then.
GRAPH_FACTOR = 5
GRAPH_ULPS = 8
SPREAD_EAGER_RUNS = {"graph": 4, "options": 10}
# cuBLAS is deterministic only with a fixed workspace, which it reads when
# CUDA starts: set before any card work (the phases' shakedowns import this
# module first too)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(*args) -> None:
    print(*args, flush=True)


class Deterministic:
    """PyTorch's deterministic settings over a phase: cuDNN's deterministic
    algorithms and no benchmark, no TF32, `torch.use_deterministic_algorithms`
    in warn-only mode (CUBLAS_WORKSPACE_CONFIG is set at import). `ops()`
    names each op that has warned so far that it has no deterministic
    implementation; on exit one `[determinism]` line names them all, and any
    other warning is shown as it would have been."""

    FLAGS = ((torch.backends.cuda.matmul, "allow_tf32", False),
             (torch.backends.cudnn, "allow_tf32", False),
             (torch.backends.cudnn, "deterministic", True),
             (torch.backends.cudnn, "benchmark", False))

    def __init__(self, phase: str):
        self.phase = phase

    def __enter__(self):
        self._saved = [getattr(mod, name) for mod, name, _ in self.FLAGS]
        self._algorithms = (torch.are_deterministic_algorithms_enabled(),
                            torch.is_deterministic_algorithms_warn_only_enabled())
        for mod, name, value in self.FLAGS:
            setattr(mod, name, value)
        torch.use_deterministic_algorithms(True, warn_only=True)
        self._catch = warnings.catch_warnings(record=True)
        self._caught = self._catch.__enter__()
        warnings.simplefilter("always")
        return self

    @staticmethod
    def _op(message: str) -> Optional[str]:
        if "does not have a deterministic implementation" in message:
            return message.split(" does not have a deterministic implementation")[0]
        if "CUBLAS_WORKSPACE_CONFIG" in message:
            return "cuBLAS (CUBLAS_WORKSPACE_CONFIG unset)"
        return None

    def count(self) -> int:
        """The warnings caught so far: `ops(count())` later names only the
        ops that warned after this call."""
        return len(self._caught)

    def ops(self, since: int = 0) -> list:
        return sorted({op for w in self._caught[since:] if (op := self._op(str(w.message)))})

    def __exit__(self, *exc):
        ops = self.ops()
        self._catch.__exit__(*exc)
        for (mod, name, _), value in zip(self.FLAGS, self._saved):
            setattr(mod, name, value)
        torch.use_deterministic_algorithms(self._algorithms[0], warn_only=self._algorithms[1])
        for w in self._caught:
            if not self._op(str(w.message)):
                warnings.showwarning(w.message, w.category, w.filename, w.lineno)
        log(f"[determinism] {self.phase}: ops without a deterministic implementation: "
            f"{', '.join(ops) if ops else 'none'}")
        return False


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Device ms per call: the calls queue behind a sleep kernel while the
    host issues them, so a call's host time (tens of µs, more than a small
    kernel's device time) does not count."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~25 ms at the H100's clock
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    from sd_lora_trainer_tpu_torch.ops import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; torch {torch.__version__}"
        f" cuda {torch.version.cuda}")
    cold = not any(kernels._lib_path(n).exists() for n in kernels.KERNEL_SOURCES)
    secs = kernels.build_kernels()
    log(f"[device] built {', '.join(kernels.KERNEL_SOURCES)} for sm_90a in {secs:.1f} s")
    units = len(kernels.KERNEL_SOURCES) * (len(kernels.HEAD_DIM_TILES) + 1)
    log(f"[build] {'cold' if cold else 'cached'}: {len(kernels.KERNEL_SOURCES)} kernels x "
        f"{len(kernels.HEAD_DIM_TILES)} head-dim tiles x 2 output types in {units} nvcc units, "
        f"{secs:.1f} s on {os.cpu_count()} cores")
    for name, report in kernels.BUILD_LOG.items():
        log(f"[device] ptxas {name}: " + "; ".join(kernels.ptxas_summary(report)))
    return smi


def _work(name: str, b: int, h: int, lp: int, valid: int, d: int) -> tuple:
    """(flops, bytes) one kernel call must do: the segment mask leaves
    valid^2 + (lp - valid)^2 (query, key) pairs."""
    pairs = valid**2 + (lp - valid) ** 2 if valid else lp**2
    # fwd: S and PV; bwd: S, dP, dV, dK and dQ
    mult = {"flash_fwd": 4, "flash_bwd": 10}[name]
    tile = b * h * lp * d * 2  # one bf16 [B, H, L, d] tensor
    rows = b * h * lp * 4  # one fp32 [B, H, L] tensor
    # fwd reads q, k, v and writes o, lse; bwd reads q, k, v, dO, lse, di
    # and writes dq, dk, dv
    nbytes = {"flash_fwd": 4 * tile + rows, "flash_bwd": 7 * tile + 2 * rows}[name]
    return mult * b * h * pairs * d, nbytes


def _bound_ms(flops: float, nbytes: float) -> tuple:
    from sd_lora_trainer_tpu_torch.utils.profiling import PEAK_BF16_FLOPS, PEAK_BYTES

    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_kernels():
    import torch.nn.functional as F

    from sd_lora_trainer_tpu_torch.ops import flash_attention as fa

    names = ("flash_fwd", "flash_bwd")
    summary = {n: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
                   "flops": 0.0, "bytes": 0.0, "cases": []} for n in names}
    dev = torch.device("cuda")
    for case, b, h, length, d in KERNEL_CASES:
        lp = fa._pad_plan(length)[0]
        valid = length if lp != length else 0
        g = torch.Generator(device=dev).manual_seed(0)
        q, k, v, do = (torch.randn(b, lp, h, d, generator=g, device=dev).bfloat16()
                       .transpose(1, 2) for _ in range(4))
        sc = 1.0 / math.sqrt(d)
        o_r, lse_r = fa.flash_fwd_ref(q, k, v, sc, valid)
        di = (o_r.float() * do.float()).sum(-1).contiguous()
        runs = {
            "flash_fwd": (lambda: fa.flash_fwd(q, k, v, sc, valid),
                          lambda: fa.flash_fwd_ref(q, k, v, sc, valid)),
            "flash_bwd": (lambda: fa.flash_bwd(q, k, v, do, lse_r, di, sc, valid),
                          lambda: fa.flash_bwd_ref(q, k, v, do, lse_r, di, sc, valid)),
        }
        mask = fa._attend_mask(lp, valid, dev) if valid else None
        qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))

        def sdpa_fwd():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=sc)

        out_s = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, scale=sc)

        def sdpa_bwd():  # dq, dk and dv in one call: the yardstick of flash_bwd
            return torch.autograd.grad(out_s, (qs, ks, vs), do, retain_graph=True)

        lib_fwd, lib_bwd = cuda_ms(sdpa_fwd), cuda_ms(sdpa_bwd)
        line = []
        for name in names:
            kern, plain = runs[name]
            got, want = kern(), plain()
            torch.cuda.synchronize()
            errs, tols = [], []
            for x, r in zip(got, want):
                check(bool(torch.isfinite(x.float()).all()), f"{name} {case}: non-finite output")
                errs.append(float((x.float() - r.float()).abs().max()))
                # lse is fp32 end to end: an absolute 1e-3; o, dk, dv, dq relative
                tols.append(1e-3 if r.dtype == torch.float32 else
                            KERNEL_TOL * float(r.float().abs().max()))
            for e, t in zip(errs, tols):
                check(e <= t, f"{name} {case}: max_abs_err {e:.3e} > tol {t:.3e}")
            tol = tols[0]
            # neither kernel adds in a varying order (flash_bwd's dq adds take
            # turns, csrc/flash_bwd.cu): every launch on the same inputs gives
            # the bits of the first
            n = RUN_TO_RUN_LAUNCHES.get(case, 2) if name == "flash_bwd" else 2
            for _ in range(n - 1):
                again = kern()
                diff = [float((x.float() - y.float()).abs().max()) for x, y in zip(got, again)]
                check(all(torch.equal(x, y) for x, y in zip(got, again)),
                      f"{name} {case}: two launches differ, max |diff| a output {diff}")
            extra = f" run_to_run=bitwise ({n} launches)"
            ms, plain_ms = cuda_ms(kern), cuda_ms(plain, iters=3, warmup=1)
            flops, nbytes = _work(name, b, h, lp, valid, d)
            bound, by = _bound_ms(flops, nbytes)
            lib = lib_fwd if name == "flash_fwd" else lib_bwd
            s = summary[name]
            s["err"] = max(s["err"], max(errs))
            n_calls = MAIN_PATH_CALLS.get(case, 0)
            for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound),
                             ("library_ms", lib), ("flops", flops), ("bytes", nbytes)):
                s[key] += n_calls * val
            s["cases"].append({"case": case, "shape": [b, h, lp, d], "valid": valid or lp,
                               "max_abs_err": max(errs), "run_to_run_launches": n,
                               "ms": ms, "plain_ms": plain_ms,
                               "bound_ms": bound, "bound_by": by, "library_ms": lib})
            line.append(f"{name} err={max(errs):.2e} (tol {tol:.2e}) ms={ms:.3f} "
                        f"plain_ms={plain_ms:.3f} bound_ms={bound:.4f} ({by}){extra}")
        log(f"[kernels] {case} [{b},{h},{lp},{d}] valid={valid or lp}: " + "; ".join(line)
            + f"; sdpa fwd {lib_fwd:.3f} ms, bwd {lib_bwd:.3f} ms")
        del q, k, v, do, o_r, lse_r, di, qs, ks, vs, out_s
        torch.cuda.empty_cache()
    return summary


def _lora_b_grads(run, draws, device, sites=".attn1.to_"):
    """The LoRA-B gradients of `sites` from one loss and backward of `run`.

    B starts at 0, so these gradients carry the attention's dQ, dK, dV (and
    the L1 penalty's subgradient, the same in every run compared)."""
    from sd_lora_trainer_tpu_torch.models.lora import iter_lora_leaves

    for t in run["tensors"]:
        t.grad = None
    loss, _ = run["compute_loss"]({k: v.to(device) for k, v in draws.items()})
    loss.backward()
    grads = torch.cat([e["b"].grad.flatten().cpu() for path, e in
                       iter_lora_leaves(run["state"].trainable["unet"]) if sites in path])
    return float(loss.detach()), grads


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def phase_reference():
    """Small SDXL-topology loss and grads, from the same weights, batch and
    draws (made on the CPU, then copied):
    - CUDA kernels vs CPU plain attention (gate 2e-2: the kernels round fp32
      operands to bf16 for the tensor cores);
    - on the card, the named plan keeping flash_out/flash_lse vs full remat
      (gate 1e-3: the same kernels; under the default algorithms cuDNN's
      weight gradients and the index backward add in a varying order), with
      half the forward launches;
    - on the card, an int8 base vs the float32 one under the resolved
      default plan (gate 3e-2, the JAX package's int8 bound,
      tests/test_quant.py).
    The loss is only printed: at the init scale the UNet's prediction is near
    zero, so the loss is about mean(noise^2) and does not see the attention
    outputs (it agrees to the last bit)."""
    from sd_lora_trainer_tpu_torch.models.quant import quantize_frozen
    from sd_lora_trainer_tpu_torch.ops import flash_attention as fa
    from sd_lora_trainer_tpu_torch.models.unet import TINY_SDXL_UNET_CONFIG
    from sd_lora_trainer_tpu_torch.training.step import StepConfig

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the JAX package's tiny SDXL UNet (head dim 32): the flash kernels take
    # its every transformer level (1024 and 256 tokens)
    cpu = _build_run(TINY_SDXL_UNET_CONFIG, "cpu", torch.float32, batch=2, latent_hw=64,
                     rank=4, fuse=True)
    g = torch.Generator().manual_seed(2)
    shape = tuple(cpu["batch"]["latent_mean"].shape[1:])
    draws = {"latent_eps": torch.randn(shape, generator=g), "noise": torch.randn(shape, generator=g),
             "offset_noise": torch.randn(shape[0], 1, 1, shape[-1], generator=g),
             "timesteps": torch.tensor([17, 640])}
    cuda = _moved(cpu, "cuda")
    n_blocks = 10  # transformer blocks of the small UNet, all on the flash path

    losses, grads, launched = {}, {}, {}
    for name, run, device, remat in (("cpu", cpu, "cpu", True), ("full", cuda, "cuda", True),
                                     ("named", cuda, "cuda", "save:flash_out*,flash_lse*")):
        run["sc"] = dataclasses.replace(run["sc"], remat=remat)
        fa.reset_launch_counts()
        losses[name], grads[name] = _lora_b_grads(run, draws, device)
        launched[name] = fa.launch_counts()
    rel = abs(losses["full"] - losses["cpu"]) / abs(losses["cpu"])
    g_rel = _rel(grads["full"], grads["cpu"])
    log(f"[reference] small SDXL loss cuda {losses['full']:.6f} cpu {losses['cpu']:.6f} "
        f"(rel {rel:.2e}); self-attention LoRA-B gradients rel L2 error {g_rel:.2e} over "
        f"{grads['cpu'].numel()} values; kernel launches {launched['full']}")
    check(all(n > 0 for n in launched["full"].values()), "the small run did not reach every kernel")
    check(g_rel <= 2e-2, f"small-input gradients differ from the CPU reference ({g_rel:.2e})")

    n_rel = _rel(grads["named"], grads["full"])
    log(f"[reference] plan save:flash_out*,flash_lse* vs remat=True on the card: LoRA-B gradients "
        f"rel L2 {n_rel:.2e} (gate 1e-3); launches {launched['named']} vs {launched['full']}")
    check(n_rel <= 1e-3, f"the named plan's gradients differ from full remat's ({n_rel:.2e})")
    check(launched["full"] == {"flash_fwd": 2 * n_blocks, "flash_bwd": n_blocks}
          and launched["named"] == {"flash_fwd": n_blocks, "flash_bwd": n_blocks},
          f"launches {launched}: the named plan must run each flash forward once")

    plan = StepConfig.from_config(cuda["config"], 1.0).remat  # the product's default
    cuda["sc"] = dataclasses.replace(cuda["sc"], remat=plan)
    _, f32 = _lora_b_grads(cuda, draws, "cuda", sites="")
    freed = quantize_frozen(cuda["frozen"], "int8")
    _, int8 = _lora_b_grads(cuda, draws, "cuda", sites="")
    q_rel = _rel(int8, f32)
    log(f"[reference] int8 base vs float32 base under {plan}: all LoRA-B gradients rel L2 "
        f"{q_rel:.2e} over {f32.numel()} values (gate 3e-2); {freed * 2**30 / 1e6:.2f} MB freed")
    check(q_rel <= 3e-2, f"the int8 base's gradients differ from the float32 base's ({q_rel:.2e})")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _tree_to(tree, device):
    if torch.is_tensor(tree):
        out = tree.detach().to(device)
        return out.requires_grad_() if tree.requires_grad else out
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to(v, device) for v in tree]
    return tree


def _moved(run, device):
    """A copy of a `_build_run` result with every tensor on `device`."""
    frozen = run["frozen"]
    frozen = dataclasses.replace(
        frozen, unet_params=_tree_to(frozen.unet_params, device),
        te1_params=_tree_to(frozen.te1_params, device),
        te2_params=_tree_to(frozen.te2_params, device),
        schedule=dataclasses.replace(frozen.schedule,
                                     alphas_cumprod=frozen.schedule.alphas_cumprod.to(device)),
        distribution_targets={k: type(v)(*(_tree_to(x, device) for x in dataclasses.astuple(v)))
                               for k, v in frozen.distribution_targets.items()},
    )
    return _assemble(run["config"], frozen, _tree_to(run["state"].trainable, device),
                     _tree_to(run["batch"], device), run["generator"])


def _load_config(path: str = TRAIN_CONFIG, overrides: Optional[dict] = None):
    """The TrainingConfig of the JSON at `path` with `overrides` applied
    before it is built (so that, e.g., use_dora zeroes the decays)."""
    from sd_lora_trainer_tpu_torch.config import TrainingConfig

    with open(path) as f:
        return TrainingConfig.from_dict({**json.load(f), **(overrides or {})})


def _te_lora(config, te1, te2, gen) -> dict:
    """TE-LoRA adapters on both text encoders, as the CLI makes them."""
    from sd_lora_trainer_tpu_torch.models.lora import TEXT_ENCODER_TARGETS, create_lora_params

    return {w: create_lora_params(te, config.text_encoder_lora_rank, gen,
                                  alpha_multiplier=config.lora_alpha_multiplier,
                                  targets=TEXT_ENCODER_TARGETS, use_dora=config.use_dora)
            for w, te in (("te1", te1), ("te2", te2))}


def _build_run(ucfg, device, dtype, batch: Optional[int], latent_hw: int, rank: int, fuse: bool,
               full: bool = False, config_path: str = TRAIN_CONFIG,
               overrides: Optional[dict] = None):
    """Frozen models, trainable tree, optimizer and batch of one SDXL run of
    the config at `config_path` with `overrides` (a LoRA, DoRA or full
    finetune, whose trainable UNet is a copy of the base, TE-LoRA when the
    config names its optimizer); `batch=None` keeps the config's batch size.
    The qkv projections are fused only where the CLI fuses them (`fuse` and
    no DoRA); the base stays unquantized."""
    from sd_lora_trainer_tpu_torch.diffusion.schedulers import DDPMSchedule
    from sd_lora_trainer_tpu_torch.models import clip
    from sd_lora_trainer_tpu_torch.models.fuse import fuse_attention_projections
    from sd_lora_trainer_tpu_torch.models.lora import create_lora_params
    from sd_lora_trainer_tpu_torch.models.unet import init_unet_params
    from sd_lora_trainer_tpu_torch.training import step as ts
    from sd_lora_trainer_tpu_torch.training.embeddings import initialize_new_tokens

    from sd_lora_trainer_tpu_torch.main import trainable_copy

    config = _load_config(config_path, overrides)
    batch = config.train_batch_size = batch or config.train_batch_size
    gen = torch.Generator(device=device).manual_seed(0)
    c1 = clip.CLIP_L_CONFIG if full else clip.TINY_CLIP_L_CONFIG
    c2 = clip.CLIP_BIG_G_CONFIG if full else clip.TINY_CLIP_G_CONFIG
    unet = init_unet_params(ucfg, gen, dtype=dtype, device=device)
    te1 = clip.init_clip_params(c1, gen, dtype=dtype, device=device)
    te2 = clip.init_clip_params(c2, gen, dtype=dtype, device=device)
    lora = (create_lora_params(unet, rank, gen, alpha_multiplier=config.lora_alpha_multiplier,
                               use_dora=config.use_dora)
            if config.is_lora else trainable_copy(unet))
    if fuse and not config.use_dora:
        unet = fuse_attention_projections(unet)
    tables = [t["text_model"]["embeddings"]["token_embedding"]["weight"] for t in (te1, te2)]
    rows, targets = initialize_new_tokens(tables, config.n_tokens, gen)
    frozen = ts.FrozenModels(
        unet_params=unet, te1_params=te1, te2_params=te2,
        schedule=DDPMSchedule.create(device=device), distribution_targets=targets,
        unet_config=ucfg, te1_config=c1, te2_config=c2, version="sdxl",
        resolution=(latent_hw * 8, latent_hw * 8),
    )
    vocab = c1.vocab_size
    ids = torch.full((1, batch, 77), c1.eos_token_id, dtype=torch.long)
    ids[..., 0] = vocab - 2  # BOS (49406 for the real vocab)
    ids[..., 1:4] = torch.arange(vocab, vocab + 3)  # the TI tokens appended to the table
    ids[..., 4:7] = torch.tensor([320, 1125, 539]) % vocab
    bgen = torch.Generator(device=device).manual_seed(1)
    shape = (1, batch, latent_hw, latent_hw, 4)
    batch_d = {
        "latent_mean": torch.randn(shape, generator=bgen, device=device).to(dtype),
        "latent_logvar": (torch.randn(shape, generator=bgen, device=device) * 0.1 - 6).to(dtype),
        "latent_scale": torch.tensor(0.13025, device=device),
        "mask": torch.ones(shape[:-1] + (1,), device=device, dtype=dtype),
        "input_ids": ids.to(device), "input_ids_2": ids.to(device),
        "caption_token_lengths": torch.full((1, batch), 8, device=device),
        "ti_token_positions": torch.tensor([1, 2, 3], device=device).repeat(1, batch, 1),
    }
    trainable = {"unet": lora}
    if not config.disable_ti:
        trainable["ti"] = {"te1": rows[0], "te2": rows[1]}
    if config.text_encoder_lora_optimizer is not None and config.is_lora:
        trainable["te_lora"] = _te_lora(config, te1, te2, gen)
    return _assemble(config, frozen, trainable, batch_d, gen)


def _assemble(config, frozen, trainable, batch_d, gen):
    from sd_lora_trainer_tpu_torch.training import step as ts
    from sd_lora_trainer_tpu_torch.training.optimizers import GroupOptimizer, group_tensors

    sc = ts.StepConfig.from_config(config, img_ratio=1.0)
    state = ts.TrainState(step=0, trainable=trainable,
                          optimizer=GroupOptimizer(config, trainable), generator=gen)
    mb = {k: (v[0] if v.ndim > 0 else v) for k, v in batch_d.items()}
    run = {"config": config, "state": state, "frozen": frozen, "sc": sc, "batch": batch_d,
           "generator": gen, "tensors": group_tensors(trainable)}
    # one micro-batch loss under the run's current frozen models and plan
    run["compute_loss"] = lambda draws: ts.compute_loss(trainable, run["frozen"], run["sc"], mb,
                                                        0, gen, **draws)
    return run


def phase_train(plans):
    """Train the full-width SDXL step under each plan in turn (the state
    carries over); returns the build and each plan's numbers and launches."""
    from sd_lora_trainer_tpu_torch.models.lora import iter_lora_leaves
    from sd_lora_trainer_tpu_torch.models.unet import SDXL_UNET_CONFIG
    from sd_lora_trainer_tpu_torch.training import step as ts

    hw = 128  # 1024px
    t0 = time.perf_counter()
    run = _build_run(SDXL_UNET_CONFIG, "cuda", torch.bfloat16, batch=None, latent_hw=hw, rank=16,
                     fuse=True, full=True)
    # the config's allow_tf32 (True by default) governs fp32 products on CUDA,
    # as in the upstream PyTorch trainer; the flash kernels do not read it
    torch.backends.cuda.matmul.allow_tf32 = run["config"].allow_tf32
    torch.backends.cudnn.allow_tf32 = run["config"].allow_tf32
    torch.cuda.synchronize()
    n_unet = sum(t.numel() for t in _leaves(run["frozen"].unet_params))
    n_te = sum(t.numel() for p in (run["frozen"].te1_params, run["frozen"].te2_params)
               for t in _leaves(p))
    n_sites = len(list(iter_lora_leaves(run["state"].trainable["unet"])))
    log(f"[train] built SDXL in {time.perf_counter() - t0:.1f} s: UNet {n_unet / 1e9:.3f}B, "
        f"TEs {n_te / 1e9:.3f}B params (bf16), LoRA sites {n_sites}, "
        f"DAAM on={run['sc'].token_attention_loss_w > 0}")
    check(n_sites == 577, f"expected 577 LoRA sites, got {n_sites}")
    default = ts.StepConfig.from_config(run["config"], img_ratio=1.0)
    results = {}
    for plan in plans:
        results[plan] = _train_plan(run, plan, default)
    rows = {p: {k: v for k, v in r.items() if k != "launches"} for p, r in results.items()}
    log("[train] plans " + json.dumps(rows))
    return run, results


def _train_plan(run, plan: str, default):
    from sd_lora_trainer_tpu_torch.models.quant import quantize_frozen
    from sd_lora_trainer_tpu_torch.ops import flash_attention as fa
    from sd_lora_trainer_tpu_torch.training import step as ts

    bs = run["config"].train_batch_size
    freed = 0.0
    if plan == "auto":
        # the product default: quantize the frozen base in place (its bf16
        # weights are freed), then the resolved plan
        freed = quantize_frozen(run["frozen"], run["config"].resolve_quantize_base())
        run["sc"] = default
    else:
        run["sc"] = dataclasses.replace(default, remat=plan == "full", stash8="", remat_te=False)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"[train] plan {plan}: remat={run['sc'].remat!r}, stash8={run['sc'].stash8!r}, "
        f"remat_te={run['sc'].remat_te}, base int8={freed > 0} ({freed:.2f} GiB freed)")
    train_step = ts.make_train_step(run["sc"])
    expected = PLAN_LAUNCHES[plan]
    fa.reset_launch_counts()  # this plan's run of the main path starts here
    step_secs, before = [], fa.launch_counts()
    for i in range(GRAPH_WARM + 3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = train_step(run["state"], run["batch"], run["frozen"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        now = fa.launch_counts()
        counts = {n: now[n] - before[n] for n in now}
        before = now
        vals = {k: float(v) for k, v in metrics.items()}
        kind = ("eager first step", "capture + replay")[i] if i < GRAPH_WARM else "timed"
        log(f"[train] {plan} step {i} ({kind}) {secs:.3f} s/step {bs / secs:.3f} imgs/s "
            f"launches {counts} " + json.dumps(vals))
        check(all(math.isfinite(x) for x in vals.values()), f"{plan} step {i}: non-finite metric")
        check(vals["grad_norm"] > 0, f"{plan} step {i}: grad_norm {vals['grad_norm']} is not > 0")
        check(counts == expected, f"{plan} step {i}: launches {counts} != {expected}")
        if i >= GRAPH_WARM:
            step_secs.append(secs)
    capture = _check_graph(train_step, f"train {plan}")
    launches = fa.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    mean = sum(step_secs) / len(step_secs)
    log(f"[train] SDXL 1024px bs={bs} plan {plan}: {mean:.3f} s/step, {bs / mean:.3f} imgs/s "
        f"(mean of {len(step_secs)} timed replays), peak memory {peak:.2f} GiB, capture "
        f"{capture['capture_s']:.2f} s")
    prof = _profile_step(train_step, run, expected)
    log(f"[profile] {plan}: device busy share of the mean timed step: {prof['device_s'] / mean:.1%}")
    return {"s_per_step": mean, "imgs_per_s": bs / mean, "timed_steps": step_secs,
            "peak_gib": peak, "gib_freed": freed, "busy_share": prof["device_s"] / mean,
            "capture_s": capture["capture_s"], **prof, "launches": launches}


def _check_graph(train_step, what: str, keys: int = 1) -> dict:
    """The step ran as captured graphs, one per key; returns the first capture."""
    caps = train_step.captures()
    check(train_step.mode == "graph" and len(caps) == keys,
          f"{what}: the step ran {train_step.mode} ({train_step.eager_reason}) with "
          f"{len(caps)} captures, not as {keys} graph(s)")
    return caps[0]


def _profile_step(train_step, run, expected) -> dict:
    """One more step under torch.profiler: its device kernel seconds, kernel
    count and ms by kernel family (the flash family split by kernel). The
    flash launches counted, and the flash kernels the device ran, must both
    be `expected`."""
    from sd_lora_trainer_tpu_torch.ops import flash_attention as fa
    from sd_lora_trainer_tpu_torch.utils.profiling import profile_device

    before = fa.launch_counts()
    wall, table = profile_device(lambda: train_step(run["state"], run["batch"], run["frozen"]),
                                 torch.device("cuda"))
    now = fa.launch_counts()
    counts = {n: now[n] - before[n] for n in now}
    check(counts == expected, f"profiled step: launches {counts} != {expected}")
    check(table.flash_launches == expected,
          f"profiled step: the device ran flash kernels {table.flash_launches} != {expected}")
    check(table.kernels > 0, "the profiler recorded no device time")
    log(f"[profile] profiled step wall {wall:.3f} s (profiler on)")
    for line in table.lines("[profile]"):
        log(line)
    return {"device_s": table.device_s, "kernels": table.kernels, "family_ms": table.family_ms,
            "flash_ms": {k[:40]: v for k, v in table.flash_ms.items()}}


def _group_params(state) -> dict:
    """Each optimizer group's tensors, cloned."""
    return {name: [p.detach().clone() for p in opt.params]
            for name, opt in state.optimizer.groups.items()}


def _flat(groups: dict) -> list:
    return [t for ts_ in groups.values() for t in ts_]


def _eager_pairs(out) -> list:
    """The pairs of eager runs of an `_eager_vs_graph` record."""
    return list(itertools.combinations([n for n in out if n.startswith("eager")], 2))


def _eager_vs_graph(run, eager_runs: int, per_step: bool = False, spread_runs: int = 0,
                    nondeterministic=lambda: []):
    """From one saved train state of `run`: GRAPH_STEPS eager steps,
    `eager_runs` times ("eager", "eager_2", ...), then as many graph steps,
    the capture and its replays, twice ("graph", "graph_2"; the
    second run replays the same capture; the graph's key took its eager
    first step from the same state beforehand); then, if
    `nondeterministic()` names an op, more eager runs up to `spread_runs`
    (the spread gates' sample). Returns the two step
    functions, each run's record (step seconds, losses, flash launches,
    peak GiB, the groups' tensors at its end and, with `per_step`, after
    each step, the generator's state) and the groups' tensors at the
    start."""
    from sd_lora_trainer_tpu_torch import checkpoint as ck
    from sd_lora_trainer_tpu_torch.ops import flash_attention as fa
    from sd_lora_trainer_tpu_torch.training import step as ts

    state, batch, frozen = run["state"], run["batch"], run["frozen"]
    steps = {"eager": ts.make_train_step(run["sc"], capture=False),
             "graph": ts.make_train_step(run["sc"])}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="graph_", dir=os.path.join(ROOT, "build"))
    path = os.path.join(tmp, "train_state.safetensors")
    out = {}
    try:
        ck.save_train_state(path, state)
        start = _group_params(state)
        ck.restore_train_state(path, state)
        steps["graph"](state, batch, frozen)  # the key's eager first step
        names = ["eager"] + [f"eager_{i}" for i in range(2, eager_runs + 1)] + ["graph", "graph_2"]
        for name in names:
            if name == "graph_2" and nondeterministic():
                names += [f"eager_{i}" for i in range(eager_runs + 1, spread_runs + 1)]
            step = steps[name.split("_")[0]]
            ck.restore_train_state(path, state)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            fa.reset_launch_counts()  # this path's run starts here
            secs, losses, after = [], [], []
            for _ in range(GRAPH_STEPS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                metrics = step(state, batch, frozen)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t)
                losses.append(float(metrics["tot_loss"]))
                if per_step:
                    after.append(_group_params(state))
            out[name] = {"steps_s": secs, "losses": losses, "launches": fa.launch_counts(),
                         "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                         "final": _group_params(state), "after": after,
                         "generator": state.generator.get_state()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return steps, out, start


def _update_rels(out, start, group: Optional[str] = None) -> tuple:
    """The graph run's update against the eager run's, and the eager runs'
    spread (their pairs' largest difference, `_eager_pairs`), rel L2 over
    every group's tensors (or `group`'s)."""
    pick = _flat if group is None else (lambda g: g[group])

    def rel(a, b):
        return _rel_l2(pick(out[a]["final"]), pick(out[b]["final"]), pick(start))

    return rel("graph", "eager"), max(rel(a, b) for a, b in _eager_pairs(out))


def _loss_spreads(out) -> list:
    """At each step, the eager runs' largest loss difference."""
    return [max(abs(out[a]["losses"][k] - out[b]["losses"][k]) for a, b in _eager_pairs(out))
            for k in range(GRAPH_STEPS)]


def _graph_gates(out, start, what: str) -> None:
    """Phase 11's gates on an `_eager_vs_graph` record: each graph loss
    within GRAPH_FACTOR times the eager runs' largest difference at that
    step (`_loss_spreads`; at least GRAPH_ULPS float32 roundings of the
    loss), the whole update within GRAPH_FACTOR times theirs
    (`_update_rels`), the generator's state bit-equal, the same flash
    launches in every run."""
    import numpy as np

    eager, graph = out["eager"], out["graph"]
    eps = float(np.finfo(np.float32).eps)
    spreads = _loss_spreads(out)
    loss_ok = [abs(g - e) <= GRAPH_FACTOR * max(d, GRAPH_ULPS * eps * abs(e))
               for e, g, d in zip(eager["losses"], graph["losses"], spreads)]
    rel_graph, rel_spread = _update_rels(out, start)
    check(all(loss_ok), f"{what}: graph losses {graph['losses']} against eager {eager['losses']} "
          f"(the eager runs' spread a step {[f'{d:.2e}' for d in spreads]}: "
          + ", ".join(f"{n} {r['losses']}" for n, r in out.items() if n.startswith("eager_"))
          + ")")
    check(rel_graph <= GRAPH_FACTOR * max(rel_spread, 1e-6),
          f"{what}: the graph run's update differs from the eager run's by rel L2 {rel_graph:.2e} "
          f"(the eager runs' spread {rel_spread:.2e})")
    check(all(torch.equal(r["generator"], eager["generator"]) for r in out.values()),
          f"{what}: the generator's state after the graph steps differs from the eager steps'")
    check(all(r["launches"] == eager["launches"] for r in out.values()),
          f"{what}: flash launches: " + ", ".join(f"{n} {r['launches']}" for n, r in out.items()))


def _exact_gates(out, start, what: str) -> None:
    """The gates of an `_eager_vs_graph` record under deterministic settings
    where no op warned: every run (the other eager runs, the graph's two)
    equals the first eager run bit for bit in each step's loss, each
    group's tensors after each step (with `per_step`) and at the end, the
    generator's state and the flash launches."""
    eager = out["eager"]

    def differ(a, b) -> dict:  # group -> max |a - b| where they differ
        return {g: max(float((x.float() - y.float()).abs().max()) for x, y in zip(a[g], b[g]))
                for g in b if not all(torch.equal(x, y) for x, y in zip(a[g], b[g]))}

    for name, r in out.items():
        if name == "eager":
            continue
        check(r["losses"] == eager["losses"],
              f"{what}: {name}'s losses {r['losses']} differ from eager's {eager['losses']}")
        for k, (got, want) in enumerate(zip(r["after"], eager["after"])):
            bad = differ(got, want)
            check(not bad, f"{what}: after step {k + 1}, {name} differs from eager in {bad}")
        bad = differ(r["final"], eager["final"])
        check(not bad, f"{what}: {name}'s update differs from eager's in {bad}")
        check(torch.equal(r["generator"], eager["generator"]),
              f"{what}: the generator's state after {name}'s steps differs from eager's")
        check(r["launches"] == eager["launches"],
              f"{what}: flash launches {name} {r['launches']}, eager {eager['launches']}")


def phase_graph(run) -> dict:
    """Phase 11: the step as one captured graph against the eager step, on
    phase 4's trained full-width SDXL LoRA+TI run (the "auto" plan), under
    deterministic settings (`Deterministic`). From one saved train state:
    GRAPH_STEPS eager steps, GRAPH_EAGER_RUNS times, then as many graph
    steps, the capture and its replays, twice (`_eager_vs_graph`). Gates:
    where no op warned, every run equal to the first eager one bit for bit
    (`_exact_gates`); else the spread gates over SPREAD_EAGER_RUNS["graph"]
    eager runs (`_graph_gates`). Then one profiled
    step of each: s/step, device s/step, busy share, kernels a step, capture
    seconds and peak memory, and the flash kernels the device ran, which
    must be a step's share of the launches counted."""
    from sd_lora_trainer_tpu_torch.utils.profiling import profile_device

    state, batch, frozen = run["state"], run["batch"], run["frozen"]
    bs = run["config"].train_batch_size
    with Deterministic("graph") as det:
        steps, out, start = _eager_vs_graph(run, GRAPH_EAGER_RUNS,
                                            spread_runs=SPREAD_EAGER_RUNS["graph"],
                                            nondeterministic=det.ops)
        for name in ("eager", "graph"):  # one more step each, profiled
            wall, table = profile_device(lambda: steps[name](state, batch, frozen),
                                         torch.device("cuda"))
            timed = out[name]["steps_s"][1:]  # the graph's first is its capture
            mean = sum(timed) / len(timed)
            out[name].update(s_per_step=mean, device_s=table.device_s, kernels=table.kernels,
                             busy_share=table.device_s / mean, traced=table.flash_launches)
        exact = not det.ops()
    eager, graph = out["eager"], out["graph"]
    capture = _check_graph(steps["graph"], "graph phase")
    for name in ("eager", "graph"):
        r = out[name]
        log(f"[graph] {name}: SDXL 1024px bs={bs}, plan {run['sc'].remat!r}: "
            f"{r['s_per_step']:.3f} s/step ({bs / r['s_per_step']:.3f} imgs/s; steps "
            f"{[round(x, 3) for x in r['steps_s']]} s), device {r['device_s']:.3f} s/step, busy "
            f"{r['busy_share']:.1%}, {r['kernels']} kernels a step (flash {r['traced']}), peak "
            f"{r['peak_gib']:.2f} GiB, "
            f"losses {[round(x, 6) for x in r['losses']]}, flash launches {r['launches']}")
    log(f"[graph] capture {capture['capture_s']:.2f} s, its pool +{capture['pool_gib']:.2f} GiB "
        f"reserved, flash launches a replay {capture['launches']}; peak {graph['peak_gib']:.2f} "
        f"GiB graph vs {eager['peak_gib']:.2f} GiB eager")
    rel_graph, rel_spread = _update_rels(out, start)

    def diffs(a, b):
        return [f"{abs(x - y):.2e}" for x, y in zip(out[a]["losses"], out[b]["losses"])]

    log(f"[graph] graph vs eager ({'bit for bit' if exact else 'the spread gates'}): losses "
        f"{diffs('graph', 'eager')}, eager runs "
        + ", ".join(f"{a}-{b} {diffs(a, b)}" for a, b in _eager_pairs(out))
        + f", the two graph runs {diffs('graph_2', 'graph')}; the "
        f"{GRAPH_STEPS}-step update rel L2 {rel_graph:.2e}, the eager runs' spread "
        f"{rel_spread:.2e}, the two graph runs "
        f"{_rel_l2(_flat(out['graph_2']['final']), _flat(graph['final']), _flat(start)):.2e}; "
        f"generator state equal {torch.equal(graph['generator'], eager['generator'])}")
    if exact:
        _exact_gates(out, start, "graph phase")
    else:
        _graph_gates(out, start, "graph phase")
    per_step = {k: v / GRAPH_STEPS for k, v in eager["launches"].items()}
    check(graph["traced"] == eager["traced"] == per_step,
          f"flash kernels in a profiled step: graph {graph['traced']}, eager {eager['traced']}, "
          f"counted a step {per_step}")
    return {name: {k: v for k, v in r.items() if k not in ("final", "after", "generator")}
            for name, r in out.items()} | {"capture": capture, "exact": exact}


# phase `options`: the training options beyond LoRA+TI that the CLI offers,
# as overrides of the style SDXL config, in the order they were brought up
OPTIONS = {"te_lora": {"text_encoder_lora_optimizer": "adamw"},
           "int8_te": {"quantize_base": "int8+te"},
           "dora": {"use_dora": True}}
OPTION_PATHS = tuple(f"opt_{name}" for name in OPTIONS)
OPTION_GRAD_TOL = 2e-2  # card vs CPU, the reference phase's gate (bf16 P and dS in flash)
OPTION_TIMED = 2  # full width: timed replays after the GRAPH_WARM steps


def _named_leaves(tree, path=()):
    if torch.is_tensor(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, path + (k,))


def _grads_by_kind(run, draws, device) -> dict:
    """One loss and backward of `run`: the gradients of each group, split by
    leaf name ("unet.a", "unet.b", "unet.magnitude", "ti", "te_lora.a",
    "te_lora.b"), flat float32 on the CPU."""
    for t in run["tensors"]:
        t.grad = None
    loss, _ = run["compute_loss"]({k: v.to(device) for k, v in draws.items()})
    loss.backward()
    out = {}
    for group, tree in run["state"].trainable.items():
        for path, t in _named_leaves(tree):
            g = t.grad if t.grad is not None else torch.zeros_like(t)
            kind = group if group == "ti" else f"{group}.{path[-1]}"
            out.setdefault(kind, []).append(g.detach().float().flatten().cpu())
    return {k: torch.cat(v) for k, v in out.items()}


def _rel0(a, b) -> float:
    """|a - b| / |b|, and |a - b| where b is all zeros (a gradient that is
    exactly 0 at init, as TE-LoRA's A with B = 0)."""
    n = float(b.norm())
    return float((a - b).norm()) / n if n > 0 else float((a - b).norm())


def _step_updates(out, start, group: str, k: int) -> dict:
    """Each run's update of `group` at step k of an `_eager_vs_graph` record."""
    return {name: [x - y for x, y in zip(r["after"][k][group],
                                         r["after"][k - 1][group] if k else start[group])]
            for name, r in out.items()}


def _option_rows(out, start) -> dict:
    """Each group's update, graph against eager and the eager runs' spread
    (`_update_rels`), over the run and at each step (the spread a step: the
    largest of `_eager_pairs`' differences), each step's eager update norm,
    and the two graph runs' difference over the run (printed only)."""
    rows = {}
    for group in start:
        rel_graph, rel_spread = _update_rels(out, start, group)
        steps, spreads, norms = [], [], []
        for k in range(GRAPH_STEPS):
            upd = _step_updates(out, start, group, k)
            norms.append(math.sqrt(sum(float((u.float() ** 2).sum()) for u in upd["eager"])))
            if norms[-1] == 0:  # every run must stay put: `_option_gates`
                steps.append(max(float(u.abs().max()) for n in upd for u in upd[n]))
                spreads.append(0.0)
                continue
            steps.append(_rel_l2(upd["graph"], upd["eager"]))
            spreads.append(max(_rel_l2(upd[a], upd[b]) for a, b in _eager_pairs(out)))
        rows[group] = {"update_rel": rel_graph, "spread_rel": rel_spread, "step_rel": steps,
                       "step_spread_rel": spreads, "step_norm": norms,
                       "graph_pair_rel": _rel_l2(out["graph_2"]["final"][group],
                                                 out["graph"]["final"][group], start[group])}
    return rows


def _option_gates(rows, what: str) -> None:
    """On `_option_rows`, after phase 11's gates: each group's update
    within GRAPH_FACTOR times the eager runs' spread over the run, and each
    step's within GRAPH_FACTOR times their spread at that step, as a loss
    is held: a replay that read a value of its capture's step (a scheduled
    LR, a count) updates otherwise than the eager step of the same count. A
    step whose eager update is exactly 0 (TE-LoRA's LR at count 0, warmup)
    must be 0 in every run."""
    for group, r in rows.items():
        check(r["update_rel"] <= GRAPH_FACTOR * max(r["spread_rel"], 1e-6),
              f"{what}: group {group}'s update differs between the graph and the eager run by rel "
              f"L2 {r['update_rel']:.2e} (the eager runs' spread {r['spread_rel']:.2e})")
        check(all(g <= GRAPH_FACTOR * max(d, 1e-6) if n > 0 else g == 0
                  for g, d, n in zip(r["step_rel"], r["step_spread_rel"], r["step_norm"])),
              f"{what}: group {group}'s updates a step differ between the graph and the eager run "
              f"by {r['step_rel']} (the eager runs' spread {r['step_spread_rel']}; eager norms "
              f"{r['step_norm']})")


def _options_small() -> dict:
    """Each option at the reference phase's small shape (JAX's tiny SDXL
    UNet, head dim 32: flash at 1024 and 256 tokens), under deterministic
    settings (`Deterministic`): the first step's gradients of every group on
    the card against the CPU, on the same weights, batch and draws (int8+te
    quantizes both sides' encoders alike), then, but for the LoRA+TI
    baseline, the graph against the eager step: bit for bit where no op of
    the option's runs warned (`_exact_gates`), else the spread gates over
    SPREAD_EAGER_RUNS["options"] eager runs (`_graph_gates`,
    `_option_gates`). With PyTorch's default algorithms two eager runs'
    4-step UNet updates differed by 7.5e-4 (TE-LoRA) and 1.2e-5 (int8+te)
    in one run (cuDNN's weight gradients, the index backward; PERF.md,
    Findings)."""
    with Deterministic("options (small shape)") as det:
        return _options_small_runs(det)


def _options_small_runs(det) -> dict:
    from sd_lora_trainer_tpu_torch.models.quant import quantize_frozen
    from sd_lora_trainer_tpu_torch.models.unet import TINY_SDXL_UNET_CONFIG
    from sd_lora_trainer_tpu_torch.training.optimizers import current_lrs

    out = {}
    for name, overrides in (("lora_ti", {}),) + tuple(OPTIONS.items()):
        since = det.count()  # the warnings of this option's runs
        cpu = _build_run(TINY_SDXL_UNET_CONFIG, "cpu", torch.float32, batch=2, latent_hw=64,
                         rank=4, fuse=True, overrides=overrides)
        cuda = _moved(cpu, "cuda")
        cuda["state"].generator = torch.Generator(device="cuda").manual_seed(0)
        base = "float32"
        if cpu["config"].resolve_quantize_base() == "int8+te":
            base = "int8+te"
            for r in (cpu, cuda):
                quantize_frozen(r["frozen"], base)
        g = torch.Generator().manual_seed(2)
        shape = tuple(cpu["batch"]["latent_mean"].shape[1:])
        draws = {"latent_eps": torch.randn(shape, generator=g),
                 "noise": torch.randn(shape, generator=g),
                 "offset_noise": torch.randn(shape[0], 1, 1, shape[-1], generator=g),
                 "timesteps": torch.tensor([17, 640])}
        want, got = _grads_by_kind(cpu, draws, "cpu"), _grads_by_kind(cuda, draws, "cuda")
        rel = {k: _rel0(got[k], want[k]) for k in want}
        log(f"[options] small {name} (remat {cuda['sc'].remat!r}, remat_te "
            f"{cuda['sc'].remat_te}, base {base}): first-step gradients card vs CPU rel L2 "
            + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()) + f" (gate {OPTION_GRAD_TOL})")
        check(all(v <= OPTION_GRAD_TOL for v in rel.values()),
              f"options {name}: the card's gradients differ from the CPU's: {rel}")
        row = {"grad_rel": rel}
        if name != "lora_ti":
            steps, record, start = _eager_vs_graph(
                cuda, OPTION_EAGER_RUNS, per_step=True, spread_runs=SPREAD_EAGER_RUNS["options"],
                nondeterministic=lambda: det.ops(since))
            _check_graph(steps["graph"], f"options small {name}")
            row["groups"] = _option_rows(record, start)
            row["exact"] = not det.ops(since)
            e, gr = record["eager"]["losses"], record["graph"]["losses"]
            lrs = [current_lrs(cuda["config"], k) for k in range(GRAPH_STEPS)]
            log(f"[options] small {name} ({'bit for bit' if row['exact'] else 'the spread gates'}"
                f"; ops without a deterministic implementation: {det.ops(since)}): graph vs eager losses "
                f"{[f'{abs(x - y):.2e}' for x, y in zip(e, gr)]} (the eager runs' spread "
                f"{[f'{d:.2e}' for d in _loss_spreads(record)]}); per group: "
                + json.dumps({grp: {k: (f"{v:.2e}" if isinstance(v, float) else
                                        [f"{x:.2e}" for x in v]) for k, v in r.items()}
                              for grp, r in row["groups"].items()})
                + f"; scheduled LRs a step {[{k: f'{v:.3g}' for k, v in lr.items()} for lr in lrs]}")
            if row["exact"]:
                _exact_gates(record, start, f"options small {name}")
            else:
                _graph_gates(record, start, f"options small {name}")
                _option_gates(row["groups"], f"options small {name}")
        out[name] = row
        del cpu, cuda
        gc.collect()
    return out


def _option_full_run(run, overrides: dict):
    """Phase 4's full-width SDXL run (the "auto" plan, its int8 fused UNet)
    recast under one option, as the CLI would build it: TE-LoRA adapters on
    both bf16 encoders; int8+te quantizes the encoders of a copy of the
    frozen models; DoRA trains on unfused projections (the CLI fuses no qkv
    under DoRA), so its base is the same seeded UNet built anew, its
    magnitudes taken from the bf16 weights before they are quantized."""
    from sd_lora_trainer_tpu_torch.models.lora import create_lora_params
    from sd_lora_trainer_tpu_torch.models.quant import quantize_base_weights, quantize_frozen
    from sd_lora_trainer_tpu_torch.models.unet import SDXL_UNET_CONFIG, init_unet_params

    config = _load_config(TRAIN_CONFIG, overrides)
    config.train_batch_size = run["config"].train_batch_size
    frozen = dataclasses.replace(run["frozen"])
    trainable = copy.deepcopy(run["state"].trainable)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if config.use_dora:
        unet = init_unet_params(SDXL_UNET_CONFIG, torch.Generator(device="cuda").manual_seed(0),
                                dtype=torch.bfloat16, device="cuda")
        trainable["unet"] = create_lora_params(unet, config.lora_rank, gen,
                                               alpha_multiplier=config.lora_alpha_multiplier,
                                               use_dora=True)
        frozen.unet_params = quantize_base_weights(unet)
        del unet
    if config.text_encoder_lora_optimizer is not None:
        trainable["te_lora"] = _te_lora(config, frozen.te1_params, frozen.te2_params, gen)
    quantize_frozen(frozen, config.resolve_quantize_base())
    return _assemble(config, frozen, trainable, run["batch"], gen)


def _drive_option(opt_run, name: str) -> dict:
    """GRAPH_WARM steps (the eager first, the capture) and OPTION_TIMED
    timed replays of an option's full-width step, then one profiled replay.
    Gates: finite metrics, the plan's flash launches every step (a replay's
    counted on the device), the step ran as one graph, every group moved."""
    from sd_lora_trainer_tpu_torch.ops import flash_attention as fa
    from sd_lora_trainer_tpu_torch.training import step as ts

    state, batch, frozen = opt_run["state"], opt_run["batch"], opt_run["frozen"]
    expected = PLAN_LAUNCHES["auto"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    train_step = ts.make_train_step(opt_run["sc"])
    start = _group_params(state)
    fa.reset_launch_counts()  # this option's run of the main path starts here
    before, secs, losses = fa.launch_counts(), [], []
    for i in range(GRAPH_WARM + OPTION_TIMED):
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = train_step(state, batch, frozen)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        now = fa.launch_counts()
        counts = {n: now[n] - before[n] for n in now}
        before = now
        vals = {k: float(v) for k, v in metrics.items()}
        losses.append(vals["tot_loss"])
        check(all(math.isfinite(x) for x in vals.values()), f"options {name} step {i}: {vals}")
        check(vals["grad_norm"] > 0, f"options {name} step {i}: grad_norm {vals['grad_norm']}")
        check(counts == expected, f"options {name} step {i}: launches {counts} != {expected}")
    launches = fa.launch_counts()
    capture = _check_graph(train_step, f"options {name}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    moved = {g: max(float((p.detach() - p0).abs().max()) for p, p0 in zip(opt.params, start[g]))
             for g, opt in state.optimizer.groups.items()}
    check(all(v > 0 for v in moved.values()), f"options {name}: a group did not move: {moved}")
    prof = _profile_step(train_step, opt_run, expected)
    mean = _mean(secs[GRAPH_WARM:])
    return {"option": name, "remat": opt_run["sc"].remat, "remat_te": opt_run["sc"].remat_te,
            "s_per_step": mean, "steps_s": secs, "device_s": prof["device_s"],
            "busy_share": prof["device_s"] / mean, "peak_gib": peak,
            "capture_s": capture["capture_s"], "pool_gib": capture["pool_gib"],
            "kernels": prof["kernels"], "losses": losses, "max_move": moved,
            "launches": launches}


def phase_options(run) -> dict:
    """The options the CLI offers beyond LoRA+TI, on the card inside the
    captured step: TE-LoRA (a third optimizer group, both text encoders
    under autograd), int8+te (int8 encoders, the conditioning recomputed in
    the backward) and DoRA (a per-output norm of W0 + s·BA at every LoRA'd
    layer, on the int8 base). At the small shape (`_options_small`): card
    against CPU, graph against eager. At full width (`_drive_option`, on
    phase 4's run): each option's step as a graph, one `[options] {...}`
    line each with s/step, device s/step, busy share, peak GiB and capture
    seconds. Returns the small shape's numbers and each option's row."""
    out = {"small": _options_small()}
    for name, overrides in OPTIONS.items():
        t0 = time.perf_counter()
        opt_run = _option_full_run(run, overrides)
        torch.cuda.synchronize()
        built = time.perf_counter() - t0
        row = _drive_option(opt_run, name)
        row["build_s"] = built
        log("[options] " + json.dumps({k: v for k, v in row.items() if k != "launches"}))
        out[name] = row
        del opt_run
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_export(run):
    """The trained state through the export surface and back, bit for bit:
    `save_checkpoint`/`load_checkpoint` (kohya LoRA, TI rows, token map) and
    `save_train_state`/`restore_train_state`. Written under build/ and
    removed after."""
    from sd_lora_trainer_tpu_torch import checkpoint as ck
    from sd_lora_trainer_tpu_torch.models.lora import iter_lora_leaves
    from sd_lora_trainer_tpu_torch.training import step as ts
    from sd_lora_trainer_tpu_torch.training.optimizers import GroupOptimizer
    from sd_lora_trainer_tpu_torch.utils.safetensors_io import load_safetensors

    config, state, frozen = run["config"], run["state"], run["frozen"]
    trainable = state.trainable
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="export_", dir=os.path.join(ROOT, "build"))
    try:
        t0 = time.perf_counter()
        rows = [trainable["ti"]["te1"], trainable["ti"]["te2"]]
        ck.save_checkpoint(tmp, state.step, config.name, "sdxl", config.token_dict, True,
                           ti_rows=rows, unet_lora=trainable["unet"])
        save_s = time.perf_counter() - t0
        name = config.name
        files = sorted(os.listdir(tmp))
        want = sorted([f"{name}_sdxl_lora.safetensors", f"{name}_sdxl_embeddings.safetensors",
                       "special_params.json"])
        check(files == want, f"export wrote {files}, expected {want}")
        lora = load_safetensors(os.path.join(tmp, f"{name}_sdxl_lora.safetensors"))
        n_unet = sum(k.startswith("lora_unet_") for k in lora)
        emb = load_safetensors(os.path.join(tmp, f"{name}_sdxl_embeddings.safetensors"))
        shapes = {k: list(v.shape) for k, v in emb.items()}
        n_sites = len(list(iter_lora_leaves(trainable["unet"])))  # 577 at full width
        check(n_unet == len(lora) == 3 * n_sites,
              f"the LoRA file has {n_unet} UNet keys of {len(lora)}, expected 3 x {n_sites}")
        want_shapes = {"clip_l": list(rows[0].shape), "clip_g": list(rows[1].shape)}
        check(shapes == want_shapes, f"embeddings {shapes}, expected {want_shapes}")
        back = ck.load_checkpoint(tmp, frozen.unet_params, [frozen.te1_params, frozen.te2_params],
                                  device=rows[0].device)
        leaves = dict(iter_lora_leaves(back["unet_lora"]))
        same = all(torch.equal(leaves[p]["a"], e["a"]) and torch.equal(leaves[p]["b"], e["b"])
                   for p, e in iter_lora_leaves(trainable["unet"]))
        same_rows = all(torch.equal(a, b) for a, b in zip(back["ti_rows"], rows))
        check(same and len(leaves) == n_sites, "the LoRA read back differs from the trained one")
        check(same_rows and back["token_dict"] == config.token_dict, "TI rows or token map differ")
        lora_mb = os.path.getsize(os.path.join(tmp, f"{name}_sdxl_lora.safetensors")) / 1e6

        path = os.path.join(tmp, "train_state.safetensors")
        t0 = time.perf_counter()
        ck.save_train_state(path, state)
        state_s = time.perf_counter() - t0
        fresh = copy.deepcopy(trainable)
        with torch.no_grad():
            for t in _leaves(fresh):
                t.zero_()
        template = ts.TrainState(step=0, trainable=fresh, optimizer=GroupOptimizer(config, fresh),
                                 generator=torch.Generator(state.generator.device).manual_seed(7))
        ck.restore_train_state(path, template)
        params, params_r = state.optimizer.params(), template.optimizer.params()
        opt, opt_r = state.optimizer.state_tensors(), template.optimizer.state_tensors()
        equal = (len(params) == len(params_r)
                 and all(torch.equal(a, b) for a, b in zip(params, params_r))
                 and opt.keys() == opt_r.keys()
                 and all(torch.equal(opt[k].cpu(), opt_r[k].cpu()) for k in opt)
                 and template.step == state.step
                 and template.optimizer.count == state.optimizer.count
                 and torch.equal(template.generator.get_state(), state.generator.get_state()))
        check(equal, "the restored train state differs from the live one")
        log(f"[export] {files}: {n_unet} UNet LoRA keys ({lora_mb:.1f} MB), embeddings {shapes}, "
            f"read back equal; train state of {len(params)} tensors (step {state.step}) saved in "
            f"{state_s:.2f} s and restored equal; checkpoint written in {save_s:.2f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _leaves(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


FF_CONFIG = os.path.join(ROOT, "train_configs", "full_finetuning_example.json")
OPTIM_STEPS = 4  # per full-finetune optimizer: the eager first step, the capture, 2 timed
# the optim phase's paths, each a run of the main path in `launches_by_path`
OPTIM_PATHS = ("ff_adamw", "ff_adamw8bit", "prodigy", "lora_adamw")
# resume on the card, under deterministic settings (`Deterministic`): the
# run restored from the step-2 state equals the whole run after steps 3-4 bit
# for bit, and so does a second rerun from the same file. Where an op warned
# that it has no deterministic implementation, the reruns are held instead
# to |resumed - whole| <= RESUME_TOL relative L2 over the steps 3-4 update:
# the spread that atomic adds in varying order gave (flash_bwd's dq before it
# added in a fixed order, torch's index backward of the TI rows and cuDNN's
# weight gradients under the default algorithms): Adam and Prodigy divide
# each gradient by its own running size, so an element whose gradient is
# near zero may step the other way (2.5e-2 for Prodigy on the first card
# run); a state restored without its optimizer state or its generator moved
# the update by 0.32-0.62 (tiny SDXL on the CPU)
RESUME_TOL = 0.1
# Prodigy's d stays d0 through the first update and grows as the tensors
# travel (on tiny SDXL LoRA+TI the TI group left d0 at step 5, the UNet at 9)
PRODIGY_STEPS = 12
PRODIGY_CARD_TOL = 1e-5  # card vs CPU, fp32: the sums over tensors in another order


def _state_bytes(optimizer) -> int:
    return sum(t.numel() * t.element_size() for t in optimizer.state_tensors().values())


def _update_ms(optimizer, n: int = 2) -> list:
    """The update's own ms from CUDA events, over n updates run eagerly
    after the steps (inside a captured step it has no events of its own),
    on zero gradients made before the first: the same work as a step's."""
    with torch.no_grad():
        for p in optimizer.params():
            p.grad = torch.zeros_like(p)
    out = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        optimizer.step()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    optimizer.zero_grad()
    return out


def _optim_card_vs_cpu() -> dict:
    """Prodigy's updates and d over 10 steps of a seeded quadratic, and
    quantize_blockwise's indices and scales, on the card against the CPU."""
    from sd_lora_trainer_tpu_torch.training.prodigy import Prodigy
    from sd_lora_trainer_tpu_torch.training.quantized_adam import quantize_blockwise

    g = torch.Generator().manual_seed(0)
    shapes = [(320, 64), (4096,), (16, 3, 3, 3), (7,)]
    init = [torch.randn(s, generator=g) for s in shapes]
    target = [torch.randn(s, generator=g) * 3 for s in shapes]
    out = {}
    for dev in ("cpu", "cuda"):
        params = [x.to(dev, copy=True).requires_grad_() for x in init]
        opt = Prodigy(params, growth_rate=1.05, weight_decay=0.004)
        ds = []
        for _ in range(10):
            for p, t in zip(params, target):
                p.grad = 2 * (p.detach() - t.to(dev))
            opt.step()
            ds.append(float(opt.d))
        out[dev] = ([p.detach().cpu() for p in params], ds)
    # each tensor's total move, against the CPU's: within PRODIGY_CARD_TOL of
    # its largest move, beyond one float32 rounding of p + u a step (|p| ~ 1
    # rounds at 1.2e-7, a step of d ~ 1e-6 moves it ~1e-6)
    p_err = 0.0
    for a, b, x in zip(out["cuda"][0], out["cpu"][0], init):
        ulp = torch.nextafter(b.abs(), torch.tensor(math.inf)) - b.abs()
        excess = ((a - b).abs() - 10 * ulp).clamp(min=0)
        p_err = max(p_err, float(excess.max() / (b - x).abs().max()))
    d_err = max(abs(a - b) / b for a, b in zip(out["cuda"][1], out["cpu"][1]))
    check(out["cpu"][1][-1] > 1e-6, f"Prodigy's d stayed at d0 on the CPU: {out['cpu'][1]}")
    check(p_err <= PRODIGY_CARD_TOL and d_err <= PRODIGY_CARD_TOL,
          f"Prodigy on the card differs from the CPU: params {p_err:.2e}, d {d_err:.2e}")

    x = torch.randn(5 * 2048 + 777, generator=g) * torch.logspace(-7, 0, 5 * 2048 + 777)
    x[:2048] = 0.0  # an all-zero block: scale 1
    same = True
    for signed in (True, False):
        v = x if signed else x.abs()
        q_cpu, s_cpu = quantize_blockwise(v, signed=signed)
        q_gpu, s_gpu = quantize_blockwise(v.cuda(), signed=signed)
        same &= torch.equal(q_gpu.cpu(), q_cpu) and torch.equal(s_gpu.cpu(), s_cpu)
    check(same, "quantize_blockwise on the card differs from the CPU")
    log(f"[optim] card vs CPU: Prodigy moves max err {p_err:.2e} of the largest move beyond "
        f"10 float32 roundings of p, d max rel err {d_err:.2e} "
        f"(tol {PRODIGY_CARD_TOL:.0e}; d {out['cpu'][1][0]:.3e} -> {out['cpu'][1][-1]:.3e} over "
        f"10 steps); quantize_blockwise indices and scales equal bit for bit")
    return {"prodigy_param_err": p_err, "prodigy_d_err": d_err}


def _optim_warmup(base) -> dict:
    """The TI warmup at full CLIP-L + bigG width: 20 AdamW steps of the
    three rows per encoder toward a description's encoding."""
    from sd_lora_trainer_tpu_torch.training.embeddings import initialize_new_tokens
    from sd_lora_trainer_tpu_torch.training.token_warmup import warmup_token_embeddings

    frozen, config = base["frozen"], base["config"]
    tables = [p["text_model"]["embeddings"]["token_embedding"]["weight"]
              for p in (frozen.te1_params, frozen.te2_params)]
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows, targets = initialize_new_tokens(tables, 3, gen)
    vocab = frozen.te1_config.vocab_size

    def ids(tokens):
        t = torch.full((1, 77), frozen.te1_config.eos_token_id, dtype=torch.long)
        t[0, 0] = vocab - 2
        t[0, 1:1 + len(tokens)] = torch.tensor(tokens)
        return t.cuda()

    token = ids([vocab, vocab + 1, vocab + 2])  # the rows appended to the tables
    target = ids([320, 1125, 539, 4009, 530, 320, 3638])  # a description's ids
    args = ({"te1": rows[0], "te2": rows[1]},
            {"te1": frozen.te1_params, "te2": frozen.te2_params},
            {"te1": frozen.te1_config, "te2": frozen.te2_config}, "sdxl",
            {"te1": token, "te2": token}, {"te1": target, "te2": target},
            {"te1": targets["te1"], "te2": targets["te2"]})
    kw = dict(ti_lr=config.ti_lr, ti_weight_decay=config.ti_weight_decay,
              tok_cov_reg_w=config.tok_cov_reg_w)
    _, first = warmup_token_embeddings(*args, steps=1, **kw)  # the loss at the initial rows
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warmed, last = warmup_token_embeddings(*args, steps=20, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    def total(h):  # the warmup's loss, from its terms
        return (h["concept_description_loss"][0] + 0.5 * h["token_std_loss"][0]
                + kw["tok_cov_reg_w"] * h.get("covariance_tok_reg_loss", [0.0])[0])

    l0, l1 = total(first), total(last)
    moved = max(float((warmed[w].detach() - r.detach()).abs().max())
                for w, r in zip(("te1", "te2"), rows))
    log(f"[optim] TI warmup, CLIP-L + bigG at full width: 20 steps in {secs:.2f} s "
        f"({secs / 20 * 1e3:.1f} ms/step); loss {l0:.6f} (step 1) -> {l1:.6f} (step 20), "
        f"description term {first['concept_description_loss'][0]:.6f} -> "
        f"{last['concept_description_loss'][0]:.6f}; rows moved up to {moved:.2e}")
    check(math.isfinite(l0) and math.isfinite(l1) and l1 < l0,
          f"the warmup loss did not fall: {l0} -> {l1}")
    return {"s": secs, "first_loss": l0, "last_loss": l1}


def _optim_full_finetune(base, optimizer_type: str) -> dict:
    """OPTIM_STEPS full-finetune steps under `optimizer_type`; a fresh
    trainable copy of the base each time."""
    from sd_lora_trainer_tpu_torch.main import trainable_copy
    from sd_lora_trainer_tpu_torch.ops import flash_attention as fa
    from sd_lora_trainer_tpu_torch.training import step as ts
    from sd_lora_trainer_tpu_torch.training.quantized_adam import BLOCK

    config = dataclasses.replace(base["config"], unet_optimizer_type=optimizer_type)
    frozen = base["frozen"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run = _assemble(config, frozen, {"unet": trainable_copy(frozen.unet_params)},
                    base["batch"], base["generator"])
    state, bs = run["state"], config.train_batch_size
    train_step = ts.make_train_step(run["sc"])
    fa.reset_launch_counts()  # this path's run starts here
    secs, losses = [], []
    for i in range(OPTIM_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = train_step(state, run["batch"], frozen)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        vals = {k: float(v) for k, v in metrics.items()}
        losses.append(vals["tot_loss"])
        check(all(math.isfinite(x) for x in vals.values()),
              f"full finetune {optimizer_type} step {i}: non-finite metric {vals}")
    launches = fa.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    _check_graph(train_step, f"full finetune {optimizer_type}")
    update_ms = _update_ms(state.optimizer)
    n_params = sum(p.numel() for p in state.optimizer.params())
    state_b = _state_bytes(state.optimizer)
    opt = state.optimizer.groups["unet"]
    if optimizer_type == "AdamW8bit":
        for i, p in enumerate(opt.params):
            m = opt.moments(i)
            nb = -(-p.numel() // BLOCK)
            check(all(m[k].dtype == torch.uint8 and tuple(m[k].shape) == (nb, BLOCK)
                      for k in ("mu_q", "nu_q"))
                  and all(m[k].dtype == torch.float32 and tuple(m[k].shape) == (nb,)
                          for k in ("mu_scale", "nu_scale")),
                  f"AdamW8bit tensor {i}: moments {[(k, v.dtype, tuple(v.shape)) for k, v in m.items()]}")
        layout = f"{len(opt.buckets)} flat buffers"
    else:
        layout = ", ".join(sorted({str(v.dtype) for v in opt.state_tensors().values()
                                   if v.ndim > 0}))
    mean = sum(secs[GRAPH_WARM:]) / len(secs[GRAPH_WARM:])
    per_step = {k: v / OPTIM_STEPS for k, v in launches.items()}
    log(f"[optim] full finetune {optimizer_type}: SDXL 1024px bs={bs}, plan {run['sc'].remat!r}, "
        f"{n_params / 1e9:.3f}B trainable ({len(opt.params)} tensors), steps "
        f"{[round(x, 3) for x in secs]} s ({mean:.3f} s/step timed), peak {peak:.2f} GiB, "
        f"optimizer state {state_b / 1e9:.3f} GB ({layout}), update "
        f"{[round(x, 1) for x in update_ms]} ms, flash launches a step {per_step}, "
        f"losses {[round(x, 5) for x in losses]}")
    check(all(v > 0 for v in launches.values()), f"full finetune {optimizer_type}: {launches}")
    result = {"s_per_step": mean, "steps_s": secs, "peak_gib": peak, "state_bytes": state_b,
              "update_ms": update_ms, "launches": launches, "losses": losses}
    del run, state, opt, train_step
    gc.collect()  # the run dict and the timed step hold reference cycles
    torch.cuda.empty_cache()
    return result


def _optim_resume(config, frozen, trainable, batch, gen, label: str) -> dict:
    """Steps 1-4 of a LoRA+TI run, the train state saved after step 2; then
    a template restored from it reruns steps 3-4, twice; all under
    deterministic settings (`Deterministic`). Returns the numbers and the
    first run's flash launches."""
    with Deterministic(f"optim resume ({label})") as det:
        return _optim_resume_runs(config, frozen, trainable, batch, gen, label, det)


def _optim_resume_runs(config, frozen, trainable, batch, gen, label: str, det) -> dict:
    from sd_lora_trainer_tpu_torch import checkpoint as ck
    from sd_lora_trainer_tpu_torch.ops import flash_attention as fa
    from sd_lora_trainer_tpu_torch.training import step as ts
    from sd_lora_trainer_tpu_torch.training.optimizers import GroupOptimizer
    from sd_lora_trainer_tpu_torch.training.prodigy import Prodigy

    run = _assemble(config, frozen, trainable, batch, gen)
    state, bs = run["state"], config.train_batch_size
    train_step = ts.make_train_step(run["sc"])
    prodigy = {n: o for n, o in state.optimizer.groups.items() if isinstance(o, Prodigy)}
    d0 = {n: float(o.d0) for n, o in prodigy.items()}
    tmp = tempfile.mkdtemp(prefix="resume_", dir=os.path.join(ROOT, "build"))
    try:
        path = os.path.join(tmp, "train_state.safetensors")
        fa.reset_launch_counts()  # this path's run starts here
        secs, losses, ds = [], [], []
        for i in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            metrics = train_step(state, run["batch"], frozen)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
            losses.append(float(metrics["tot_loss"]))
            ds.append({n: float(o.d) for n, o in prodigy.items()})
            check(all(math.isfinite(float(v)) for v in metrics.values()),
                  f"{label} step {i}: non-finite metric")
            if i == 1:
                ck.save_train_state(path, state)
                at_2 = [p.detach().clone() for p in state.optimizer.params()]
        launches = fa.launch_counts()
        whole = [p.detach().clone() for p in state.optimizer.params()]

        def rerun():
            """A zeroed copy of the trainables, restored from the step-2 file
            (bit for bit), through steps 3-4."""
            fresh = copy.deepcopy(state.trainable)
            with torch.no_grad():
                for t in _leaves(fresh):
                    t.zero_()
            template = ts.TrainState(step=0, trainable=fresh,
                                     optimizer=GroupOptimizer(config, fresh),
                                     generator=torch.Generator("cuda").manual_seed(11))
            ck.restore_train_state(path, template)
            check(template.step == 2 and all(torch.equal(a.detach(), b) for a, b in
                                             zip(template.optimizer.params(), at_2)),
                  f"{label}: the restored train state differs from the step-2 state")
            for _ in range(2):
                train_step(template, run["batch"], frozen)
            torch.cuda.synchronize()
            return [p.detach().clone() for p in template.optimizer.params()]

        def rel(x, y):  # |x - y| over the steps 3-4 update of y, L2 over all tensors
            num = sum(float(((a - b) ** 2).sum()) for a, b in zip(x, y))
            return math.sqrt(num / sum(float(((b - a) ** 2).sum()) for b, a in zip(y, at_2)))

        resumed, again = rerun(), rerun()
        _check_graph(train_step, label, keys=3)  # the run's state and the two templates
        rel_resume, rel_again = rel(resumed, whole), rel(again, resumed)
        max_abs = max(float((b - w).abs().max()) for b, w in zip(resumed, whole))
        equal = (all(torch.equal(b, w) for b, w in zip(resumed, whole))
                 and all(torch.equal(a, b) for a, b in zip(again, resumed)))
        exact = not det.ops()
        del resumed, again
        for _ in range(PRODIGY_STEPS - 4 if prodigy else 0):  # Prodigy's d needs more steps
            train_step(state, run["batch"], frozen)
            ds.append({n: float(o.d) for n, o in prodigy.items()})
        numerators = {n: float(o.d_numerator) for n, o in prodigy.items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    mean = sum(secs[GRAPH_WARM:]) / len(secs[GRAPH_WARM:])
    log(f"[optim] {label}: SDXL 1024px bs={bs}, plan {run['sc'].remat!r}, optimizers "
        f"{state.optimizer.kinds()}, steps {[round(x, 3) for x in secs]} s ({mean:.3f} s/step "
        f"after the eager first step and the capture), losses {[round(x, 5) for x in losses]}, flash launches a step "
        f"{ {k: v / 4 for k, v in launches.items()} }")
    if prodigy:
        log(f"[optim] {label}: d by step (1-{len(ds)}) "
            + "; ".join(f"{n} " + " ".join(f"{d[n]:.3e}" for d in ds) for n in prodigy)
            + f"; d_numerator at step {len(ds)} {numerators}")
    log(f"[optim] {label} resume: restored the step-2 state bit for bit (twice); steps 3-4: "
        f"resumed vs whole rel L2 {rel_resume:.2e}, max |diff| {max_abs:.2e}; the same steps "
        f"rerun twice from the same restored state: rel L2 {rel_again:.2e}; both equal bit for "
        f"bit {equal} (gate: " + ("bit for bit" if exact else f"{RESUME_TOL:.0e} for both") + ")")
    if exact:
        check(equal, f"{label}: the resumed run differs from the whole run ({rel_resume:.2e}, "
              f"max |diff| {max_abs:.2e}; rerun {rel_again:.2e})")
    else:
        check(rel_resume <= RESUME_TOL and rel_again <= RESUME_TOL,
              f"{label}: the resumed run differs from the whole run ({rel_resume:.2e}, rerun "
              f"{rel_again:.2e})")
    check(all(v > 0 for v in launches.values()), f"{label}: flash launches {launches}")
    if prodigy:
        # the first update leaves d at d0 (p = p0 makes its numerator 0); the
        # estimate then grows with the distance travelled: d never shrinks,
        # and leaves d0 in every group within PRODIGY_STEPS
        grows = all(b[n] >= a[n] >= d0[n] for a, b in zip(ds, ds[1:]) for n in prodigy)
        check(grows and all(ds[0][n] == d0[n] for n in prodigy),
              f"{label}: d {ds} shrank or left d0 at the first step")
        check(all(v > 0 for v in numerators.values()), f"{label}: d_numerator {numerators}")
        check(all(ds[-1][n] > d0[n] for n in prodigy),
              f"{label}: d {ds[-1]} did not grow past d0 in {len(ds)} steps")
    return {"s_per_step": mean, "steps_s": secs, "losses": losses, "d": ds,
            "resume_rel": rel_resume, "rerun_rel": rel_again, "resume_max_abs": max_abs,
            "resume_exact": exact, "launches": launches}


def phase_optim() -> dict:
    """The training options of slice 6 on the card; see the module docstring."""
    from sd_lora_trainer_tpu_torch.config import TrainingConfig
    from sd_lora_trainer_tpu_torch.models.fuse import fuse_attention_projections
    from sd_lora_trainer_tpu_torch.models.lora import create_lora_params
    from sd_lora_trainer_tpu_torch.models.quant import quantize_frozen
    from sd_lora_trainer_tpu_torch.models.unet import SDXL_UNET_CONFIG
    from sd_lora_trainer_tpu_torch.training.embeddings import initialize_new_tokens

    out = {"card_vs_cpu": _optim_card_vs_cpu()}
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    t0 = time.perf_counter()
    base = _build_run(SDXL_UNET_CONFIG, "cuda", torch.bfloat16, batch=None, latent_hw=128,
                      rank=16, fuse=False, full=True, config_path=FF_CONFIG)
    base["config"].resolution = 1024
    check(not base["config"].is_lora and base["config"].sharding_mode == "fsdp",
          "the full-finetune config changed")
    for key in ("state", "tensors", "compute_loss"):  # its trainable copy: each
        del base[key]  # optimizer below gets its own
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[optim] built SDXL (UNet and both encoders, bf16) in {time.perf_counter() - t0:.1f} s")
    out["warmup"] = _optim_warmup(base)
    out["ff_adamw"] = _optim_full_finetune(base, "adamw")
    out["ff_adamw8bit"] = _optim_full_finetune(base, "AdamW8bit")
    a, b = out["ff_adamw"], out["ff_adamw8bit"]
    log(f"[optim] full finetune: peak {a['peak_gib']:.2f} GiB (adamw) vs {b['peak_gib']:.2f} GiB "
        f"(AdamW8bit), state {a['state_bytes'] / 1e9:.3f} vs {b['state_bytes'] / 1e9:.3f} GB")
    check(b["peak_gib"] < a["peak_gib"], "the AdamW8bit run's peak is not below the AdamW run's")

    # LoRA+TI on the default plan: the adapters and rows from the bf16 base,
    # then the fused qkv copy and the int8 base, as the trainer does
    frozen = base["frozen"]
    lora_cfg = TrainingConfig.from_json(TRAIN_CONFIG)
    gen = torch.Generator(device="cuda").manual_seed(3)
    tables = [p["text_model"]["embeddings"]["token_embedding"]["weight"]
              for p in (frozen.te1_params, frozen.te2_params)]
    trainables = []
    for _ in range(2):
        rows, _ = initialize_new_tokens(tables, lora_cfg.n_tokens, gen)
        trainables.append({"unet": create_lora_params(frozen.unet_params, lora_cfg.lora_rank, gen,
                                                       alpha_multiplier=lora_cfg.lora_alpha_multiplier),
                           "ti": {"te1": rows[0], "te2": rows[1]}})
    frozen.unet_params = fuse_attention_projections(frozen.unet_params)
    freed = quantize_frozen(frozen, lora_cfg.resolve_quantize_base())
    log(f"[optim] LoRA+TI base: fused qkv, int8 ({freed:.2f} GiB freed)")
    prodigy_cfg = dataclasses.replace(lora_cfg, unet_optimizer_type="prodigy",
                                      ti_optimizer="prodigy")
    out["prodigy"] = _optim_resume(prodigy_cfg, frozen, trainables[0], base["batch"],
                                   torch.Generator(device="cuda").manual_seed(4), "LoRA+TI prodigy")
    out["lora_adamw"] = _optim_resume(lora_cfg, frozen, trainables[1], base["batch"],
                                      torch.Generator(device="cuda").manual_seed(4), "LoRA+TI adamw")
    return out


CLI_STEPS = 10
CLI_IMAGES = 8
CLI_RES = 1024


def _cli_images(folder: str, seed: int) -> None:
    """CLI_IMAGES CLI_RES^2 RGB PNGs (smooth colour fields plus noise, from
    numpy's RandomState) with a caption file each."""
    import numpy as np
    from PIL import Image

    rs = np.random.RandomState(seed)
    os.makedirs(folder, exist_ok=True)
    for i in range(CLI_IMAGES):
        coarse = rs.rand(8, 8, 3).astype(np.float32)
        field = torch.nn.functional.interpolate(
            torch.from_numpy(coarse).permute(2, 0, 1)[None], size=(CLI_RES, CLI_RES),
            mode="bilinear", align_corners=False)[0].permute(1, 2, 0).numpy()
        img = np.clip(field * 255 + rs.randn(CLI_RES, CLI_RES, 3) * 12, 0, 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(folder, f"{i}.png"))
        with open(os.path.join(folder, f"{i}.txt"), "w") as f:
            f.write(f"a painting of a landscape with hills number {i}")


def _run_cli(cfg: dict, tmp: str, what: str, timeout: int) -> tuple:
    """`python -m sd_lora_trainer_tpu_torch.main` on cfg, written into tmp and
    run there: (its `[train-summary]` numbers, wall seconds). A non-zero exit
    is fatal, with the tails of the trainer's stdout and stderr printed."""
    from sd_lora_trainer_tpu_torch.main import SUMMARY_TAG

    cfg_path = os.path.join(tmp, "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "sd_lora_trainer_tpu_torch.main", cfg_path],
                          cwd=tmp, capture_output=True, text=True, timeout=timeout,
                          env={**os.environ, "PYTHONPATH": ROOT})
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        log(proc.stdout[-4000:])
        log(proc.stderr[-4000:])
    check(proc.returncode == 0, f"{what} exited {proc.returncode}")
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(SUMMARY_TAG)]
    check(len(lines) == 1, f"{what} printed no summary line")
    return json.loads(lines[0][len(SUMMARY_TAG):]), wall


def phase_cli():
    """The trainer's CLI end to end on a full-width SDXL checkpoint file;
    returns its `[train-summary]` numbers. Everything it writes lives in a
    temp dir under build/, removed after."""
    from sd_lora_trainer_tpu_torch import checkpoint as ck
    from sd_lora_trainer_tpu_torch.models import clip
    from sd_lora_trainer_tpu_torch.models.lora import kohya_state_dict
    from sd_lora_trainer_tpu_torch.models.synthesize import synthesize_checkpoint
    from sd_lora_trainer_tpu_torch.models.unet import SDXL_UNET_CONFIG
    from sd_lora_trainer_tpu_torch.models.vae import SDXL_VAE_CONFIG
    from sd_lora_trainer_tpu_torch.models.weights import load_models_from_checkpoint
    from sd_lora_trainer_tpu_torch.utils.safetensors_io import load_safetensors

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="cli_", dir=os.path.join(ROOT, "build"))
    try:
        ckpt = os.path.join(tmp, "sdxl_fp16.safetensors")
        t0 = time.perf_counter()
        synthesize_checkpoint(ckpt, "sdxl", SDXL_UNET_CONFIG, SDXL_VAE_CONFIG, clip.CLIP_L_CONFIG,
                              clip.CLIP_BIG_G_CONFIG, seed=0, dtype=torch.float16, device="cuda")
        torch.cuda.empty_cache()
        gb = os.path.getsize(ckpt) / 1e9
        log(f"[cli] wrote a full-width SDXL checkpoint (fp16, {gb:.2f} GB) in "
            f"{time.perf_counter() - t0:.1f} s; disk free {shutil.disk_usage(tmp).free / 1e9:.0f} GB")
        data = os.path.join(tmp, "data")
        _cli_images(data, seed=0)
        with open(TRAIN_CONFIG) as f:
            cfg = json.load(f)
        name = cfg["name"]
        cfg.update(lora_training_urls=data, ckpt_path=ckpt, output_dir=os.path.join(tmp, "runs"),
                   caption_model="no_caption", skip_gpt_cleanup=True, max_train_steps=CLI_STEPS,
                   checkpointing_steps=5, n_sample_imgs=2, validation_img_size=CLI_RES)
        summ, wall = _run_cli(cfg, tmp, "the CLI trainer", timeout=700)

        runs = os.listdir(os.path.join(tmp, "runs"))
        save_dir = os.path.join(tmp, "runs", runs[0], "checkpoints", f"checkpoint-{CLI_STEPS}")
        files = sorted(os.listdir(save_dir))
        for want in (f"{name}_sdxl_lora.safetensors", f"{name}_sdxl_embeddings.safetensors",
                     "special_params.json", "training_args.json"):
            check(want in files, f"the CLI wrote {files}, without {want}")
        check(any(f.startswith("validation_grid") and f.endswith((".jpg", ".png")) for f in files),
              f"no validation grid among {files}")
        lora_sd = load_safetensors(os.path.join(save_dir, f"{name}_sdxl_lora.safetensors"))
        n_unet = sum(k.startswith("lora_unet_") for k in lora_sd)
        check(n_unet == 1731, f"the LoRA file has {n_unet} UNet keys, expected 1731")
        emb = load_safetensors(os.path.join(save_dir, f"{name}_sdxl_embeddings.safetensors"))
        shapes = {k: list(v.shape) for k, v in emb.items()}
        check(shapes == {"clip_l": [3, 768], "clip_g": [3, 1280]}, f"embeddings {shapes}")
        # the base trees on the meta device give the module paths to read back with
        meta = load_models_from_checkpoint(ckpt, dtype=torch.float16, device="meta")
        back = ck.load_checkpoint(save_dir, meta.unet, [meta.text_encoder, meta.text_encoder_2],
                                  device="cpu")
        again = kohya_state_dict(back["unet_lora"], back["te_loras"])
        same = again.keys() == lora_sd.keys() and all(torch.equal(again[k], lora_sd[k])
                                                      for k in lora_sd)
        check(same, "the LoRA read back through load_checkpoint differs from the file")
        losses = summ["tot_loss"]
        check(len(losses) == CLI_STEPS and all(math.isfinite(x) for x in losses),
              f"losses {losses}")
        check(summ["step_mode"] == "graph" and summ["captures"],
              f"the CLI's steps ran {summ['step_mode']}, captures {summ['captures']}")
        train_l, render_l = summ["launches"]["train"], summ["launches"]["render"]
        n_img = sum(summ["rendered_images"])
        render_fwd = sum(r["flash_fwd"] for r in render_l)
        check(train_l["flash_fwd"] > 0 and train_l["flash_bwd"] > 0,
              f"the train steps launched {train_l}")
        check(render_fwd > 0, f"the render launched {render_l}")
        enc = summ["vae_encode"]
        log(f"[cli] trainer rc 0 in {wall:.1f} s; artifacts {files}; {n_unet} UNet LoRA keys, "
            f"embeddings {shapes}, read back equal")
        log(f"[cli] load {summ['load_s']:.1f} s")
        log(f"[cli] preprocess {summ['preprocess_s']:.1f} s")
        log(f"[cli] latent cache {summ['latent_cache_s']:.1f} s ({enc['images']} images, "
            f"{enc['images'] / summ['latent_cache_s']:.2f} images/s; VAE encode {enc['s']:.2f} s, "
            f"peak {enc['peak_gib']:.2f} GiB with {enc['resident_gib']:.2f} GiB resident)")
        log(f"[cli] loop {summ['s_per_step']:.3f} s/step over {summ['steps']} steps, replays "
            f"{summ['s_per_replay']:.3f} s/step (the loop less the first step and the capture) "
            f"(bs 4, 1024px; host batch prep {summ['batch_prep_s'] / summ['steps']:.3f} s/step); "
            f"losses {[round(x, 5) for x in losses]}; launches {train_l}; step mode "
            f"{summ['step_mode']}, first step and capture {[(round(c['warmup_s'], 2), round(c['capture_s'], 2)) for c in summ['captures']]} s")
        log(f"[cli] checkpoint {sum(summ['checkpoint_s']):.2f} s")
        log(f"[cli] render {sum(summ['render_s']) / n_img:.2f} s per image ({n_img} images at "
            f"{CLI_RES}px, 25 steps), flash_fwd launches per image {render_fwd / n_img:.0f}")
        total = {k: train_l[k] + sum(r[k] for r in render_l) for k in train_l}
        return {"summary": summ, "launches": total, "train_launches": train_l,
                "render_launches": {k: sum(r[k] for r in render_l) for k in train_l}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# the sd15 phase: the repo's published SD1.5 recipe through the CLI
SD15_CONFIG = os.path.join(ROOT, "train_configs", "training_args_face_sd15.json")
SD15_STEPS, SD15_IMAGES, SD15_RENDERS = 10, 8, 2
# self-attention blocks of SD1.5's UNet that take the flash kernels: 5 at
# each of the three transformer levels (2 down, 3 up); the mid block's
# (144 tokens at 768px, 64 at 512px) stays plain, under the 256-token gate
SD15_FLASH_BLOCKS = 15
# a render call: 25 CFG Euler steps, cond and uncond in one batch
SD15_RENDER_FWD = 25 * SD15_FLASH_BLOCKS


def _face_images(folder: str, res: int, seed: int) -> None:
    """SD15_IMAGES res^2 RGB PNGs with a caption each: a cool-toned smooth
    field (blue over green, outside YCrCb's skin range) with one skin-toned
    ellipse, the face the heuristic-skin backend finds, at a seeded place
    and size in the upper-center of the frame."""
    import numpy as np
    from PIL import Image, ImageDraw

    rs = np.random.RandomState(seed)
    os.makedirs(folder, exist_ok=True)
    for i in range(SD15_IMAGES):
        coarse = rs.rand(6, 6, 3).astype(np.float32) * [60, 100, 90] + [20, 60, 130]
        field = torch.nn.functional.interpolate(
            torch.from_numpy(coarse).permute(2, 0, 1)[None], size=(res, res),
            mode="bilinear", align_corners=False)[0].permute(1, 2, 0).numpy()
        img = Image.fromarray(np.clip(field + rs.randn(res, res, 3) * 6, 0, 255).astype(np.uint8))
        cx, cy = res * (0.4 + 0.2 * rs.rand()), res * (0.3 + 0.15 * rs.rand())
        rx, ry = res * (0.12 + 0.05 * rs.rand()), res * (0.17 + 0.05 * rs.rand())
        skin = tuple(int(c) for c in rs.randint(-12, 13, 3) + [222, 170, 140])
        ImageDraw.Draw(img).ellipse((cx - rx, cy - ry, cx + rx, cy + ry), fill=skin)
        img.save(os.path.join(folder, f"{i}.png"))
        with open(os.path.join(folder, f"{i}.txt"), "w") as f:
            f.write(f"a photo of a person, portrait number {i}")


def phase_sd15():
    """SD1.5 end to end: the published face recipe through the CLI on a
    full-width SD1.5 fp16 checkpoint file; returns the flash launches of its
    train steps and of its render. Everything it writes lives in a temp dir
    under build/, removed after."""
    from sd_lora_trainer_tpu_torch.models import clip
    from sd_lora_trainer_tpu_torch.models.synthesize import synthesize_checkpoint
    from sd_lora_trainer_tpu_torch.models.unet import SD15_UNET_CONFIG
    from sd_lora_trainer_tpu_torch.models.vae import SD15_VAE_CONFIG
    from sd_lora_trainer_tpu_torch.utils.safetensors_io import load_safetensors

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="sd15_", dir=os.path.join(ROOT, "build"))
    try:
        ckpt = os.path.join(tmp, "sd15_fp16.safetensors")
        t0 = time.perf_counter()
        synthesize_checkpoint(ckpt, "sd15", SD15_UNET_CONFIG, SD15_VAE_CONFIG, clip.CLIP_L_CONFIG,
                              None, seed=0, dtype=torch.float16, device="cuda")
        torch.cuda.empty_cache()
        gb = os.path.getsize(ckpt) / 1e9
        log(f"[sd15] wrote a full-width SD1.5 checkpoint (fp16, {gb:.2f} GB) in "
            f"{time.perf_counter() - t0:.1f} s")
        check(1.9 < gb < 2.3, f"the SD1.5 checkpoint holds {gb:.2f} GB, expected ~2.13")
        with open(SD15_CONFIG) as f:
            cfg = json.load(f)
        res, bs, name = cfg["resolution"], cfg["train_batch_size"], cfg["name"]
        data = os.path.join(tmp, "data")
        _face_images(data, res, seed=0)
        # the offline overrides alone: no captioner weights, a local folder, 10
        # steps, 2 renders; the checkpoint file and where the run writes. Face
        # mode's masks come from CLIPSeg prompted "face", whose weights are not
        # on the machine (the masks would fall back to the full image): the
        # face-detection chain (data/face_masks.py) stands in for it offline
        cfg.update(caption_model="no_caption", lora_training_urls=data,
                   max_train_steps=SD15_STEPS, n_sample_imgs=SD15_RENDERS, ckpt_path=ckpt,
                   output_dir=os.path.join(tmp, "runs"), use_face_detection_instead=True)
        summ, wall = _run_cli(cfg, tmp, "the SD1.5 CLI run", timeout=600)

        runs = os.listdir(os.path.join(tmp, "runs"))
        save_dir = os.path.join(tmp, "runs", runs[0], "checkpoints", f"checkpoint-{SD15_STEPS}")
        files = sorted(os.listdir(save_dir))
        lora_file, emb_file = f"{name}_sd15_lora.safetensors", f"{name}_sd15_embeddings.safetensors"
        for want in (lora_file, emb_file, "special_params.json", "training_args.json"):
            check(want in files, f"the SD1.5 run wrote {files}, without {want}")
        check(any(f.startswith("validation_grid") for f in files), f"no validation grid in {files}")
        with open(os.path.join(save_dir, "training_args.json")) as f:
            args = json.load(f)
        backend = args["training_attributes"].get("face_mask_backend")
        check(backend is not None, "face mode chose no face-mask backend")
        # the UNet LoRA keys and shapes of the JAX package's SD1.5 export at
        # rank 16 (tests/golden/kohya_sd15_rank16.json, pinned on the CPU by
        # tests/test_torch_export.py), read back from the file
        with open(os.path.join(ROOT, "tests", "golden", "kohya_sd15_rank16.json")) as f:
            golden = {k: v for k, v in json.load(f)["keys"].items() if k.startswith("lora_unet_")}
        lora_sd = load_safetensors(os.path.join(save_dir, lora_file))
        got = {k: list(v.shape) for k, v in lora_sd.items()}
        check(got == golden, f"the SD1.5 LoRA's keys differ from the JAX export's: "
              f"{sorted(set(got) ^ set(golden))[:6]}")
        check(all(bool(torch.isfinite(v.float()).all()) for v in lora_sd.values()),
              "non-finite values in the SD1.5 LoRA")
        emb = {k: list(v.shape) for k, v in load_safetensors(os.path.join(save_dir, emb_file)).items()}
        check(emb == {"clip_l": [3, 768]}, f"SD1.5 embeddings {emb}")
        losses = summ["tot_loss"]
        check(len(losses) == SD15_STEPS and all(math.isfinite(x) for x in losses),
              f"SD1.5 losses {losses}")
        check(summ["step_mode"] == "graph" and summ["captures"],
              f"the SD1.5 steps ran {summ['step_mode']}, captures {summ['captures']}")
        train_l, render_l = summ["launches"]["train"], summ["launches"]["render"]
        per_step = {k: v / summ["steps"] for k, v in train_l.items()}
        check(per_step == {"flash_fwd": SD15_FLASH_BLOCKS, "flash_bwd": SD15_FLASH_BLOCKS},
              f"SD1.5 flash launches a step {per_step}, expected {SD15_FLASH_BLOCKS} of each")
        n_img = sum(summ["rendered_images"])
        render = {k: sum(r[k] for r in render_l) for k in train_l}
        check(n_img == SD15_RENDERS and render == {"flash_fwd": SD15_RENDER_FWD * len(render_l),
                                                    "flash_bwd": 0},
              f"SD1.5 render: {n_img} images, launches {render_l}")
        enc = summ["vae_encode"]
        log(f"[sd15] face recipe {os.path.basename(SD15_CONFIG)}: {res}px, bs {bs}, rank "
            f"{cfg['lora_rank']}, TI {not cfg['disable_ti']}, concept_mode {cfg['concept_mode']}; "
            f"trainer rc 0 in {wall:.1f} s; artifacts {files}")
        degraded = [f"{d['stage']}: {d['got']}"
                     for d in args["training_attributes"].get("degradations", [])]
        log(f"[sd15] degradations the run recorded: {degraded}")
        log(f"[sd15] load {summ['load_s']:.1f} s; preprocess {summ['preprocess_s']:.1f} s "
            f"(face-mask backend {backend}); latent cache {summ['latent_cache_s']:.1f} s "
            f"({enc['images']} images; VAE encode {enc['s']:.2f} s, peak {enc['peak_gib']:.2f} GiB)")
        log(f"[sd15] loop {summ['s_per_step']:.3f} s/step over {summ['steps']} steps, replays "
            f"{summ['s_per_replay']:.3f} s/step (the loop less the first step and the capture), peak "
            f"{summ['loop_peak_gib']:.2f} GiB; losses {[round(x, 5) for x in losses]}; step mode "
            f"{summ['step_mode']}, first step and capture {[(round(c['warmup_s'], 2), round(c['capture_s'], 2)) for c in summ['captures']]} s")
        log(f"[sd15] {len(got)} UNet LoRA keys as the JAX export's, embeddings {emb}; checkpoint "
            f"{sum(summ['checkpoint_s']):.2f} s")
        log(f"[sd15] render {sum(summ['render_s']) / n_img:.2f} s per image ({n_img} images at "
            f"{res}px, 25 steps)")
        log(f"[sd15] flash launches: train {train_l} ({SD15_FLASH_BLOCKS} + "
            f"{SD15_FLASH_BLOCKS} a step), render {render} ({SD15_RENDER_FWD} a call)")
        flops = _sd15_step_flops(res, bs)
        log(f"[sd15] model FLOPs of the face recipe's step ({res}px, bs {bs}; bench.step_flops, "
            f"remat off): {flops / 1e12:.3f} TF; {flops / summ['s_per_step'] / 1e12:.1f} TF/s at "
            f"the loop's s/step, {flops / summ['s_per_replay'] / 1e12:.1f} TF/s at the replays'")
        return {"summary": summ, "train_launches": train_l, "render_launches": render,
                "step_flops": flops}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _sd15_step_flops(res: int, bs: int) -> float:
    """Model FLOPs of one SD1.5 LoRA+TI step at res and bs, counted as the
    bench counts them (one row under FlopCounterMode, remat off, times B)."""
    import numpy as np

    from sd_lora_trainer_tpu_torch import bench

    run = bench.setup(bench.Levers.from_env({"BENCH_MODEL": "sd15", "BENCH_RES": str(res),
                                             "BENCH_BS": str(bs), "BENCH_REMAT": "off",
                                             "BENCH_SCAN": "1"}))
    try:
        return bench.step_flops(run, run.batch(res // 8, res // 8, np.random.RandomState(0)))
    finally:
        del run
        gc.collect()
        torch.cuda.empty_cache()


# phase 8: each run of the parallel code, launched by torchrun; the card is
# one, so the 2-rank runs share it over gloo (NCCL refuses two ranks on one
# device). (ranks, backend, sharding mode, full finetune)
PARALLEL_RUNS = {"nccl1": (1, "nccl", "dp", False), "dp2": (2, "gloo", "dp", False),
                 "tp2": (2, "gloo", "tp", False), "fsdp2": (2, "gloo", "fsdp", True)}
# tp's all-reduces (per transformer block) and fsdp's gathers (of every
# weight) cross the host over gloo: at SDXL's full depth tp2 took 14-66 s a
# step, and the two runs 251-455 s of the script (H100 80GB HBM3 at 700 W).
# They keep SDXL's widths and heads with 2 transformer blocks where it has
# 10, 22 of its 70 blocks
PARALLEL_CUT_RUNS = ("tp2", "fsdp2")
PARALLEL_CUT_DEPTH = {"transformer_layers": (0, 2, 2), "mid_transformer_layers": 2}
PARALLEL_LORA_STEPS = 3
PARALLEL_FF_STEPS = 2  # per optimizer, AdamW then AdamW8bit
# the first step's gradients, parallel against one process (same params and
# draws): the reference phase's card-vs-CPU gate (bf16 kernels, another
# order of the sums over rows and heads, torch's atomic backward ops)
PARALLEL_GRAD_TOL = 2e-2
# every step's loss, parallel against one process, relative
PARALLEL_LOSS_TOL = 1e-2
# The update after the steps, parallel against one process (relative L2
# over every tensor), is held to this many times the spread of two
# identical one-process runs measured beside it, not to RESUME_TOL. Adam's
# first updates move each element by about the LR whatever its gradient's
# size, so an element whose gradient sits at the rounding noise steps
# either way: two identical one-process runs differ by 0.07-0.12 after 2-3
# steps (H100, this phase). A parallel run's gradients differ from one
# process's by more than that run-to-run noise (GEMMs over 2 rows instead
# of 4, other sums over rows and heads), and its update by 1.9-2.9 times
# the spread (H100 80GB HBM3 at 700 W, every run of this phase). An update
# unrelated to the reference reads about 1.4 (two independent sign
# patterns), over 10 times the spread.
PARALLEL_UPDATE_FACTOR = 5
# The spread the update gate scales by is at least the smallest two
# identical one-process runs read while flash_bwd added dq by atomics in a
# varying order (0.071 on the H100). Now that flash_bwd adds dq in a fixed
# order the two runs can be equal bit for bit (they were, on the H100),
# which would hold a parallel run's own rounding differences, amplified by
# Adam's first steps to 0.05-0.28 (dp2, tp2, fsdp2 on the H100), to 0.
PARALLEL_SPREAD_FLOOR = 0.07
# the train state's gather under fsdp (what save_train_state writes, every
# rank entering): the card's memory above what it held before, GiB. The
# gather holds one whole tensor at a time on a card (SDXL's largest
# trainable is 26 MB in bf16) and lands in rank 0's host memory
PARALLEL_SAVE_GIB = 1.0


def _parallel_setup(run: str, device):
    """The run's frozen models, initial trainables, batch and config, built
    from the same seeds as every other rank's and as its reference's."""
    from sd_lora_trainer_tpu_torch.models.quant import quantize_frozen
    from sd_lora_trainer_tpu_torch.models.unet import SDXL_UNET_CONFIG

    _, _, mode, full = PARALLEL_RUNS[run]
    ucfg = (dataclasses.replace(SDXL_UNET_CONFIG, **PARALLEL_CUT_DEPTH)
            if run in PARALLEL_CUT_RUNS else SDXL_UNET_CONFIG)
    built = _build_run(ucfg, str(device), torch.bfloat16, batch=None, latent_hw=128,
                       rank=16, fuse=mode != "tp" and not full, full=True,
                       config_path=FF_CONFIG if full else TRAIN_CONFIG)
    config = built["config"]
    config.sharding_mode = mode
    if full:
        config.resolution = 1024
    elif mode != "tp":
        quantize_frozen(built["frozen"], config.resolve_quantize_base())  # the default plan
    init = {} if full else copy.deepcopy(built["state"].trainable)
    for key in ("state", "tensors", "compute_loss"):  # each run below makes its own
        del built[key]
    return built["frozen"], init, built["batch"], config


def _parallel_steps(config, frozen, trainable, batch, steps: int, plan=None,
                    ref_grads=None, save_check: bool = False) -> dict:
    """`steps` train steps (the generator seeded alike on every rank and in
    the reference); the trainables after them, gathered whole on rank 0
    (None on the others). The first step's gradients are kept, or, given
    `ref_grads`, only their rel L2 against those. `save_check`: the
    gathers also take the train state as `save_train_state` writes it, and
    the card's memory above what it held before them is recorded."""
    from sd_lora_trainer_tpu_torch.checkpoint import whole_train_state
    from sd_lora_trainer_tpu_torch.ops import flash_attention as fa
    from sd_lora_trainer_tpu_torch.parallel import sharding as sh
    from sd_lora_trainer_tpu_torch.parallel.distributed import unshard_to_rank0
    from sd_lora_trainer_tpu_torch.training import step as ts
    from sd_lora_trainer_tpu_torch.training.optimizers import GroupOptimizer, group_tensors

    device = batch["latent_mean"].device
    totals = {"unet": plan.batch.total} if plan is not None and plan.fsdp is not None else None
    state = ts.TrainState(step=0, trainable=trainable,
                          optimizer=GroupOptimizer(config, trainable, totals),
                          generator=torch.Generator(device=device).manual_seed(11))
    sc = dataclasses.replace(ts.StepConfig.from_config(config, 1.0), parallel=plan)
    step = ts.make_train_step(sc)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()  # this path's run starts here
    sh.reset_collective_stats()
    secs, losses, grads, grad_rel = [], [], None, None
    for i in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = step(state, batch, frozen)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        losses.append(float(metrics["tot_loss"]))
        if i == 0:  # the first step's gradients (same params and draws in every run)
            grads = [_whole_grad(t, plan) for t in group_tensors(state.trainable)]
            if ref_grads is not None:
                grad_rel = (_rel_l2(grads, ref_grads), _sign_frac(grads, ref_grads))
                grads = None
    out = {"grads": grads, "grad_rel": grad_rel, "steps_s": secs,
           # after the first step, and in graph mode after the capture too
           # (nan when no step is left: the one-process fsdp runs)
           "s_per_step": _mean(secs[GRAPH_WARM if step.mode == "graph" else 1:]),
           "losses": losses, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": fa.launch_counts(), "collectives": sh.collective_stats(),
           "kinds": state.optimizer.kinds()}
    state.optimizer.zero_grad()
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    whole = unshard_to_rank0(state.trainable, plan)
    if save_check:
        tensors = whole_train_state(state, plan, whole)
        torch.cuda.synchronize()
        out["save"] = {"s": time.perf_counter() - t,
                       "over_gib": (torch.cuda.max_memory_allocated() - before) / 2**30,
                       "tensors": None if tensors is None else len(tensors),
                       "gb": None if tensors is None else sum(
                           v.numel() * v.element_size() for v in tensors.values()) / 1e9,
                       "on_device_gb": None if tensors is None else sum(
                           v.numel() * v.element_size() for v in tensors.values()
                           if v.is_cuda) / 1e9}
        del tensors
    out["final"] = ([t.detach().to(device, copy=True) for t in group_tensors(whole)]
                    if plan is None or plan.mesh.is_main else None)
    del state, step, whole
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _mean(xs) -> float:
    return sum(xs) / len(xs) if xs else float("nan")


def _whole_grad(t, plan):
    g = t.grad if t.grad is not None else torch.zeros_like(t)
    if plan is not None and plan.is_sharded(t):
        return plan.fsdp.full_of(t, g)
    return g.detach().clone()


def _sign_frac(xs, ys) -> float:
    """The share of elements whose signs differ: where Adam's first update
    (lr x sign(g)) of two runs differs."""
    differ = sum(int((torch.sign(x) != torch.sign(y)).sum()) for x, y in zip(xs, ys))
    return differ / sum(x.numel() for x in xs)


def _rel_l2(xs, ys, base=None) -> float:
    """|xs - ys| over |ys - base| (over |ys| without a base), L2 over every tensor."""
    num = sum(float(((x.float() - y.float()) ** 2).sum()) for x, y in zip(xs, ys))
    den = sum(float(((y.float() - (0 if b is None else b.float())) ** 2).sum())
              for y, b in zip(ys, base or [None] * len(ys)))
    return math.sqrt(num / den)


def parallel_rank(run: str) -> int:
    """One rank of a phase-8 run (started by torchrun): the run's steps under
    its plan; rank 0 then runs the same steps on one process, no plan, and
    compares. Writes its numbers to CHIP_SMOKE_RANK_DIR/<run>_<rank>.json."""
    import torch.distributed as dist

    from sd_lora_trainer_tpu_torch.main import trainable_copy
    from sd_lora_trainer_tpu_torch.parallel import sharding as sh
    from sd_lora_trainer_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed, rank_device)

    world, rank = maybe_initialize_distributed("cuda")
    device = rank_device("cuda")
    n, _, mode, full = PARALLEL_RUNS[run]
    check(world == n and dist.is_initialized(), f"{run}: world {world}, expected {n}")
    t0 = time.perf_counter()
    frozen, init, batch, config = _parallel_setup(run, device)
    build_s = time.perf_counter() - t0
    n_model = 2 if mode == "tp" else 1
    mesh = sh.Mesh(world // n_model, n_model, device=device)
    passes = [("adamw", PARALLEL_FF_STEPS), ("AdamW8bit", PARALLEL_FF_STEPS)] if full else [
        (config.unet_optimizer_type, PARALLEL_LORA_STEPS)]
    result = {"run": run, "rank": rank, "world": world,
              "mesh": f"mesh data={mesh.n_data} x model={mesh.n_model}, backend {mesh.backend}",
              "build_s": build_s, "passes": {}}
    for optimizer, steps in passes:
        cfg = dataclasses.replace(config, unet_optimizer_type=optimizer)
        trainable = ({"unet": trainable_copy(frozen.unet_params)} if full
                     else copy.deepcopy(init))
        plan, trainable, frozen_p = sh.parallelize(mode, mesh, trainable, frozen)
        par = _parallel_steps(cfg, frozen_p, trainable, batch, steps, plan,
                              save_check=full and optimizer == "adamw")
        del trainable, frozen_p, plan
        gc.collect()
        torch.cuda.empty_cache()
        entry = {k: v for k, v in par.items() if k not in ("final", "grads")}
        dist.barrier()
        if rank == 0:
            # the same steps on one process, twice: the reference, and the
            # spread of two identical runs (torch's nondeterministic backward
            # ops, which Adam's first steps amplify)
            start = ([t.detach() for t in _leaves(frozen.unet_params)
                      if t.is_floating_point()] if full else
                     [t.detach() for t in _leaves(init) if t.is_floating_point()])
            refs = []
            for _ in range(2):
                trainable = ({"unet": trainable_copy(frozen.unet_params)} if full
                             else copy.deepcopy(init))
                refs.append(_parallel_steps(cfg, frozen, trainable, batch, steps,
                                            ref_grads=refs[0]["grads"] if refs else None))
                del trainable
            ref = refs[0]
            check(len(par["final"]) == len(ref["final"]) == len(start),
                  f"{run}: {len(par['final'])} trainables against {len(ref['final'])}")
            entry.update(grad_rel=_rel_l2(par["grads"], ref["grads"]),
                         sign_frac=_sign_frac(par["grads"], ref["grads"]),
                         control_grad_rel=refs[1]["grad_rel"][0],
                         control_sign_frac=refs[1]["grad_rel"][1],
                         update_rel=_rel_l2(par["final"], ref["final"], start),
                         control_rel=_rel_l2(refs[1]["final"], ref["final"], start),
                         ref_s_per_step=ref["s_per_step"], ref_peak_gib=ref["peak_gib"],
                         ref_losses=ref["losses"])
            del ref, refs
        del par
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
        result["passes"][optimizer] = entry
    # a file per rank: the ranks share torchrun's stdout, where lines interleave
    with open(os.path.join(os.environ["CHIP_SMOKE_RANK_DIR"], f"{run}_{rank}.json"), "w") as f:
        json.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_parallel() -> dict:
    """Phase 8: each run of PARALLEL_RUNS through torchrun, every rank's
    numbers, and the gates: the first step's gradients, every step's loss
    and the update against the one-process run, collective bytes > 0 on the
    2-rank runs, both flash kernels launched on every rank."""
    out = {}
    for run, (n, backend, mode, full) in PARALLEL_RUNS.items():
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={n}", os.path.join(ROOT, "chip_smoke.py"), "--parallel-rank",
               run]
        t0 = time.perf_counter()
        # the ranks meet on this host: gloo's sockets on the loopback interface
        rank_dir = tempfile.mkdtemp(prefix=f"{run}_", dir=os.path.join(ROOT, "build"))
        env = {**os.environ, "PYTHONPATH": ROOT, "SDT_DIST_BACKEND": backend,
               "OMP_NUM_THREADS": "4", "GLOO_SOCKET_IFNAME": "lo",
               "CHIP_SMOKE_RANK_DIR": rank_dir}
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=480,
                              env=env)
        wall = time.perf_counter() - t0
        ranks = []
        for name in sorted(os.listdir(rank_dir)):
            with open(os.path.join(rank_dir, name)) as f:
                ranks.append(json.load(f))
        shutil.rmtree(rank_dir, ignore_errors=True)
        if proc.returncode != 0 or len(ranks) != n:
            log(f"[parallel] {run}: torchrun exited {proc.returncode}; stdout tail:")
            log(proc.stdout[-3000:])
            log(f"[parallel] {run}: stderr tail (every rank's):")
            log(proc.stderr[-6000:])
        check(proc.returncode == 0 and len(ranks) == n,
              f"{run}: torchrun exited {proc.returncode} with {len(ranks)} of {n} rank lines")
        ranks.sort(key=lambda r: r["rank"])
        for r in ranks:
            for opt, e in r["passes"].items():
                coll = {k: v for k, v in e["collectives"].items() if k != "total_bytes"}
                ref = (f"; one process {e['ref_s_per_step']:.3f} s/step, peak "
                       f"{e['ref_peak_gib']:.2f} GiB, losses "
                       f"{[round(x, 5) for x in e['ref_losses']]} (gate "
                       f"{PARALLEL_LOSS_TOL:.0e} rel), first-step gradients rel L2 "
                       f"{e['grad_rel']:.2e} (gate {PARALLEL_GRAD_TOL:.0e}; two one-process "
                       f"runs' {e['control_grad_rel']:.2e}), signs differing in "
                       f"{e['sign_frac']:.3e} of them (two one-process runs' "
                       f"{e['control_sign_frac']:.3e}), update rel L2 "
                       f"{e['update_rel']:.2e} (gate {PARALLEL_UPDATE_FACTOR} x two "
                       f"one-process runs' {e['control_rel']:.2e}, at least "
                       f"{PARALLEL_SPREAD_FLOOR})"
                       if "update_rel" in e else "")
                log(f"[parallel] {run} rank {r['rank']}/{r['world']} {opt}: {mode}, "
                    f"{r['mesh']}; steps {[round(x, 3) for x in e['steps_s']]} s "
                    f"({e['s_per_step']:.3f} s/step timed), peak {e['peak_gib']:.2f} "
                    f"GiB, collectives {coll} ({e['collectives']['total_bytes'] / 1e9:.3f} GB), "
                    f"flash launches {e['launches']}, losses "
                    f"{[round(x, 5) for x in e['losses']]}{ref}")
                if "save" in e:
                    sv = e["save"]
                    held = (f"; rank 0 holds {sv['tensors']} tensors, {sv['gb']:.3f} GB, "
                            f"{sv['on_device_gb']:.3f} GB of it on the card"
                            if sv["tensors"] else "")
                    log(f"[parallel] {run} rank {r['rank']} {opt}: trainables and train state "
                        f"gathered in {sv['s']:.1f} s, card memory {sv['over_gib']:.3f} GiB "
                        f"above what it held (gate {PARALLEL_SAVE_GIB}){held}")
                    check(sv["over_gib"] <= PARALLEL_SAVE_GIB,
                          f"{run} rank {r['rank']}: the state's gather took {sv['over_gib']:.3f} "
                          "GiB of the card")
                    check(r["rank"] != 0 or (sv["tensors"] and sv["gb"] > 1),
                          f"{run}: rank 0 gathered {sv}")
                check(all(v > 0 for v in e["launches"].values()),
                      f"{run} rank {r['rank']} {opt}: flash launches {e['launches']}")
                check(n == 1 or e["collectives"]["total_bytes"] > 0,
                      f"{run} rank {r['rank']} {opt}: no collective bytes")
                check(all(math.isfinite(x) for x in e["losses"]), f"{run} {opt}: losses")
                if "update_rel" in e:
                    check(e["grad_rel"] <= PARALLEL_GRAD_TOL,
                          f"{run} {opt}: first-step gradients rel L2 {e['grad_rel']:.2e}")
                    worst = max(abs(a - b) / abs(b) for a, b in zip(e["losses"], e["ref_losses"]))
                    check(worst <= PARALLEL_LOSS_TOL,
                          f"{run} {opt}: losses {e['losses']} against {e['ref_losses']}")
                    spread = max(e["control_rel"], PARALLEL_SPREAD_FLOOR)
                    check(e["update_rel"] <= PARALLEL_UPDATE_FACTOR * spread,
                          f"{run} {opt}: update rel L2 {e['update_rel']:.2e} against two "
                          f"one-process runs' {e['control_rel']:.2e} (floor "
                          f"{PARALLEL_SPREAD_FLOOR})")
        log(f"[parallel] {run}: {n} rank(s) over {backend} in {wall:.1f} s (launch, build and "
            f"steps), build {ranks[0]['build_s']:.1f} s")
        out[run] = {"wall_s": wall, "ranks": ranks,
                    "launches": {k: sum(e["launches"][k] for e in ranks[0]["passes"].values())
                                 for k in ("flash_fwd", "flash_bwd")}}
    return out


def phase_offload(run) -> dict:
    """The LoRA+TI step under `offload:flash_out*,flash_lse*` against
    `save:flash_out*,flash_lse*` on the trained full-width run: the LoRA
    gradients of one loss (gate 1e-3, the reference phase's: torch's atomic
    backward ops),
    the kept tensors pinned host copies, the peak below save:'s; s/step of
    each."""
    from sd_lora_trainer_tpu_torch.ops import checkpoint_names as cn
    from sd_lora_trainer_tpu_torch.training import step as ts

    g = torch.Generator(device="cuda").manual_seed(3)
    shape = tuple(run["batch"]["latent_mean"].shape[1:])
    draws = {"latent_eps": torch.randn(shape, generator=g, device="cuda"),
             "noise": torch.randn(shape, generator=g, device="cuda"),
             "offset_noise": torch.randn(shape[0], 1, 1, shape[-1], generator=g, device="cuda"),
             "timesteps": torch.tensor([17, 300, 640, 901], device="cuda")[:shape[0]]}
    kept = []
    real = cn._Offloaded

    class Counted(real):
        def __init__(self, t):
            super().__init__(t)
            kept.append((self.host.is_pinned(), t.numel() * t.element_size()))

    out = {}
    base = run["sc"]
    cn._Offloaded = Counted
    try:
        for kind in ("save", "offload", "save_again"):
            plan = f"{kind.split('_')[0]}:flash_out*,flash_lse*"
            run["sc"] = dataclasses.replace(base, remat=plan, stash8="")
            kept.clear()
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            _, grads = _lora_b_grads(run, draws, "cuda", sites="")
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**30
            out[kind] = {"peak_gib": peak, "grads": grads, "offloaded": len(kept),
                         "host_gb": sum(b for _, b in kept) / 1e9,
                         "pinned": all(p for p, _ in kept)}
        for kind in ("save", "offload"):  # the steps update the state: after both gradients
            run["sc"] = dataclasses.replace(base, remat=f"{kind}:flash_out*,flash_lse*",
                                            stash8="")
            step = ts.make_train_step(run["sc"])
            secs = []
            for _ in range(GRAPH_WARM + 2):  # save: runs as a graph, offload: eagerly
                torch.cuda.synchronize()
                t = time.perf_counter()
                step(run["state"], run["batch"], run["frozen"])
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t)
            out[kind]["s_per_step"] = sum(secs[GRAPH_WARM:]) / 2
    finally:
        cn._Offloaded = real
        run["sc"] = base
    rel = _rel(out["offload"]["grads"], out["save"]["grads"])
    spread = _rel(out["save_again"]["grads"], out["save"]["grads"])
    o, sv = out["offload"], out["save"]
    log(f"[offload] LoRA+TI loss+backward, SDXL 1024px bs={shape[0]}: save:flash_out*,flash_lse* "
        f"peak {sv['peak_gib']:.2f} GiB, {sv['s_per_step']:.3f} s/step; offload: peak "
        f"{o['peak_gib']:.2f} GiB, {o['s_per_step']:.3f} s/step, {o['offloaded']} tensors "
        f"({o['host_gb']:.3f} GB a pass) in pinned host memory={o['pinned']}; all LoRA-B "
        f"gradients rel L2 {rel:.2e} against save:'s, two save: passes {spread:.2e} (gate "
        f"max(1e-3, 2x that))")
    check(sv["offloaded"] == 0 and o["offloaded"] > 0 and o["pinned"],
          f"offload kept {o['offloaded']} tensors (pinned {o['pinned']}), save {sv['offloaded']}")
    # atomic adds in varying order make two passes of one plan differ by about
    # the reference phase's 1e-3 at full width (8.3e-4 in a shakedown, when
    # flash_bwd's dq still added by atomics; cuDNN's weight gradients and the
    # index backward still do under the default algorithms)
    check(rel <= max(1e-3, 2 * spread), f"offload's gradients differ from save:'s ({rel:.2e}, "
          f"two save: passes {spread:.2e})")
    check(o["peak_gib"] < sv["peak_gib"],
          f"offload's peak {o['peak_gib']:.2f} GiB is not below save:'s {sv['peak_gib']:.2f}")
    return {k: {kk: vv for kk, vv in v.items() if kk != "grads"} for k, v in out.items()}


# phase 9: the measurement and experiment tools, each run as a user runs
# it (a subprocess of `python -m`), at its defaults unless stated
TOOLS_BUCKETS = "1024x1024,832x1216"
# flash launches per step of the bench's default plan (save:flash_out*,
# flash_lse* on a bf16 base): each of the 70 forward kernels once, kept
TOOLS_STEP_LAUNCHES = {"flash_fwd": 70, "flash_bwd": 70}
# flash_fwd launches per render call: 25 Euler steps x 70 blocks at any
# batch (the cli phase renders 2 images a call: 875 per image)
TOOLS_RENDER_FWD = 25 * 70
# the convergence run: the JAX recipe's 128px and batch, cut from 500 steps
# (157 s on the H100, over its share of the run's time) to 150, with a
# checkpoint every 30 so the trends keep the JAX run's 5 points
CONVERGENCE_STEPS, CONVERGENCE_EVERY = 150, 30
FLOP_TOL = 1e-3  # the FLOP count with the flash ops vs with plain attention
PROFILE_TOL = 1e-2  # the profiler's family totals, live vs the exported trace
# the paths of phase 9 in `launches_by_path`; the render bench runs no backward
TOOL_PATHS = {"bench": ("flash_fwd", "flash_bwd"), "bench_buckets": ("flash_fwd", "flash_bwd"),
              "bench_sd15": ("flash_fwd", "flash_bwd"),
              "bench_inference": ("flash_fwd",), "convergence": ("flash_fwd", "flash_bwd")}


def _tool(args, extra_env=None, timeout=600) -> tuple:
    """Run `python -m <args>` from the checkout; (stdout, stderr, seconds).
    A non-zero exit is fatal, with the tails of both streams printed."""
    env = {**os.environ, "PYTHONPATH": ROOT, **(extra_env or {})}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout, env=env)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        log(proc.stdout[-3000:])
        log(proc.stderr[-5000:])
    check(proc.returncode == 0, f"{' '.join(args)} exited {proc.returncode}")
    return proc.stdout, proc.stderr, secs


def _json_line(stdout: str, what: str) -> dict:
    lines = [ln for ln in stdout.splitlines() if ln.strip()]
    check(len(lines) >= 1 and lines[-1].startswith("{"), f"{what}: no JSON line last on stdout")
    return json.loads(lines[-1])


def _bench_line(extra_env, what, step_launches=None):
    step_launches = step_launches or TOOLS_STEP_LAUNCHES
    out, err, secs = _tool(["sd_lora_trainer_tpu_torch.bench"], extra_env)
    lines = [ln for ln in out.splitlines() if ln.strip()]
    check(len(lines) == 1, f"{what}: stdout holds {len(lines)} lines, not one JSON line")
    res = json.loads(lines[0])
    for ln in err.splitlines():
        if ln.startswith("[bench +"):  # its diagnostics, the profile table aside
            log(f"[tools] {what}: {ln}")
    check("step mode graph" in err, f"{what}: the bench's steps did not run as a graph")
    cfg = res["config"]
    check(res["value"] > 0, f"{what}: value {res['value']}")
    check(cfg["flash_launches_per_step"] == step_launches,
          f"{what}: flash launches per step {cfg['flash_launches_per_step']} != {step_launches}")
    log(f"[tools] {what} in {secs:.1f} s: " + json.dumps(res))
    launches = {k: round(v * cfg["timed_steps"]) for k, v in cfg["flash_launches_per_step"].items()}
    return res, launches


def _flop_cross_check() -> dict:
    """count_step_flops at SDXL 1024px bs=1, remat off, through the flash
    ops' formulas and through plain attention's matmuls."""
    import numpy as np

    from sd_lora_trainer_tpu_torch import bench
    from sd_lora_trainer_tpu_torch.ops import flash_attention as fa

    run = bench.setup(bench.Levers.from_env({"BENCH_BS": "1", "BENCH_REMAT": "off",
                                             "BENCH_SCAN": "1"}))
    batch = run.batch(128, 128, np.random.RandomState(0))
    before = fa.launch_counts()
    flash = bench.step_flops(run, batch)
    now = fa.launch_counts()
    launched = {k: now[k] - before[k] for k in now}
    run.sc = dataclasses.replace(run.sc, use_flash=False)
    plain = bench.step_flops(run, batch)
    rel = abs(flash - plain) / plain
    log(f"[tools] FLOP count, SDXL 1024px bs=1, remat off, fwd+bwd: flash ops {flash / 1e12:.4f} "
        f"TF ({launched}), plain attention {plain / 1e12:.4f} TF, rel diff {rel:.2e} (gate "
        f"{FLOP_TOL:.0e})")
    check(all(v == 70 for v in launched.values()), f"the flash count launched {launched}")
    check(rel <= FLOP_TOL, f"FLOP counts differ: flash {flash}, plain {plain}")
    del run, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash": flash, "plain": plain, "rel": rel}


def phase_tools() -> dict:
    """Phase 9: the port's bench (defaults, then buckets), the FLOP
    cross-check, the render bench, the profiler table against its exported
    trace, and the seeded convergence run; returns the flash launches of
    each path."""
    from sd_lora_trainer_tpu_torch.main import SUMMARY_TAG

    by_path = {}
    t_phase = time.perf_counter()
    bench, by_path["bench"] = _bench_line({}, "bench")
    mfu = bench.get("mfu")
    check(mfu is not None and 0 < mfu <= 1, f"bench: mfu {mfu}")
    buckets, by_path["bench_buckets"] = _bench_line(
        {"BENCH_BS": "4", "BENCH_BUCKETS": TOOLS_BUCKETS, "BENCH_STEPS": "4"}, "bench_buckets")
    per_bucket = buckets["config"]["s_per_step_by_bucket"]
    check(buckets["metric"] == "train_throughput_bucketed"
          and set(per_bucket) == set(TOOLS_BUCKETS.split(",")), f"bench_buckets: {per_bucket}")
    # SD1.5 at the bench's defaults for it: 512px, bs=8, "auto" = no remat
    # there, so each of the 15 flash blocks runs its forward once
    sd15, by_path["bench_sd15"] = _bench_line(
        {"BENCH_MODEL": "sd15"}, "bench_sd15",
        {"flash_fwd": SD15_FLASH_BLOCKS, "flash_bwd": SD15_FLASH_BLOCKS})
    cfg15 = sd15["config"]
    check(sd15.get("mfu") is not None and 0 < sd15["mfu"] <= 1, f"bench_sd15: mfu {sd15.get('mfu')}")
    check((cfg15["model"], cfg15["resolution"], cfg15["batch_size"], cfg15["remat"])
          == ("sd15", 512, 8, False), f"bench_sd15: {cfg15}")
    log(f"[tools] bench_sd15: {sd15['value']} imgs/s, MFU {sd15['mfu']:.2%}, busy "
        f"{cfg15.get('busy_share', 0):.1%} of the timed step, peak {cfg15.get('peak_gib', 0):.2f} "
        f"GiB, {cfg15['flops_per_step'] / 1e12:.3f} TF a step")

    flops = _flop_cross_check()
    per_step = bench["config"]["flops_per_step"]
    check(per_step == 8 * flops["flash"],
          f"the bench's flops_per_step {per_step} != 8 x the bs=1 count {flops['flash']}")

    stdout, _, secs = _tool(["sd_lora_trainer_tpu_torch.scripts.bench_inference"])
    inf = _json_line(stdout, "bench_inference")
    per_call = inf["config"]["launches_per_call"]
    log(f"[tools] bench_inference in {secs:.1f} s: " + json.dumps(inf))
    check(inf["value"] > 0 and per_call["flash_fwd"] == TOOLS_RENDER_FWD
          and per_call["flash_bwd"] == 0, f"bench_inference: {inf}")
    calls = inf["config"]["images"] // inf["config"]["batch"]
    by_path["bench_inference"] = {k: round(v * calls) for k, v in per_call.items()}

    prof_dir = os.path.join(ROOT, "build", "tools_profile")
    stdout, err, secs = _tool(["sd_lora_trainer_tpu_torch.scripts.profile_step", "--steps", "2",
                               "--out", prof_dir])
    check("step mode graph" in err, "profile_step: its steps did not run as a graph")
    for ln in stdout.splitlines()[:-1]:
        log(f"[tools] profile_step: {ln}")
    live = _json_line(stdout, "profile_step")
    summary = _json_line(_tool(["sd_lora_trainer_tpu_torch.scripts.profile_step", "--summarize",
                                prof_dir])[0], "profile_step --summarize")
    fam_live, fam_trace = live["family_ms"], summary["family_ms"]
    worst = max(abs(fam_live[k] - fam_trace[k]) / max(fam_live[k], fam_trace[k], 1e-9)
                for k in fam_live)
    log(f"[tools] profile_step in {secs:.1f} s: 2 steps, device ms by family live "
        f"{ {k: round(v, 2) for k, v in fam_live.items()} }, from the trace "
        f"{ {k: round(v, 2) for k, v in fam_trace.items()} } (worst rel diff {worst:.2e}, gate "
        f"{PROFILE_TOL:.0e}); trace {os.path.getsize(summary['trace']) / 1e6:.1f} MB")
    check(live["device_s"] > 0 and worst <= PROFILE_TOL,
          f"profile_step: live {fam_live} against the trace {fam_trace}")
    check(live["launches_per_step"] == live["traced_launches_per_step"] == TOOLS_STEP_LAUNCHES,
          f"profile_step: flash launches per step {live['launches_per_step']}, in the trace "
          f"{live['traced_launches_per_step']}")
    shutil.rmtree(prof_dir, ignore_errors=True)

    conv_dir = os.path.join(ROOT, "build", "convergence_torch")
    stdout, _, secs = _tool(["sd_lora_trainer_tpu_torch.scripts.convergence_run", "--out",
                             conv_dir, "--steps", str(CONVERGENCE_STEPS),
                             "--checkpointing-steps", str(CONVERGENCE_EVERY)], timeout=900)
    summ = json.loads(next(ln for ln in stdout.splitlines()
                           if ln.startswith(SUMMARY_TAG))[len(SUMMARY_TAG):])
    with open(os.path.join(conv_dir, "convergence_report.json")) as f:
        report = json.load(f)
    with open(os.path.join(ROOT, "convergence", "convergence_report.json")) as f:
        jax_report = json.load(f)  # the JAX package's tiny run
    launches = {k: summ["launches"]["train"][k] + sum(r[k] for r in summ["launches"]["render"])
                for k in summ["launches"]["train"]}
    q, h = report.get("quality_proxy", {}), report.get("held_out_trend", {})
    log(f"[tools] convergence_run --tiny in {secs:.1f} s: {report['steps']} steps at "
        f"{report['resolution']}px, {summ['s_per_step']:.4f} s/step, loss drop "
        f"{report.get('loss_drop_pct')}% (the JAX run's {jax_report['loss_drop_pct']}%), x0 "
        "latent MSE "
        f"{q.get('per_checkpoint')}, held-out eps MSE {h.get('per_checkpoint')}, launches "
        f"{launches} (train {summ['launches']['train']})")
    check(set(jax_report) <= set(report),
          f"the report lacks {sorted(set(jax_report) - set(report))}")
    check(q.get("improved") is True and h.get("improved") is True,
          f"convergence trends did not improve: {q}, {h}")
    shutil.rmtree(conv_dir, ignore_errors=True)
    by_path["convergence"] = launches
    log(f"[tools] phase 9 in {time.perf_counter() - t_phase:.1f} s")
    return by_path


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--plan", choices=("auto", "full", "off"), default=None,
                        help="train under this memory plan alone (default: full, then auto)")
    parser.add_argument("--parallel-rank", choices=sorted(PARALLEL_RUNS), default=None,
                        help=argparse.SUPPRESS)  # one rank of phase 8, started by torchrun
    args = parser.parse_args()
    if args.parallel_rank:
        return parallel_rank(args.parallel_rank)
    t_start = time.perf_counter()
    t_lap = [t_start]

    def lap(phase: str) -> None:
        gc.collect()
        torch.cuda.empty_cache()
        now = time.perf_counter()
        log(f"[time] {phase} done at {now - t_start:.1f} s ({now - t_lap[0]:.1f} s)")
        t_lap[0] = now

    smi = phase_device()
    summary = phase_kernels()
    lap("kernels")
    phase_reference()
    run, results = phase_train([args.plan] if args.plan else ["full", "auto"])
    lap("train")
    graph = phase_graph(run)
    lap("graph")
    options = phase_options(run)
    lap("options")
    phase_export(run)
    offload = phase_offload(run)
    del run
    lap("export, offload")
    optim = phase_optim()
    lap("optim")
    cli = phase_cli()
    lap("cli")
    sd15 = phase_sd15()
    lap("sd15")
    tools = phase_tools()
    lap("tools")
    parallel = phase_parallel()
    lap("parallel")
    launches = cli["launches"]
    by_path = {f"train_{p}": r["launches"] for p, r in results.items()}
    by_path.update(graph_eager=graph["eager"]["launches"], graph=graph["graph"]["launches"])
    by_path.update({f"opt_{name}": options[name]["launches"] for name in OPTIONS})
    by_path.update({path: optim[path]["launches"] for path in OPTIM_PATHS})
    by_path.update(cli_train=cli["train_launches"], cli_render=cli["render_launches"])
    by_path.update(sd15_train=sd15["train_launches"], sd15_render=sd15["render_launches"])
    by_path.update(tools)
    by_path.update({run: parallel[run]["launches"] for run in PARALLEL_RUNS})
    entries = []
    for name, s in summary.items():
        bound, by = _bound_ms(s["flops"], s["bytes"])
        check(launches[name] > 0, f"{name} was never launched on the main path")
        check(all(by_path[path][name] > 0 for path in OPTIM_PATHS + OPTION_PATHS
                  + tuple(PARALLEL_RUNS) + ("sd15_train", "graph")),
              f"{name} was not launched on every optim, option, parallel, sd15 and graph path: "
              f"{by_path}")
        check(all(by_path[path][name] > 0 for path, names in TOOL_PATHS.items() if name in names),
              f"{name} was not launched on every tool path: {by_path}")
        entries.append({
            "name": name, "route": "cuda",
            "source": f"sd_lora_trainer_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "launches_by_path": {p: counts[name] for p, counts in by_path.items()},
            "max_abs_err": s["err"], "ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": bound, "bound_by": by,
            "library_ms": s["library_ms"], "library_call": LIBRARY_CALLS[name],
            "timing": TIMING, "run_to_run": "bitwise",
            "cases": s["cases"],
        })
    log(json.dumps({"kernels": entries}))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
