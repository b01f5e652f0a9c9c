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
runs one plan alone ("off": a bf16 base, nothing recomputed). Phases, each
fatal on failure (the script exits non-zero and prints no result):
1. device: refuses to run without CUDA; prints the card's name and power
   limit, builds the flash kernels (flash_fwd, the fused flash_bwd) from
   csrc/ with nvcc and prints each kernel's registers and spills;
2. kernels: each kernel against its plain PyTorch version in bf16 at the
   shapes the UNet gives it (SDXL 1024px bs=4, ragged buckets, SD1.5 head
   dims), with its time, the plain version's and PyTorch SDPA's (forward
   beside flash_fwd, backward beside flash_bwd), equal bits from two
   flash_fwd launches, and the run-to-run difference of flash_bwd's dq (its
   atomic adds);
3. reference: the self-attention LoRA-B gradients of a small SDXL-topology
   train loss on the card (flash kernels) against the same computation on the
   CPU (plain attention); on the card, the named plan keeping the flash
   residuals against full remat (and half the forward launches), and an int8
   base against the bf16 one;
4. train: the full-width SDXL UNet (random weights from a seed, bf16), both
   text encoders, rank-16 LoRA on the 577 default sites, 3 TI rows per
   encoder and the three-group AdamW; per plan 1 warm-up and 3 timed steps at
   1024px, DAAM on, then one step under torch.profiler (device time by kernel
   family), with the kernel launches counted per step;
5. export: the trained adapters and TI rows through `save_checkpoint` (the
   kohya LoRA, the embeddings, special_params.json) and back through
   `load_checkpoint`, and the train state through `save_train_state` and
   `restore_train_state`, each equal bit for bit;
6. cli: the product's own path, `python -m sd_lora_trainer_tpu_torch.main
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
   prints each phase's time from the trainer's `[train-summary]` line.
It then prints the `kernels` JSON line (launches from the cli run, by path
in `launches_by_path`), the nvidia-smi line, and as the last line the
result object.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Optional

import torch

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
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
]
# calls per UNet pass at SDXL 1024px: 10 blocks at 4096 tokens, 60 at 1024
MAIN_PATH_CALLS = {"sdxl_4096": 10, "sdxl_1024": 60}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(*args) -> None:
    print(*args, flush=True)


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
    secs = kernels.build_kernels()
    log(f"[device] built {', '.join(kernels.KERNEL_SOURCES)} for sm_90a in {secs:.1f} s")
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
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_kernels():
    import torch.nn.functional as F

    from sd_lora_trainer_tpu_torch.ops import flash_attention as fa

    names = ("flash_fwd", "flash_bwd")
    summary = {n: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
                   "flops": 0.0, "bytes": 0.0} for n in names}
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
            tol, extra = tols[0], ""
            if name == "flash_fwd":
                # no atomics: a second launch on the same inputs gives the same bits
                again = kern()
                same = all(torch.equal(x, y) for x, y in zip(got, again))
                check(same, f"flash_fwd {case}: two launches differ")
                extra = " run_to_run=bitwise"
            if name == "flash_bwd":
                # dq's fp32 atomic adds land in another order each launch; the
                # difference may flip a bf16 rounding, and must stay within one
                # bf16 step of the largest dq (2^-7 of it, 0.39 of the tolerance)
                nondet = float((kern()[0].float() - got[0].float()).abs().max())
                ulp = 2.0**-7 * float(want[0].float().abs().max())
                check(nondet <= ulp, f"flash_bwd {case}: dq differs by {nondet:.3e} between "
                      f"two launches (one bf16 step {ulp:.3e})")
                summary[name]["dq_nondet"] = max(summary[name].get("dq_nondet", 0.0), nondet)
                extra = f" dq_run_to_run={nondet:.2e}"
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
      (gate 1e-3: the same kernels, dq's atomics aside), with half the
      forward launches;
    - on the card, an int8 base vs the bf16 one under the resolved default
      plan (gate 3e-2, the JAX package's int8 bound, tests/test_quant.py).
    The loss is only printed: at the init scale the UNet's prediction is near
    zero, so the loss is about mean(noise^2) and does not see the attention
    outputs (it agrees to the last bit)."""
    from sd_lora_trainer_tpu_torch.models.quant import quantize_frozen
    from sd_lora_trainer_tpu_torch.models.unet import TINY_SDXL_UNET_CONFIG
    from sd_lora_trainer_tpu_torch.ops import flash_attention as fa
    from sd_lora_trainer_tpu_torch.training.step import StepConfig

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # head dim 64, so the flash kernels take every level (1024 and 256 tokens)
    cfg = dataclasses.replace(TINY_SDXL_UNET_CONFIG, block_out_channels=(64, 128, 128),
                              num_heads=(1, 2, 2))
    cpu = _build_run(cfg, "cpu", torch.float32, batch=2, latent_hw=64, rank=4, fuse=True)
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
        launched[name] = dict(fa.LAUNCHES)
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
    _, bf16 = _lora_b_grads(cuda, draws, "cuda", sites="")
    freed = quantize_frozen(cuda["frozen"], "int8")
    _, int8 = _lora_b_grads(cuda, draws, "cuda", sites="")
    q_rel = _rel(int8, bf16)
    log(f"[reference] int8 base vs bf16 base under {plan}: all LoRA-B gradients rel L2 "
        f"{q_rel:.2e} over {bf16.numel()} values (gate 3e-2); {freed * 2**30 / 1e6:.2f} MB freed")
    check(q_rel <= 3e-2, f"the int8 base's gradients differ from the bf16 base's ({q_rel:.2e})")
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


def _build_run(ucfg, device, dtype, batch: Optional[int], latent_hw: int, rank: int, fuse: bool,
               full: bool = False):
    """Frozen models, trainable tree, optimizer and batch of one SDXL run;
    `batch=None` keeps the train config's batch size."""
    from sd_lora_trainer_tpu_torch.config import TrainingConfig
    from sd_lora_trainer_tpu_torch.diffusion.schedulers import DDPMSchedule
    from sd_lora_trainer_tpu_torch.models import clip
    from sd_lora_trainer_tpu_torch.models.fuse import fuse_attention_projections
    from sd_lora_trainer_tpu_torch.models.lora import create_lora_params
    from sd_lora_trainer_tpu_torch.models.unet import init_unet_params
    from sd_lora_trainer_tpu_torch.training import step as ts
    from sd_lora_trainer_tpu_torch.training.embeddings import initialize_new_tokens

    config = TrainingConfig.from_json(TRAIN_CONFIG)
    batch = config.train_batch_size = batch or config.train_batch_size
    gen = torch.Generator(device=device).manual_seed(0)
    c1 = clip.CLIP_L_CONFIG if full else clip.TINY_CLIP_L_CONFIG
    c2 = clip.CLIP_BIG_G_CONFIG if full else clip.TINY_CLIP_G_CONFIG
    unet = init_unet_params(ucfg, gen, dtype=dtype, device=device)
    te1 = clip.init_clip_params(c1, gen, dtype=dtype, device=device)
    te2 = clip.init_clip_params(c2, gen, dtype=dtype, device=device)
    lora = create_lora_params(unet, rank, gen, alpha_multiplier=config.lora_alpha_multiplier)
    if fuse:
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
    trainable = {"unet": lora, "ti": {"te1": rows[0], "te2": rows[1]}}
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
    step_secs, before = [], dict(fa.LAUNCHES)
    for i in range(4):
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = train_step(run["state"], run["batch"], run["frozen"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        counts = {n: fa.LAUNCHES[n] - before[n] for n in fa.LAUNCHES}
        before = dict(fa.LAUNCHES)
        vals = {k: float(v) for k, v in metrics.items()}
        kind = "warm-up" if i == 0 else "timed"
        log(f"[train] {plan} step {i} ({kind}) {secs:.3f} s/step {bs / secs:.3f} imgs/s "
            f"launches {counts} " + json.dumps(vals))
        check(all(math.isfinite(x) for x in vals.values()), f"{plan} step {i}: non-finite metric")
        check(vals["grad_norm"] > 0, f"{plan} step {i}: grad_norm {vals['grad_norm']} is not > 0")
        check(counts == expected, f"{plan} step {i}: launches {counts} != {expected}")
        if i:
            step_secs.append(secs)
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    mean = sum(step_secs) / len(step_secs)
    log(f"[train] SDXL 1024px bs={bs} plan {plan}: {mean:.3f} s/step, {bs / mean:.3f} imgs/s "
        f"(mean of {len(step_secs)} timed steps), peak memory {peak:.2f} GiB")
    prof = _profile_step(train_step, run, expected)
    log(f"[profile] {plan}: device busy share of the mean timed step: {prof['device_s'] / mean:.1%}")
    return {"s_per_step": mean, "imgs_per_s": bs / mean, "timed_steps": step_secs,
            "peak_gib": peak, "gib_freed": freed, "busy_share": prof["device_s"] / mean,
            **prof, "launches": launches}


def _profile_step(train_step, run, expected) -> dict:
    """One more step under torch.profiler: its device kernel seconds, kernel
    count and ms by kernel family (the flash family split by kernel)."""
    from torch.profiler import ProfilerActivity, profile

    from sd_lora_trainer_tpu_torch.ops import flash_attention as fa

    before = dict(fa.LAUNCHES)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        train_step(run["state"], run["batch"], run["frozen"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    counts = {n: fa.LAUNCHES[n] - before[n] for n in fa.LAUNCHES}
    check(counts == expected, f"profiled step: launches {counts} != {expected}")
    # device kernels only: user annotations (e.g. Optimizer.step) span kernels
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False) and "#" not in e.key
              and e.self_device_time_total > 0]
    check(bool(events), "the profiler recorded no device time")
    kernels = [(e.key, e.self_device_time_total) for e in events]
    n_launched = sum(e.count for e in events)
    families = {"flash": 0.0, "conv": 0.0, "gemm": 0.0, "other": 0.0}
    words = {
        "flash": ("flash_fwd_kernel", "flash_bwd_kernel", "flash_bwd_dq_convert_kernel"),
        "conv": ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd", "cudnn"),
        "gemm": ("gemm", "nvjet", "xmma", "cutlass", "matmul"),
    }
    for key, us in kernels:
        low = key.lower()
        family = next((f for f, ws in words.items() if any(w in low for w in ws)), "other")
        families[family] += us
    busy = sum(families.values()) / 1e6
    log(f"[profile] profiled step wall {wall:.3f} s (profiler on), {n_launched} device "
        f"kernels, device kernel time {busy:.3f} s; device ms by family: "
        + ", ".join(f"{k} {v / 1e3:.1f}" for k, v in families.items()))
    flash = {k: us / 1e3 for k, us in kernels if any(w in k.lower() for w in words["flash"])}
    log("[profile] flash family by kernel (ms): "
        + "; ".join(f"{k[:60]} {ms:.1f}" for k, ms in sorted(flash.items())))
    top = sorted(kernels, key=lambda kv: -kv[1])[:8]
    log("[profile] top kernels (ms): " + "; ".join(f"{k[:60]} {us / 1e3:.1f}" for k, us in top))
    return {"device_s": busy, "kernels": n_launched, "family_ms": {k: v / 1e3 for k, v in
                                                                   families.items()},
            "flash_ms": {k[:40]: v for k, v in flash.items()}}


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
        params = [p for g_ in state.optimizer.opt.param_groups for p in g_["params"]]
        params_r = [p for g_ in template.optimizer.opt.param_groups for p in g_["params"]]
        opt, opt_r = state.optimizer.opt.state, template.optimizer.opt.state
        equal = (len(params) == len(params_r)
                 and all(torch.equal(a, b) for a, b in zip(params, params_r))
                 and all(opt[a].keys() == opt_r[b].keys()
                         and all(torch.equal(opt[a][k], opt_r[b][k]) for k in opt[a])
                         for a, b in zip(params, params_r))
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


def phase_cli():
    """The trainer's CLI end to end on a full-width SDXL checkpoint file;
    returns its `[train-summary]` numbers. Everything it writes lives in a
    temp dir under build/, removed after."""
    from sd_lora_trainer_tpu_torch import checkpoint as ck
    from sd_lora_trainer_tpu_torch.main import SUMMARY_TAG
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
        cfg_path = os.path.join(tmp, "cfg.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "sd_lora_trainer_tpu_torch.main", cfg_path],
                              cwd=tmp, capture_output=True, text=True, timeout=700,
                              env={**os.environ, "PYTHONPATH": ROOT})
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            log(proc.stdout[-4000:])
            log(proc.stderr[-4000:])
        check(proc.returncode == 0, f"the CLI trainer exited {proc.returncode}")
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(SUMMARY_TAG)]
        check(len(lines) == 1, "the trainer printed no summary line")
        summ = json.loads(lines[0][len(SUMMARY_TAG):])

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
        log(f"[cli] loop {summ['s_per_step']:.3f} s/step over {summ['steps']} steps "
            f"(bs 4, 1024px; host batch prep {summ['batch_prep_s'] / summ['steps']:.3f} s/step); "
            f"losses {[round(x, 5) for x in losses]}; launches {train_l}")
        log(f"[cli] checkpoint {sum(summ['checkpoint_s']):.2f} s")
        log(f"[cli] render {sum(summ['render_s']) / n_img:.2f} s per image ({n_img} images at "
            f"{CLI_RES}px, 25 steps), flash_fwd launches per image {render_fwd / n_img:.0f}")
        total = {k: train_l[k] + sum(r[k] for r in render_l) for k in train_l}
        return {"summary": summ, "launches": total, "train_launches": train_l,
                "render_launches": {k: sum(r[k] for r in render_l) for k in train_l}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--plan", choices=("auto", "full", "off"), default=None,
                        help="train under this memory plan alone (default: full, then auto)")
    args = parser.parse_args()
    smi = phase_device()
    summary = phase_kernels()
    phase_reference()
    run, results = phase_train([args.plan] if args.plan else ["full", "auto"])
    phase_export(run)
    del run
    torch.cuda.empty_cache()
    cli = phase_cli()
    launches = cli["launches"]
    by_path = {f"train_{p}": r["launches"] for p, r in results.items()}
    by_path.update(cli_train=cli["train_launches"], cli_render=cli["render_launches"])
    entries = []
    for name, s in summary.items():
        bound, by = _bound_ms(s["flops"], s["bytes"])
        check(launches[name] > 0, f"{name} was never launched on the main path")
        entries.append({
            "name": name, "route": "cuda",
            "source": f"sd_lora_trainer_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "launches_by_path": {p: counts[name] for p, counts in by_path.items()},
            "max_abs_err": s["err"], "ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": bound, "bound_by": by,
            "library_ms": s["library_ms"], "library_call": LIBRARY_CALLS[name],
            "timing": TIMING,
            **({"dq_run_to_run_max_abs": s["dq_nondet"]} if "dq_nondet" in s else {}),
        })
    log(json.dumps({"kernels": entries}))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
