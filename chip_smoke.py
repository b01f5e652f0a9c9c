#!/usr/bin/env python3
"""Drive the PyTorch port's SDXL LoRA+TI train step on one CUDA card.

    python3 chip_smoke.py [--remat on|off]

With no arguments it runs the product default (the batch of 4 of
train_configs/training_args_style_sdxl.json, remat on). Phases, each fatal on
failure (the script exits non-zero and prints no result):
1. device: refuses to run without CUDA; prints the card's name and power
   limit and builds the flash kernels (K1-K3) from csrc/ with nvcc;
2. kernels: each kernel against its plain PyTorch version in bf16 at the
   shapes the UNet gives it (SDXL 1024px bs=4, ragged buckets, SD1.5 head
   dims), with its time, the plain version's and PyTorch SDPA's (forward
   beside K1, backward beside K2 and K3);
3. reference: the self-attention LoRA gradients of a small SDXL-topology
   train loss on the card (flash kernels) against the same computation on the
   CPU (plain attention);
4. train: the full-width SDXL UNet (random weights from a seed, bf16), both
   text encoders, rank-16 LoRA on the 577 default sites, 3 TI rows per
   encoder and the three-group AdamW; 1 warm-up and 3 timed steps at 1024px,
   DAAM on, then one step under torch.profiler (device time by kernel
   family), with the kernel launches counted per step.
It then prints the `kernels` JSON line, the nvidia-smi line, and as the last
line the result object.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from typing import Optional

import torch

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
KERNEL_TOL = 2e-2  # max |kernel - plain| <= KERNEL_TOL * max |plain| (bf16 P and dS)
TRAIN_CONFIG = "train_configs/training_args_style_sdxl.json"
REPLACES = {
    "flash_fwd": "sd_lora_trainer_tpu/ops/flash_attention.py:139",
    "flash_bwd_dkv": "sd_lora_trainer_tpu/ops/flash_attention.py:174",
    "flash_bwd_dq": "sd_lora_trainer_tpu/ops/flash_attention.py:180",
}
# the PyTorch call timed as each kernel's library_ms (timed here, never used by the port)
LIBRARY_CALLS = {
    "flash_fwd": "F.scaled_dot_product_attention forward",
    "flash_bwd_dkv": "F.scaled_dot_product_attention backward (dq, dk, dv in one call: K2 + K3)",
    "flash_bwd_dq": "F.scaled_dot_product_attention backward (dq, dk, dv in one call: K2 + K3)",
}
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
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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
        regs = [line.split("info    : ")[-1] for line in report.splitlines() if "Used" in line]
        log(f"[device] ptxas {name}: {'; '.join(sorted(set(regs)))}")
    return smi


def _work(name: str, b: int, h: int, lp: int, valid: int, d: int) -> tuple:
    """(flops, bytes) one kernel call must do: the segment mask leaves
    valid^2 + (lp - valid)^2 (query, key) pairs."""
    pairs = valid**2 + (lp - valid) ** 2 if valid else lp**2
    mult = {"flash_fwd": 4, "flash_bwd_dkv": 8, "flash_bwd_dq": 6}[name]
    tile = b * h * lp * d * 2  # one bf16 [B, H, L, d] tensor
    rows = b * h * lp * 4  # one fp32 [B, H, L] tensor
    nbytes = {"flash_fwd": 4 * tile + rows, "flash_bwd_dkv": 6 * tile + 2 * rows,
              "flash_bwd_dq": 5 * tile + 2 * rows}[name]
    return mult * b * h * pairs * d, nbytes


def _bound_ms(flops: float, nbytes: float) -> tuple:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_kernels():
    import torch.nn.functional as F

    from sd_lora_trainer_tpu_torch.ops import flash_attention as fa

    names = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
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
            "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(q, k, v, do, lse_r, di, sc, valid),
                              lambda: fa.flash_bwd_dkv_ref(q, k, v, do, lse_r, di, sc, valid)),
            "flash_bwd_dq": (lambda: (fa.flash_bwd_dq(q, k, v, do, lse_r, di, sc, valid),),
                             lambda: (fa.flash_bwd_dq_ref(q, k, v, do, lse_r, di, sc, valid),)),
        }
        mask = fa._attend_mask(lp, valid, dev) if valid else None
        qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))

        def sdpa_fwd():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=sc)

        out_s = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, scale=sc)

        def sdpa_bwd():  # dq, dk and dv in one call: the yardstick of K2 + K3
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
            err, tol = errs[0], tols[0]
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
            line.append(f"{name} err={err:.2e} (tol {tol:.2e}) ms={ms:.3f} "
                        f"plain_ms={plain_ms:.3f} bound_ms={bound:.4f} ({by})")
        log(f"[kernels] {case} [{b},{h},{lp},{d}] valid={valid or lp}: " + "; ".join(line)
            + f"; sdpa fwd {lib_fwd:.3f} ms, bwd {lib_bwd:.3f} ms")
        del q, k, v, do, o_r, lse_r, di, qs, ks, vs, out_s
        torch.cuda.empty_cache()
    return summary


def phase_reference():
    """Small SDXL-topology loss and grads: CUDA kernels vs CPU plain attention,
    from the same weights, batch and draws (made on the CPU, then copied).

    The gradient check is the gate. The loss is only printed: at the init
    scale the UNet's prediction is near zero, so the loss is about mean(noise^2)
    and does not see the attention outputs (it agrees to the last bit)."""
    import dataclasses

    from sd_lora_trainer_tpu_torch.models.unet import TINY_SDXL_UNET_CONFIG
    from sd_lora_trainer_tpu_torch.ops import flash_attention as fa

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # head dim 64, so the flash kernels take the 1024-token level
    cfg = dataclasses.replace(TINY_SDXL_UNET_CONFIG, block_out_channels=(64, 128, 128),
                              num_heads=(1, 2, 2))
    cpu = _build_run(cfg, "cpu", torch.float32, batch=2, latent_hw=64, rank=4, fuse=True)
    g = torch.Generator().manual_seed(2)
    shape = tuple(cpu["batch"]["latent_mean"].shape[1:])
    draws = {"latent_eps": torch.randn(shape, generator=g), "noise": torch.randn(shape, generator=g),
             "offset_noise": torch.randn(shape[0], 1, 1, shape[-1], generator=g),
             "timesteps": torch.tensor([17, 640])}
    cuda = _moved(cpu, "cuda")
    from sd_lora_trainer_tpu_torch.models.lora import iter_lora_leaves

    losses, grads = {}, {}
    fa.reset_launch_counts()
    for device, run in (("cpu", cpu), ("cuda", cuda)):
        loss, _ = run["compute_loss"]({k: v.to(device) for k, v in draws.items()})
        loss.backward()
        losses[device] = float(loss.detach())
        # LoRA-B gradients of the self-attention projections: B starts at 0, so
        # no L1 term reaches them and they carry exactly the flash dQ/dK/dV
        grads[device] = torch.cat([
            e["b"].grad.flatten().cpu() for path, e in
            iter_lora_leaves(run["state"].trainable["unet"]) if ".attn1.to_" in path
        ])
    launched = dict(fa.LAUNCHES)
    rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    g_rel = float((grads["cuda"] - grads["cpu"]).norm() / grads["cpu"].norm())
    log(f"[reference] small SDXL loss cuda {losses['cuda']:.6f} cpu {losses['cpu']:.6f} "
        f"(rel {rel:.2e}); self-attention LoRA-B gradients rel L2 error {g_rel:.2e} over "
        f"{grads['cpu'].numel()} values; kernel launches {launched}")
    check(all(n > 0 for n in launched.values()), "the small run did not reach every kernel")
    # the kernels round fp32 operands to bf16 (2^-9 relative) for the tensor cores
    check(g_rel <= 2e-2, f"small-input gradients differ from the CPU reference ({g_rel:.2e})")
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
    import dataclasses

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
    return {
        "config": config, "state": state, "frozen": frozen, "sc": sc, "batch": batch_d,
        "generator": gen, "tensors": group_tensors(trainable),
        "compute_loss": lambda draws: ts.compute_loss(trainable, frozen, sc, mb, 0, gen, **draws),
    }


def phase_train(remat: bool):
    import dataclasses

    from sd_lora_trainer_tpu_torch.models.lora import iter_lora_leaves
    from sd_lora_trainer_tpu_torch.models.unet import SDXL_UNET_CONFIG
    from sd_lora_trainer_tpu_torch.ops import flash_attention as fa
    from sd_lora_trainer_tpu_torch.training import step as ts

    hw = 128  # 1024px
    t0 = time.perf_counter()
    run = _build_run(SDXL_UNET_CONFIG, "cuda", torch.bfloat16, batch=None, latent_hw=hw, rank=16,
                     fuse=True, full=True)
    bs = run["config"].train_batch_size
    run["sc"] = dataclasses.replace(run["sc"], remat=remat)
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
        f"remat={run['sc'].remat}, DAAM on={run['sc'].token_attention_loss_w > 0}")
    check(n_sites == 577, f"expected 577 LoRA sites, got {n_sites}")
    train_step = ts.make_train_step(run["sc"])
    torch.cuda.reset_peak_memory_stats()
    # 70 flash blocks per UNet pass; remat runs each forward once more in backward
    expected = {"flash_fwd": 140 if remat else 70, "flash_bwd_dkv": 70, "flash_bwd_dq": 70}
    fa.reset_launch_counts()  # the main path's run starts here
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
        log(f"[train] step {i} ({kind}) {secs:.3f} s/step {bs / secs:.3f} imgs/s "
            f"launches {counts} " + json.dumps(vals))
        check(all(math.isfinite(x) for x in vals.values()), f"step {i}: non-finite metric")
        check(vals["grad_norm"] > 0, f"step {i}: grad_norm {vals['grad_norm']} is not > 0")
        check(counts == expected, f"step {i}: launches {counts} != {expected}")
        if i:
            step_secs.append(secs)
    peak = torch.cuda.max_memory_allocated() / 2**30
    mean = sum(step_secs) / len(step_secs)
    log(f"[train] SDXL 1024px bs={bs} remat {'on' if remat else 'off'}: {mean:.3f} s/step, {bs / mean:.3f} imgs/s "
        f"(mean of {len(step_secs)} timed steps), peak memory {peak:.2f} GiB")
    busy = _profile_step(train_step, run, expected)
    log(f"[profile] device busy share of the mean timed step: {busy / mean:.1%}")
    launches = dict(fa.LAUNCHES)
    return launches


def _profile_step(train_step, run, expected):
    """One more step under torch.profiler; returns its device kernel seconds
    and logs them by kernel family."""
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
        "flash": ("flash_fwd_kernel", "flash_bwd_"),
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
    top = sorted(kernels, key=lambda kv: -kv[1])[:8]
    log("[profile] top kernels (ms): " + "; ".join(f"{k[:60]} {us / 1e3:.1f}" for k, us in top))
    return busy


def _leaves(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--remat", choices=("on", "off"), default="on",
                        help="block remat of the train step (default on, the product's 'auto')")
    args = parser.parse_args()
    smi = phase_device()
    summary = phase_kernels()
    phase_reference()
    launches = phase_train(args.remat == "on")
    entries = []
    for name, s in summary.items():
        bound, by = _bound_ms(s["flops"], s["bytes"])
        check(launches[name] > 0, f"{name} was never launched on the main path")
        entries.append({
            "name": name, "route": "cuda",
            "source": f"sd_lora_trainer_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": s["err"], "ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": bound, "bound_by": by,
            "library_ms": s["library_ms"], "library_call": LIBRARY_CALLS[name],
        })
    log(json.dumps({"kernels": entries}))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
