"""Traffic kind "train": one LoRA + TI training job, a closed loop of steps.

The mix's file gives the recipe (the trainer's `train_configs` JSON, as the
CLI reads it, with the offline overrides), the image size and batch, the
cached-latent pool (images, caption lengths, caption dropout, masks) and
the `reference_recipe`: the recipe's settings as the reference reads them
(the defaults the trainer resolves, written out here as data).

Set-up builds the program's train step as `main.py` does (weights from the
seed, adapters, TI rows, the int8 base where the recipe resolves one, fused
projections, the three-group optimizer) and runs its first call: the first
step eagerly, the second captured, then replays. Those first steps go
through the window's own call and feed on rows that all differ; the check
follows the first three of them. The window then runs calls of
`steps_per_call` steps, each batch drawn and assembled on the host (as
`main.py`'s `assemble_batch` and `host_tensors`) while the card runs the
call before; at most one call is queued ahead.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import check, inputs as inp, yardstick
from perfbench.harness import Outcome, log

BOS_OFFSET = 2  # the tokenizer's start id is vocab - 2, its end id vocab - 1


def port_unet_config(unet: dict):
    """The program's UNetConfig from diffusers' config keys."""
    from sd_lora_trainer_tpu_torch.models.unet import UNetConfig

    n = len(unet["block_out_channels"])
    per = (lambda v: tuple(v) if isinstance(v, (list, tuple)) else (v,) * n)
    depth, heads = per(unet.get("transformer_layers_per_block", 1)), per(unet["attention_head_dim"])
    kw = {}
    if unet.get("addition_embed_type") == "text_time":
        t = unet["addition_time_embed_dim"]
        kw = dict(addition_embed_dim=t,
                  addition_pooled_dim=unet["projection_class_embeddings_input_dim"] - 6 * t)
    return UNetConfig(
        in_channels=unet["in_channels"], out_channels=unet["out_channels"],
        block_out_channels=tuple(unet["block_out_channels"]),
        cross_attention=tuple(t.startswith("CrossAttn") for t in unet["down_block_types"]),
        layers_per_block=unet["layers_per_block"],
        transformer_layers=tuple(d if c else 0 for d, c in zip(
            depth, (t.startswith("CrossAttn") for t in unet["down_block_types"]))),
        num_heads=heads, mid_transformer_layers=depth[-1], mid_num_heads=heads[-1],
        cross_attention_dim=unet["cross_attention_dim"],
        use_linear_projection=bool(unet.get("use_linear_projection", False)),
        norm_num_groups=unet["norm_num_groups"], **kw)


def port_clip_config(te: dict):
    from sd_lora_trainer_tpu_torch.models.clip import CLIPTextConfig

    return CLIPTextConfig(
        vocab_size=te["vocab_size"], hidden_size=te["hidden_size"],
        num_layers=te["num_hidden_layers"], num_heads=te["num_attention_heads"],
        intermediate_size=te["intermediate_size"],
        max_position_embeddings=te["max_position_embeddings"], hidden_act=te["hidden_act"],
        eos_token_id=te["eos_token_id"], projection_dim=te.get("projection_dim"))


class Pool:
    """The cached-latent dataset of a job, made on the host from the seed:
    latent means N(0, 1) / latent scale, a fixed log-variance, a mask per
    image (ones, or a face: an ellipse at 1 with a linear falloff over two
    latent pixels to the trainer's background bias of 10/255), and a
    caption per image as token ids with the TI tokens at a random place.
    Draws follow the trainer: an epoch permutation, and caption dropout to
    the TI tokens alone."""

    def __init__(self, mix: dict, config: dict, seed: int):
        rng = np.random.default_rng([int(seed), 0])
        self.draw_rng = np.random.default_rng([int(seed), 1])
        w, h = mix["resolution"]
        f = 8
        lh, lw = h // f, w // f
        n = mix["images"]
        scale = mix["latent_scale"]
        self.scale = np.float32(scale)
        self.mean = (rng.standard_normal((n, lh, lw, 4), dtype=np.float32) / scale)
        self.logvar = np.full((n, lh, lw, 4), mix["latent_logvar"], np.float32)
        self.mask = np.ones((n, lh, lw, 1), np.float32)
        if mix["mask"] == "face":
            yy, xx = np.mgrid[0:lh, 0:lw].astype(np.float32)
            for i in range(n):
                cy, cx = rng.uniform(0.35, 0.65, 2) * (lh, lw)
                ry, rx = rng.uniform(0.22, 0.36, 2) * (lh, lw)
                r = np.sqrt(((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2)
                edge = np.clip(1.0 - (r - 1.0) * min(ry, rx) / 2.0, 0.0, 1.0)
                self.mask[i, :, :, 0] = np.maximum(edge, 10.0 / 255.0)
        vocab = config["text_encoder"]["vocab_size"]
        self.vocab, self.eos, self.bos = vocab, vocab - 1, vocab - BOS_OFFSET
        n_ti = mix["ti_tokens"]
        self.ti_ids = list(range(vocab, vocab + n_ti))
        lo, hi = mix["caption_tokens"]
        self.captions = []
        for _ in range(n):
            content = list(rng.integers(300, vocab - 300, int(rng.integers(lo, hi + 1))))
            at = int(rng.integers(0, len(content) + 1))
            self.captions.append(content[:at] + self.ti_ids + content[at:])
        self.dropout = mix["caption_dropout"]
        self.n = n
        self.order: List[int] = []

    def _ids(self, tokens: List[int], pad: int) -> np.ndarray:
        ids = [self.bos] + tokens + [self.eos]
        return np.asarray(ids + [pad] * (77 - len(ids)), np.int64)

    def draw(self, batch: int) -> Dict[str, np.ndarray]:
        """One [1, B, ...] host batch, as `main.py`'s `assemble_batch`."""
        idx = []
        while len(idx) < batch:
            if not self.order:
                self.order = list(self.draw_rng.permutation(self.n))
            idx.append(self.order.pop(0))
        caps = [self.ti_ids if self.draw_rng.random() < self.dropout else self.captions[i]
                for i in idx]
        out = {
            "latent_mean": self.mean[idx], "latent_logvar": self.logvar[idx],
            "mask": self.mask[idx],
            "input_ids": np.stack([self._ids(c, self.eos) for c in caps]),
            "input_ids_2": np.stack([self._ids(c, 0) for c in caps]),
            "caption_token_lengths": np.asarray([len(c) + 2 for c in caps], np.int64),
            "ti_token_positions": np.asarray(
                [[c.index(t) + 1 if t in c else -1 for t in self.ti_ids] for c in caps], np.int64),
        }
        return {k: v[None] for k, v in out.items()}


def host_tensors(batch: Dict[str, np.ndarray], scale, pin: bool) -> Dict[str, torch.Tensor]:
    """As `main.py`'s `host_tensors`: the latents and masks in the weights'
    dtype, ids int64, the scale 0-d float32, pinned on a card."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if k in ("latent_mean", "latent_logvar", "mask"):
            t = t.to(torch.bfloat16)
        out[k] = t
    out["latent_scale"] = torch.tensor(float(scale), dtype=torch.float32)
    return {k: (t.pin_memory() if pin else t) for k, t in out.items()}


@dataclasses.dataclass
class Job:
    """The program's train step, state and frozen models, as `main.py`
    builds them."""

    tc: object
    sc: object
    state: object
    frozen: object
    step: object
    names: Dict[int, str]  # id(trainable tensor) -> its name
    sites_missing: int


def build_job(config: dict, mix: dict, seed: int, device: torch.device) -> Job:
    from sd_lora_trainer_tpu_torch.config import TrainingConfig
    from sd_lora_trainer_tpu_torch.diffusion.losses import DistributionLossTargets
    from sd_lora_trainer_tpu_torch.diffusion.schedulers import DDPMSchedule
    from sd_lora_trainer_tpu_torch.models.fuse import fuse_attention_projections
    from sd_lora_trainer_tpu_torch.models.lora import UNET_TARGETS, create_lora_params, iter_lora_leaves
    from sd_lora_trainer_tpu_torch.models.quant import quantize_frozen
    from sd_lora_trainer_tpu_torch.training.optimizers import GroupOptimizer
    from sd_lora_trainer_tpu_torch.training.step import (
        FrozenModels, StepConfig, TrainState, make_train_step)

    recipe = dict(mix["recipe"], **mix["overrides"], seed=int(seed), device=device.type,
                  train_img_size=list(mix["resolution"]), _testing_no_output_dir=True)
    tc = TrainingConfig.from_dict(recipe)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = tc.allow_tf32
        torch.backends.cudnn.allow_tf32 = tc.allow_tf32
    log("set-up: the job's configuration resolved")
    data = inp.make_inputs(config, seed, device, rank=tc.lora_rank, n_tokens=tc.n_tokens)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log("set-up: weights made")
    sdxl = data["te2"] is not None
    lora = create_lora_params(data["unet"], tc.lora_rank, torch.Generator(device=device).manual_seed(0),
                              alpha_multiplier=tc.lora_alpha_multiplier, targets=UNET_TARGETS,
                              use_dora=tc.use_dora)
    leaves = dict(iter_lora_leaves(lora))
    missing = len(set(leaves) ^ set(data["lora_a"]))
    with torch.no_grad():
        for name, entry in leaves.items():
            if name in data["lora_a"]:
                entry["a"].copy_(data["lora_a"][name])
    trainable = {"unet": lora, "ti": {k: v.clone().requires_grad_() for k, v in data["ti"].items()}}
    names = {id(e[ab]): f"unet.{n}.{ab}" for n, e in leaves.items() for ab in ("a", "b")}
    names.update({id(v): f"ti.{k}" for k, v in trainable["ti"].items()})
    tables = {k: data[k]["text_model"]["embeddings"]["token_embedding"]["weight"]
              for k in ("te1", "te2") if data[k] is not None}
    frozen = FrozenModels(
        unet_params=data.pop("unet"), te1_params=data.pop("te1"), te2_params=data.pop("te2"),
        schedule=DDPMSchedule.create(device=device),
        distribution_targets={k: DistributionLossTargets.from_embeddings(t) for k, t in tables.items()},
        unet_config=port_unet_config(config["unet"]),
        te1_config=port_clip_config(config["text_encoder"]),
        te2_config=port_clip_config(config["text_encoder_2"]) if sdxl else None,
        version="sdxl" if sdxl else "sd15", resolution=tuple(tc.train_img_size))
    del data, tables
    quantize_base = tc.resolve_quantize_base()
    if quantize_base != "none":
        quantize_frozen(frozen, quantize_base)
    if tc.fuse_qkv and tc.is_lora and not tc.use_dora:
        frozen.unet_params = fuse_attention_projections(frozen.unet_params)
    w, h = tc.train_img_size
    sc = StepConfig.from_config(tc, w / h)
    state = TrainState(step=0, trainable=trainable, optimizer=GroupOptimizer(tc, trainable),
                       generator=torch.Generator(device=device).manual_seed(tc.seed + 1))
    step = make_train_step(sc, capture=device.type == "cuda")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log("set-up: job built (adapters, int8 base, fused projections, optimizer)")
    return Job(tc=tc, sc=sc, state=state, frozen=frozen, step=step, names=names,
               sites_missing=missing)


class Snapshots:
    """The program's trainables before step 1, after it and after step 3,
    its AdamW first moments after steps 1 and 2, and the first three losses,
    by name (device copies). Step 1 runs eagerly and step 2 is the first
    replay of the captured graph, so the moments after step 2 hold a
    gradient that a replay computed, at the trainables after step 1."""

    def __init__(self, job: Job):
        self.job = job
        self.p0 = self._params()
        self.m: List[Dict[str, torch.Tensor]] = []
        self.p1: Optional[Dict[str, torch.Tensor]] = None
        self.p_end: Optional[Dict[str, torch.Tensor]] = None
        self.losses: List[torch.Tensor] = []

    def _params(self):
        return {self.job.names[id(p)]: p.detach().clone() for p in self.job.state.optimizer.params()}

    def _moments(self):
        out = {}
        for opt in self.job.state.optimizer.groups.values():
            for p, m in zip(opt.params, opt.exp_avg):
                out[self.job.names[id(p)]] = m.detach().clone()
        return out

    def after_step(self, n: int, metrics) -> None:
        if n <= 3:
            self.losses.append(metrics["tot_loss"].detach().clone())
        if n <= 2:
            self.m.append(self._moments())
        if n == 1:
            self.p1 = self._params()
        if n == 3:
            self.p_end = self._params()

    def program(self) -> dict:
        """What the check reads of the program (check.readings_of)."""
        return {"losses": [float(x) for x in self.losses[:3]], "p0": self.p0, "p1": self.p1,
                "m1": self.m[0],
                "m2": self.m[1], "p_end": self.p_end, "b1": 0.9}


class Loop:
    """The job's loop: calls of `steps_per_call` steps, each batch drawn
    and assembled on the host (a span each) before the call's steps run."""

    def __init__(self, config: dict, mix: dict, seed: int, device: torch.device):
        self.device, self.cuda = device, device.type == "cuda"
        self.job = build_job(config, mix, seed, device)
        self.pool = Pool(mix, config, seed)
        self.k = max(int(self.job.tc.steps_per_call), 1)
        self.batch = mix["batch"]
        self.spans: Dict[str, List[float]] = {}
        self.losses: List[torch.Tensor] = []
        self.snaps = Snapshots(self.job)
        self.fed: List[Dict[str, torch.Tensor]] = []  # the first three batches, as fed
        self.done = 0

    def call(self) -> None:
        batches = []
        for _ in range(self.k):
            with span(self.spans, "host_batch"):
                batches.append(host_tensors(self.pool.draw(self.batch), self.pool.scale, self.cuda))
        for hb in batches:
            if len(self.fed) < 3:
                self.fed.append(hb)
            metrics = self.job.step(self.job.state, hb, self.job.frozen)
            self.done += 1
            self.losses.append(metrics["tot_loss"])
            self.snaps.after_step(self.done, metrics)

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def first_steps(self) -> None:
        """Set-up's steps: the first eager, the second captured, then
        replays, to the end of the first call."""
        while self.done < 3:
            self.call()
        self.sync()

    def hand_over(self):
        """The check's inputs: the program's snapshots and the first three
        batches as fed (without the accumulation dim); the program's state
        is dropped and the card's cache emptied."""
        prog = self.snaps.program()
        batches = [{k: (v[0] if v.ndim else v) for k, v in b.items()} for b in self.fed[:3]]
        seed_draws, missing = self.job.tc.seed + 1, self.job.sites_missing
        self.job = self.snaps = None
        self.losses, self.fed = [], []
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()
        return prog, batches, seed_draws, missing


@contextlib.contextmanager
def span(spans: Dict[str, List[float]], name: str):
    from torch.profiler import record_function

    t = time.perf_counter()
    with record_function(f"perfbench.{name}"):
        yield
    spans.setdefault(name, []).append(time.perf_counter() - t)


def run(ctx) -> Outcome:
    config, mix, device = ctx.config, ctx.mix, ctx.device
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    loop = Loop(config, mix, ctx.seed, device)
    loop.first_steps()
    setup_s = time.perf_counter() - ctx.t0
    captures = loop.job.step.captures()
    log(f"set-up {setup_s:.2f} s: step mode {loop.job.step.mode}, first eager steps "
        f"{[round(c['warmup_s'], 3) for c in captures]} s, captures "
        f"{[round(c['capture_s'], 3) for c in captures]} s")

    # --- the window: at most one call queued ahead of the host ---
    loop.spans.clear()
    first = loop.done
    prev = None
    t_start = time.perf_counter()
    while True:
        loop.call()
        ev = None
        if loop.cuda:
            ev = torch.cuda.Event()
            ev.record()
        if prev is not None:
            prev.synchronize()
        prev = ev
        if time.perf_counter() - t_start >= ctx.seconds:
            break
    loop.sync()
    window_s = time.perf_counter() - t_start
    steps = loop.done - first
    peak = torch.cuda.max_memory_allocated(device) if loop.cuda else 0
    window_losses = torch.stack(loop.losses[first:]).float().cpu()
    failed = int((~torch.isfinite(window_losses)).sum())
    images = loop.batch * steps
    log(f"window: {steps} steps in {window_s:.3f} s, {images / window_s:.4f} imgs/s, "
        f"peak {peak / 2**30:.3f} GiB, last loss {float(window_losses[-1]):.5f}")
    measured = {"train_imgs_per_s": images / window_s, "peak_gib": peak / 2**30, "setup_s": setup_s}
    layer = {"window_s": window_s, "images": images, "spans": dict(loop.spans),
             "captures": captures, "trace": None, "config": config, "mix": mix,
             "platform": "gpu" if loop.cuda else "cpu"}
    trace = None
    if ctx.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if loop.cuda else [])
        with profile(activities=acts) as prof:
            with record_function("perfbench.window"):
                for _ in range(mix["trace_calls"]):
                    loop.call()
                loop.sync()
        trace = yardstick.trace_from_profiler(prof, "perfbench.window")
        del prof
        w, h = mix["resolution"]
        layer["trace"] = trace
        layer["attention_calls"] = yardstick.self_attention_calls(config["unet"], loop.batch,
                                                                  h // 8, w // 8)

    # --- the check: the program's state freed, then the reference ---
    prog, batches, seed_draws, missing = loop.hand_over()
    t = time.perf_counter()
    readings = check.train_readings(config, mix, ctx.seed, device, batches, seed_draws, prog)
    readings["lora_sites"] = float(missing)
    log(f"reference in {time.perf_counter() - t:.1f} s")
    return Outcome(measured=measured, layer=layer, readings=readings, attempted=steps,
                   failed=failed, peak_bytes=peak, trace=trace)
