"""The training step (counterpart of sd_lora_trainer_tpu/training/step.py).

One step: CLIP-L + OpenCLIP-bigG conditioning with trainable TI rows, DDPM
add_noise, the UNet forward and backward through LoRA (flash self-attention
on the card, DAAM scores from cross-attention), the Min-SNR masked MSE, the
token-attention loss, the L1 penalty and the TI regularizers, then one optimizer
update per group.

- trainable tree: {"unet": lora tree, "ti": {"te1": rows, "te2": rows},
  "te_lora": {"te1": tree, "te2": tree}} (groups optional); its tensors are
  leaves that require grad and the optimizer updates them in place;
- random draws: `jax.random` streams cannot be replayed in torch, so
  `compute_loss` takes latent_eps, noise, offset_noise and timesteps as
  optional explicit tensors and draws the missing ones from a
  `torch.Generator`;
- gradient accumulation: batch tensors carry a leading [accum] dim; the
  gradients and aux terms are averaged over the micro-batches;
- parallel training (`StepConfig.parallel`, parallel/sharding.py): the step
  takes the global batch and keeps this rank's rows; every rank draws the
  global batch's noise from the same generator and keeps its rows, so the
  streams are those of one process; the losses' batch-level statistics are
  the data group's; the gradients are synced before the update;
- one program (`make_train_step`): on the card the whole step, every
  micro-batch's forward and backward, the metrics and the three-group
  update, is one CUDA graph, captured once per step shape and replayed for
  every step, the counterpart of JAX's jitted step. Nothing the step reads
  changes as a Python value from step to step: the step count, the update
  counts, the LRs and the TI freeze are device tensors.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from sd_lora_trainer_tpu_torch.config import TrainingConfig
from sd_lora_trainer_tpu_torch.diffusion.losses import (
    TARGET_PROMPT_NORM,
    DistributionLossTargets,
    diffusion_loss,
    lora_l1_penalty,
    prompt_norm_regularization,
    token_attention_loss,
)
from sd_lora_trainer_tpu_torch.diffusion.schedulers import DDPMSchedule
from sd_lora_trainer_tpu_torch.models.clip import CLIPTextConfig
from sd_lora_trainer_tpu_torch.models.conditioning import sd15_conditioning, sdxl_conditioning
from sd_lora_trainer_tpu_torch.models.lora import inject_lora, iter_lora_leaves
from sd_lora_trainer_tpu_torch.models.unet import UNetConfig, unet_forward
from sd_lora_trainer_tpu_torch.ops import flash_attention as fa
from sd_lora_trainer_tpu_torch.ops import norms
from sd_lora_trainer_tpu_torch.parallel.distributed import local_rows
from sd_lora_trainer_tpu_torch.training.optimizers import GroupOptimizer, group_tensors
from sd_lora_trainer_tpu_torch.utils import profiling


@dataclasses.dataclass
class FrozenModels:
    """The non-trainable models and tables of a run."""

    unet_params: Any
    te1_params: Any
    te2_params: Any  # None for sd15
    schedule: DDPMSchedule
    distribution_targets: Dict[str, DistributionLossTargets]  # "te1"/"te2"
    unet_config: UNetConfig
    te1_config: CLIPTextConfig
    te2_config: Optional[CLIPTextConfig]
    version: str  # "sd15" | "sdxl"
    resolution: Tuple[int, int]  # (W, H)


@dataclasses.dataclass
class TrainState:
    """Trainable tensors (updated in place), their optimizer, the step count
    and the generator of the step's random draws."""

    step: int
    trainable: dict
    optimizer: GroupOptimizer
    generator: torch.Generator


@dataclasses.dataclass(frozen=True)
class StepConfig:
    snr_gamma: float
    noise_offset: float
    l1_penalty: float
    token_attention_loss_w: float
    cond_reg_w: float
    tok_cov_reg_w: float
    std_loss_w: float  # the reference hardcodes 0.01
    grad_accum: int
    is_lora: bool
    train_ti: bool
    use_flash: bool
    remat: Union[bool, str]  # False | True | a plan of models/unet.py
    max_train_steps: int
    ti_freeze_f: float
    ti_lr: float
    daam_img_ratio: float
    # names whose remat stash is row-wise int8 (ops/stash8.py); "" = none
    stash8: str = ""
    # recompute the text-encoder conditioning in the backward, nothing kept:
    # set by quantize_base "int8+te", whose dequantized TE weights would
    # otherwise stay alive from forward to backward
    remat_te: bool = False
    # the mesh a multi-process step runs under (parallel/sharding.py
    # ParallelPlan); None on one process
    parallel: Any = None

    @classmethod
    def from_config(cls, config: TrainingConfig, img_ratio: float) -> "StepConfig":
        remat = config.remat
        quantize_base = config.resolve_quantize_base()
        if remat == "auto":
            # the JAX package's plans, resolved here so every consumer gets a
            # concrete one: SD1.5 at <= 512px keeps all activations; an int8
            # base pays for "light" (plain resnet layers keep theirs) with the
            # flash residuals kept; a bf16 base recomputes every layer but the
            # flash residuals. They rest on TPU measurements; an H100 choice
            # waits for the port's benchmark.
            sizes = config.train_img_size
            if not sizes:
                r = config.resolution
                sizes = r if isinstance(r, (list, tuple)) else (r, r)
            if (config.sd_model_version == "sd15" and max(sizes) <= 512
                    and config.train_batch_size <= 16):
                remat = False
            elif quantize_base in ("int8", "int8+te"):
                remat = "light+save:flash_out*,flash_lse*"
            else:
                remat = "save:flash_out*,flash_lse*"
        return cls(
            snr_gamma=config.snr_gamma,
            noise_offset=config.noise_offset,
            l1_penalty=config.l1_penalty,
            token_attention_loss_w=config.token_attention_loss_w,
            cond_reg_w=config.cond_reg_w,
            tok_cov_reg_w=config.tok_cov_reg_w,
            std_loss_w=0.01,
            grad_accum=config.gradient_accumulation_steps,
            is_lora=config.is_lora,
            train_ti=not config.disable_ti,
            use_flash=True,
            remat=remat,
            stash8=config.remat_stash8,
            remat_te=quantize_base == "int8+te",
            max_train_steps=config.max_train_steps,
            ti_freeze_f=config.freeze_ti_after_completion_f,
            ti_lr=config.ti_lr,
            daam_img_ratio=img_ratio,
        )


def _unet_params_with_adapters(frozen: FrozenModels, trainable, sc: StepConfig):
    if not sc.is_lora:
        return trainable["unet"]
    if "unet" in trainable:
        return inject_lora(frozen.unet_params, trainable["unet"])
    return frozen.unet_params


def _te_params_with_adapters(frozen: FrozenModels, trainable, which: str):
    base = frozen.te1_params if which == "te1" else frozen.te2_params
    te_lora = trainable.get("te_lora", {})
    if base is not None and which in te_lora:
        return inject_lora(base, te_lora[which])
    return base


def compute_loss(
    trainable,
    frozen: FrozenModels,
    sc: StepConfig,
    batch: Dict[str, torch.Tensor],
    step: Union[int, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    latent_eps: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    offset_noise: Optional[torch.Tensor] = None,
    timesteps: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One micro-batch loss with every reference term. `step` is the number
    of steps done, a Python int or a 0-d device tensor (what a captured step
    reads).

    Under `sc.parallel` the batch is this rank's rows; draws are made (or
    given) in the global batch's shape and this rank's rows kept."""
    mean, logvar = batch["latent_mean"], batch["latent_logvar"]
    device = mean.device
    par = sc.parallel
    n_data = par.n_data if par is not None else 1
    group = par.batch if par is not None else None

    def rows(t):
        """This rank's rows of a global-batch tensor (a local one passes)."""
        if n_data > 1 and t.shape[0] == mean.shape[0] * n_data:
            return par.local_rows(t)
        return t

    def draw(shape, dtype):
        shape = (shape[0] * n_data,) + tuple(shape[1:])
        return rows(torch.randn(shape, generator=generator, dtype=dtype, device=device))

    ti = trainable.get("ti", {})

    def conditioning():
        if frozen.version == "sdxl":
            return sdxl_conditioning(
                _te_params_with_adapters(frozen, trainable, "te1"),
                _te_params_with_adapters(frozen, trainable, "te2"),
                batch["input_ids"], batch["input_ids_2"],
                frozen.te1_config, frozen.te2_config, frozen.resolution,
                ti_rows_1=ti.get("te1"), ti_rows_2=ti.get("te2"), dtype=latent.dtype,
            )
        pe, _, _ = sd15_conditioning(
            _te_params_with_adapters(frozen, trainable, "te1"), batch["input_ids"],
            frozen.te1_config, ti_rows=ti.get("te1"), dtype=latent.dtype,
        )
        return pe, None, None

    with profiling.phase("conditioning"):
        if latent_eps is None:
            latent_eps = draw(mean.shape, torch.float32)
        latent_eps = rows(latent_eps)
        std = torch.exp(0.5 * logvar.float())
        latent = ((mean.float() + std * latent_eps.float())
                  * batch["latent_scale"]).to(mean.dtype)

        if sc.remat_te:
            # int8 text encoders: recomputing the conditioning keeps only the
            # codes and its [B, 77, *] outputs alive, not the dequantized weights
            prompt_embeds, pooled, add_time_ids = checkpoint(conditioning, use_reentrant=False,
                                                             preserve_rng_state=False)
        else:
            prompt_embeds, pooled, add_time_ids = conditioning()
        added_cond = ({"text_embeds": pooled, "time_ids": add_time_ids}
                      if frozen.version == "sdxl" else None)

    with profiling.phase("unet_forward"):
        if noise is None:
            noise = draw(latent.shape, latent.dtype)
        noise = rows(noise).to(latent.dtype)
        if sc.noise_offset > 0.0:
            b, _, _, c = latent.shape
            if offset_noise is None:
                offset_noise = draw((b, 1, 1, c), latent.dtype)
            noise = noise + sc.noise_offset * rows(offset_noise).to(latent.dtype)
        if timesteps is None:
            timesteps = rows(torch.randint(0, frozen.schedule.num_train_timesteps,
                                           (latent.shape[0] * n_data,), generator=generator,
                                           device=device))
        timesteps = rows(timesteps)
        noisy_latent = frozen.schedule.add_noise(latent, noise, timesteps)

        capture = sc.train_ti and sc.token_attention_loss_w > 0.0
        model_pred, attn_scores = unet_forward(
            _unet_params_with_adapters(frozen, trainable, sc), noisy_latent, timesteps,
            prompt_embeds, frozen.unet_config, added_cond=added_cond, capture_attn=capture,
            use_flash=sc.use_flash, remat=sc.remat, stash8=sc.stash8,
            gather=par.gather if par is not None and par.fsdp is not None else None,
        )

    with profiling.phase("loss"):
        mask = batch["mask"]
        img_loss = diffusion_loss(model_pred, noise, noisy_latent, latent, mask, frozen.schedule,
                                  timesteps, sc.snr_gamma, group=group)
        loss = img_loss
        aux: Dict[str, torch.Tensor] = {"img_loss": img_loss}

        if capture:
            attn_loss = token_attention_loss(
                attn_scores, mask, sc.daam_img_ratio, batch["caption_token_lengths"],
                batch["ti_token_positions"], group=group,
            )
            loss = loss + sc.token_attention_loss_w * attn_loss
            aux["token_attention_loss"] = attn_loss

        if sc.l1_penalty > 0.0 and sc.is_lora and "unet" in trainable:
            mats = [m for _, e in iter_lora_leaves(trainable["unet"]) for m in (e["a"], e["b"])]
            l1 = lora_l1_penalty(mats)
            loss = loss + sc.l1_penalty * l1
            aux["l1_norm"] = l1

        if sc.train_ti:
            active = ti_active(sc, step)
            if sc.cond_reg_w > 0.0:
                reg, observed = prompt_norm_regularization(
                    prompt_embeds, TARGET_PROMPT_NORM[frozen.version], group=group
                )
                loss = loss + active * sc.cond_reg_w * reg
                aux["prompt_norm"] = observed
            cov_losses, std_losses = [], []
            for which, rows in ti.items():
                if rows is None:
                    continue
                targets = frozen.distribution_targets[which]
                if sc.tok_cov_reg_w > 0.0:
                    cov_losses.append(targets.covariance_loss(rows))
                if sc.std_loss_w > 0.0:
                    std_losses.append(targets.std_loss(rows))
            if cov_losses:
                cov = torch.stack(cov_losses).mean()
                loss = loss + active * sc.tok_cov_reg_w * cov
                aux["covariance_tok_reg_loss"] = cov
            if std_losses:
                stdl = torch.stack(std_losses).mean()
                loss = loss + active * sc.std_loss_w * stdl
                aux["token_std_loss"] = stdl

    aux["tot_loss"] = loss
    return loss, aux


def ti_active(sc: StepConfig, step: Union[int, torch.Tensor]) -> Union[float, torch.Tensor]:
    """1 while the TI regularizers apply, 0 once step / max_train_steps
    passes the TI freeze: a float for a Python step, a float32 0-d tensor
    (computed in float64, as the float) for a device step."""
    if isinstance(step, torch.Tensor):
        return (step.double() / sc.max_train_steps <= sc.ti_freeze_f).float()
    return 0.0 if step / sc.max_train_steps > sc.ti_freeze_f else 1.0


def make_train_step(sc: StepConfig, capture: bool = True, backend=None,
                    phases: bool = False) -> "TrainStep":
    """Build `train_step(state, batch, frozen, draws=None) -> metrics`.

    `batch` tensors carry a leading [accum] dim (0-dim tensors ride through)
    and lie on the device or in host memory (pinned, for an asynchronous
    copy); `draws` optionally holds one dict of explicit compute_loss draws
    per micro-batch (an eager step's). The step averages loss and gradients
    over the micro-batches, applies one optimizer update in place and
    advances `state.step`. Under `sc.parallel` the batch and draws are the
    global batch's.

    The step runs as a captured graph where it can (one process on the
    card, every plan but "offload:") and eagerly elsewhere, saying why on
    stderr; `capture=False` runs it eagerly (to compare the two: no config
    field, JAX has no such knob). `backend` stands in for CUDA graphs
    (`CudaGraphs`), as the tests do on the CPU.

    `phases=True` arms the step's phase marks on the card: each phase of
    the body (utils/profiling.py `STEP_PHASES`) records a timing event at
    its entry and exit, and a captured graph holds them, so that
    `TrainStep.phase_ms()` reads the last step's device ms by phase. A step
    built without them captures the graph it always did.
    """
    return TrainStep(sc, capture, backend or CudaGraphs(), phases)


def _step_body(sc: StepConfig, state: TrainState, batch: Dict[str, torch.Tensor],
               frozen: FrozenModels, step: torch.Tensor,
               draws: Optional[List[dict]] = None) -> Dict[str, torch.Tensor]:
    """The step as a graph holds it: the gradients, the metrics and the
    update, reading the step count from `step`; it moves no host count."""
    metrics = _backward(sc, state, batch, frozen, draws, step)
    with profiling.phase("update"):
        metrics = _grad_norm(sc, state, metrics)
        state.optimizer.update()
    return metrics


def _count_step(state: TrainState) -> None:
    """The host's side of a step: its count and the optimizers' counts."""
    state.step += 1
    state.optimizer.advance()


class CudaGraphs:
    """Captures a step into a `torch.cuda.CUDAGraph`.

    The graphs of one device share a memory pool and a capture stream, so
    one graph per aspect-ratio bucket costs the device the largest step's
    memory, not the sum. That is safe in any replay order because each
    graph is a whole step: its outputs are cloned right after its replay,
    the gradients it leaves are dropped after its capture, and every state
    it carries from one step to the next (trainables, optimizer state,
    counts, static inputs) was allocated outside any capture, so no other
    graph's memory can overlap it."""

    _pools: Dict[torch.device, tuple] = {}

    def supports(self, device: torch.device) -> bool:
        return device.type == "cuda"

    def _pool(self, device: torch.device):
        device = torch.device("cuda", device.index if device.index is not None
                              else torch.cuda.current_device())
        if device not in self._pools:
            self._pools[device] = (torch.cuda.graph_pool_handle(), torch.cuda.Stream(device))
        return self._pools[device]

    @contextlib.contextmanager
    def warmup(self, device: torch.device):
        """Run a key's first, eager step on the capture stream, to its end."""
        _, stream = self._pool(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            yield
        stream.synchronize()
        torch.cuda.current_stream(device).wait_stream(stream)

    def capture(self, body: Callable[[], dict], generator: torch.Generator,
                device: torch.device):
        """Record the step without running it; returns `replay`, which runs
        it and returns the same output tensors each time."""
        pool, stream = self._pool(device)
        graph = torch.cuda.CUDAGraph()
        # the step's draws: each replay takes the generator's next offsets,
        # as an eager step would
        graph.register_generator_state(generator)
        with torch.cuda.device(device), torch.cuda.graph(graph, pool=pool, stream=stream):
            outputs = body()

        def replay():
            graph.replay()
            return outputs

        return replay

    def reserved_gib(self, device: torch.device) -> float:
        """The device memory the allocator holds, its unused cache first
        released (as a capture does on entry): around a capture, its pool."""
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved(device) / 2**30


@dataclasses.dataclass
class _Graph:
    """One key's capture: the state and frozen models it reads and updates,
    its static inputs and step count, and what one replay launches."""

    state: TrainState
    frozen: FrozenModels
    inputs: Optional[Dict[str, torch.Tensor]] = None
    step: Optional[torch.Tensor] = None
    replay: Optional[Callable[[], dict]] = None
    launches: Optional[Dict[str, int]] = None
    marks: Optional[profiling.PhaseMarks] = None  # the replays' phase marks, when armed
    warmup_s: float = 0.0
    warmup_phases_s: Optional[Dict[str, float]] = None
    capture_s: float = 0.0
    pool_gib: float = 0.0


class TrainStep:
    """The train step of `make_train_step`.

    `mode` ("graph" or "eager") is set at the first call, with
    `eager_reason`. In graph mode `graphs` holds one capture per key: the
    state and frozen models, and the batch's shapes and dtypes (one graph
    per bucket; the DAAM ratio and the accumulation count are fixed per step
    function, as they are per jitted function in JAX). A key's first step
    runs eagerly, a real step, on the capture stream: the kernels' builds,
    cuBLAS's workspaces and the cached constants are made outside the
    capture. Its second step is captured, then replayed, and so is every
    later one: the batch is copied into the static inputs, the host fills
    the step count and the optimizers' counts, the graph runs, its metrics
    are cloned on the device, and the host counts the step (each replay
    counts its flash launches on the device, ops/flash_attention.py). A
    failed capture or replay raises: there is no fallback to eager.

    Every call opens host spans (utils/profiling.py): `sdlt.step.warmup`
    and `sdlt.step.capture` at a key's first two steps, `sdlt.step.fill`,
    `replay` and `clone` at each replay, and the body's phases wherever
    its Python runs (eager steps and captures). With `phases` the body's
    phases also mark the device on the card (`phase_ms()`)."""

    def __init__(self, sc: StepConfig, capture: bool, backend, phases: bool = False):
        self.sc, self.capture, self.backend, self.phases = sc, capture, backend, phases
        self.mode: Optional[str] = None
        self.eager_reason: Optional[str] = None
        self.graphs: Dict[tuple, _Graph] = {}
        self._step_t: Optional[torch.Tensor] = None
        self._last_marks: Optional[profiling.PhaseMarks] = None

    def _choose_mode(self, device: torch.device) -> None:
        reason = None
        if not self.capture:
            reason = "asked by the caller"
        elif not self.backend.supports(device):
            reason = f"the step runs on {device.type} (CUDA graphs need a card)"
        elif self.sc.parallel is not None:
            reason = "a multi-process step (its collectives are not captured)"
        elif isinstance(self.sc.remat, str) and "offload:" in self.sc.remat:
            reason = "the offload: plan (its host copies run on a side stream)"
        self.mode, self.eager_reason = ("eager", reason) if reason else ("graph", None)
        if reason is not None and self.capture:
            print(f"[step] eager: {reason}", file=sys.stderr, flush=True)

    def __call__(self, state: TrainState, batch: Dict[str, torch.Tensor], frozen: FrozenModels,
                 draws: Optional[List[dict]] = None) -> Dict[str, torch.Tensor]:
        device = state.optimizer.params()[0].device
        if self.mode is None:
            self._choose_mode(device)
        if self.mode == "eager":
            return self._eager(state, batch, frozen, draws, device)
        if draws is not None:
            raise ValueError("explicit draws need the eager step: make_train_step(sc, capture=False)")
        key = (id(state), id(frozen)) + tuple(
            (k, tuple(v.shape), v.dtype) for k, v in sorted(batch.items()))
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = _Graph(state, frozen)
            t0 = time.perf_counter()
            with profiling.span("step.warmup"), self.backend.warmup(device):
                metrics = self._eager(state, batch, frozen, None, device)
            graph.warmup_s = time.perf_counter() - t0
            graph.warmup_phases_s = dict(self._last_marks.host_s)
            return metrics
        if graph.replay is None:
            with profiling.span("step.capture"):
                self._capture(graph, batch, device)
        with profiling.span("step.fill"):
            self._fill(graph, batch)
        with profiling.span("step.replay"):
            outputs = graph.replay()
        self._last_marks = graph.marks
        _count_step(state)
        with profiling.span("step.clone"):
            return {k: v.clone() for k, v in outputs.items()}

    def _new_marks(self, device: torch.device) -> profiling.PhaseMarks:
        """The phases' host seconds, and on the card their device events
        where the step is armed."""
        return profiling.PhaseMarks(device=self.phases and device.type == "cuda")

    def _eager(self, state, batch, frozen, draws, device) -> Dict[str, torch.Tensor]:
        batch = {k: v.to(device, non_blocking=True) for k, v in batch.items()}
        if self._step_t is None or self._step_t.device != device:
            self._step_t = torch.zeros((), dtype=torch.int64, device=device)
        self._step_t.fill_(state.step)
        state.optimizer.sync()
        self._last_marks = self._new_marks(device)
        with profiling.marking(self._last_marks):
            metrics = _step_body(self.sc, state, batch, frozen, self._step_t, draws)
        _count_step(state)
        return metrics

    def _fill(self, graph: _Graph, batch: Dict[str, torch.Tensor]) -> None:
        """The host's writes before a replay: the batch, the step count and
        the optimizers' counts (copies and fills queued on the stream)."""
        for k, v in batch.items():
            graph.inputs[k].copy_(v, non_blocking=True)
        graph.step.fill_(graph.state.step)
        graph.state.optimizer.sync()

    def _capture(self, graph: _Graph, batch: Dict[str, torch.Tensor], device) -> None:
        state = graph.state
        graph.inputs = {k: torch.empty(v.shape, dtype=v.dtype, device=device)
                        for k, v in batch.items()}
        graph.step = torch.zeros((), dtype=torch.int64, device=device)
        self._fill(graph, batch)
        state.optimizer.zero_grad()  # the graph allocates the gradients
        reserved = self.backend.reserved_gib(device)
        fa.prepare_graph_counts(device)
        norms.prepare_graph_counts(device)
        before = dict(fa.RECORDED)
        graph.marks = self._new_marks(device)

        def body():
            with profiling.marking(graph.marks):
                return _step_body(self.sc, state, graph.inputs, graph.frozen, graph.step)

        t0 = time.perf_counter()
        graph.replay = self.backend.capture(body, state.generator, device)
        graph.capture_s = time.perf_counter() - t0
        graph.pool_gib = self.backend.reserved_gib(device) - reserved
        graph.launches = {k: fa.RECORDED[k] - before[k] for k in fa.RECORDED}
        state.optimizer.zero_grad()  # the graph's pool holds them; nothing reads them
        shapes = ", ".join(f"{k} {list(v.shape)}" for k, v in batch.items()
                           if k in ("latent_mean", "input_ids"))
        print(f"[step] graph: captured the step of {shapes} in {graph.capture_s:.2f} s "
              f"(+{graph.pool_gib:.2f} GiB reserved, flash launches a replay {graph.launches})",
              file=sys.stderr, flush=True)

    def captures(self) -> List[dict]:
        """Each captured key's seconds of its eager first step, and of each
        step phase in it (host seconds: the lazy work of a first step shows
        in the phase that runs into it), and of its capture, the pool's
        growth and the launches of a replay."""
        return [{"warmup_s": g.warmup_s, "warmup_phases_s": g.warmup_phases_s,
                 "capture_s": g.capture_s, "pool_gib": g.pool_gib, "launches": g.launches}
                for g in self.graphs.values() if g.replay is not None]

    def phase_ms(self) -> Optional[Dict[str, float]]:
        """The last step's device ms by phase (utils/profiling.py
        `STEP_PHASES`, summed over the micro-batches, and `update.<group>`
        for each optimizer group), its body's in all ("total"), and the
        part of it outside the phases ("other"); waits for that step. None
        when the step is not armed (`make_train_step(..., phases=True)`)
        or runs on the CPU."""
        return None if self._last_marks is None else self._last_marks.ms()


def accumulate_grads(sc: StepConfig, state: TrainState, batch: Dict[str, torch.Tensor],
                     frozen: FrozenModels, draws: Optional[List[dict]] = None,
                     step: Union[int, torch.Tensor, None] = None) -> Dict[str, torch.Tensor]:
    """The step up to the update: the trainables' .grad from every
    micro-batch (synced across the mesh), and the step's metrics. `step`
    (default `state.step`) is what compute_loss reads."""
    return _grad_norm(sc, state, _backward(sc, state, batch, frozen, draws, step))


def _backward(sc: StepConfig, state: TrainState, batch: Dict[str, torch.Tensor],
              frozen: FrozenModels, draws: Optional[List[dict]],
              step: Union[int, torch.Tensor, None]) -> Dict[str, torch.Tensor]:
    """Every micro-batch's loss and backward: the .grad and the metrics."""
    par = sc.parallel
    if par is not None:  # this rank's rows of the [accum, B, ...] global batch
        batch = local_rows(batch, par.n_data, par.mesh.data_rank)
    state.optimizer.zero_grad()
    aux_sum: Dict[str, torch.Tensor] = {}
    for i in range(sc.grad_accum):
        mb = {k: (v[i] if v.ndim > 0 else v) for k, v in batch.items()}
        loss, aux = compute_loss(
            state.trainable, frozen, sc, mb, state.step if step is None else step,
            state.generator,
            **(draws[i] if draws else {}),
        )
        with profiling.phase("backward"):
            (loss / sc.grad_accum).backward()
        for k, v in aux.items():
            aux_sum[k] = aux_sum.get(k, 0.0) + v.detach()
    return {k: v / sc.grad_accum for k, v in aux_sum.items()}


def _grad_norm(sc: StepConfig, state: TrainState,
               metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The metrics with the gradients' norm (the gradients synced across
    the mesh first)."""
    par = sc.parallel
    tensors = group_tensors(state.trainable)
    if par is None:
        grads = [t.grad for t in tensors if t.grad is not None]
        metrics["grad_norm"] = torch.sqrt(sum(g.float().pow(2).sum() for g in grads))
        return metrics
    par.sync_grads(tensors)
    metrics = par.average_metrics(metrics)
    metrics["grad_norm"] = torch.sqrt(par.grad_sq_sum(tensors))
    return metrics


def run_steps(train_step, state: TrainState, batches, frozen: FrozenModels,
              steps_per_call: int) -> List[Dict[str, torch.Tensor]]:
    """One `steps_per_call` group: K steps over K batches (on the card, K
    replays of the captured step: the counterpart of JAX's K-step scan)."""
    metrics = []
    for _, batch in zip(range(steps_per_call), batches):
        metrics.append(train_step(state, batch, frozen))
    return metrics
