"""The CLI trainer: `train(config) -> generator` (counterpart of sd_lora_trainer_tpu/main.py).

    python -m sd_lora_trainer_tpu_torch.main <config.json>

Loads the base checkpoint, runs the dataset preprocessing once, registers
the TI tokens and builds the adapters and the three-group optimizer, caches
the VAE latents, then drives the step loop, yielding progress floats and
returning (config, output_dir). At each checkpoint it writes the JAX
package's artifact set (the kohya LoRA, the TI embeddings,
special_params.json, training_args.json) and renders the validation grid.
Everything runs on `config.device`: "cuda" unless the config asks for
"cpu", as the tests' configs do.

Host draws are numpy/Python `random` from `config.seed`, as in the JAX
package, so batches, caption dropout and render prompts match it. Device
draws, which JAX takes from `jax.random` keys, come from `torch.Generator`s
seeded from `config.seed`: one for the TI rows and the adapters, in that
order, and one (seed + 1) for the steps' noise, timesteps and latent draws.

Two faults of the JAX loop are not copied: the DAAM image ratio is derived
per bucket (JAX bakes the base resolution's into every bucket's step), and
the buffered bucket draws are never evicted (JAX drops the oldest past 64).
`steps_per_call` groups K steps the way JAX's K-scan call does (the same
grouped drawing, so the same batches). On the card each step is one CUDA
graph (training/step.py `make_train_step`), captured per bucket at that
bucket's second step (its first runs eagerly, a real step, where JAX
compiles on a throwaway state), so K steps are K replays; the batch goes
from pinned host memory into the graph's inputs. Multi-process runs and
the "offload:" plan run eagerly and say so. The summary line gives the
step's mode, each capture's seconds and the replays' s/step
(`s_per_replay`: the loop less each shape's eager first step and capture).

With `token_warmup_steps` and a concept description (GPT's, or the
config's own `training_attributes["gpt_description"]`), the TI rows are
first warmed up against the description (training/token_warmup.py).

More than one process (torchrun, or the JAX package's SDT_* variables;
parallel/distributed.py) trains on a mesh of one device per process, as the
JAX package's sharding block lays it out (`resolve_sharding`): "dp" splits
the global batch over the data group, "fsdp" also shards a full finetune's
UNet and its optimizer state, "tp" splits the frozen UNet's attention and
GEGLU projections over a model group of `mesh_model_parallel` (a tp request
that does not divide falls back with JAX's printed line). "fsdp" on one
process trains as "dp", as JAX's mesh of one device does. Ranks other than
0 preprocess into `output_dir/rank{r}`; rank 0 alone writes the artifacts,
the train state (gathered from every rank first), the renders and the
plots, while the others wait at a barrier.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from sd_lora_trainer_tpu_torch.checkpoint import restore_train_state, save_checkpoint, save_train_state
from sd_lora_trainer_tpu_torch.config import TrainingConfig, model_paths
from sd_lora_trainer_tpu_torch.data.captioners import DEGRADATIONS, record_degradation
from sd_lora_trainer_tpu_torch.data.dataset import EpochSampler, LatentDataset
from sd_lora_trainer_tpu_torch.data.io import make_validation_img_grid
from sd_lora_trainer_tpu_torch.data.preprocess import preprocess
from sd_lora_trainer_tpu_torch.diffusion.schedulers import DDPMSchedule
from sd_lora_trainer_tpu_torch.inference import InferencePipeline, render_images
from sd_lora_trainer_tpu_torch.models import tokenizer_native
from sd_lora_trainer_tpu_torch.models.fuse import fuse_attention_projections
from sd_lora_trainer_tpu_torch.models.lora import TEXT_ENCODER_TARGETS, UNET_TARGETS, create_lora_params
from sd_lora_trainer_tpu_torch.models.quant import quantize_base_weights, quantized_bytes_saved
from sd_lora_trainer_tpu_torch.models.tokenizer import CLIPTokenizer, build_sized_test_vocab, load_tokenizer
from sd_lora_trainer_tpu_torch.models.weights import LoadedModels, load_models_from_checkpoint
from sd_lora_trainer_tpu_torch.ops import flash_attention as fa
from sd_lora_trainer_tpu_torch.ops import norms
from sd_lora_trainer_tpu_torch.parallel import sharding
from sd_lora_trainer_tpu_torch.parallel.distributed import (
    barrier,
    maybe_initialize_distributed,
    rank_device,
    unshard_to_rank0,
)
from sd_lora_trainer_tpu_torch.training.embeddings import TokenEmbeddingsHandler
from sd_lora_trainer_tpu_torch.training.optimizers import GroupOptimizer, current_lrs, group_tensors
from sd_lora_trainer_tpu_torch.training.step import FrozenModels, StepConfig, TrainState, make_train_step
from sd_lora_trainer_tpu_torch.training.token_warmup import warmup_token_embeddings
from sd_lora_trainer_tpu_torch.utils.utils import dtype_map, seed_everything

# the line train() prints last, for scripts that read its phase times
SUMMARY_TAG = "[train-summary]"
# no checkpoint inside the loop's last FINAL_SAVE_MARGIN steps: the final
# save follows, and it is skipped when the last one is that close to the end
FINAL_SAVE_MARGIN = 25


def build_tokenizers(loaded: LoadedModels):
    """The staged CLIP vocab (model_paths["CLIP"]/tokenizer) when its size
    matches the encoders, else a synthetic vocab of their table size
    (synthetic checkpoints). The C++ tokenizer unless no g++ exists."""
    vocab_dir = os.path.join(model_paths.get_path("CLIP") or ".", "tokenizer")
    test_words = ["photo", "style", "painting", "portrait", "object", "person", "the", "of", "a"]
    use_native = tokenizer_native.native_available()
    if not use_native:
        record_degradation("tokenizer", "native C++ BPE (csrc/clip_bpe.cpp)", "Python BPE",
                           "no g++ on PATH to build the native tokenizer")

    def build(vocab, merges, pad_token_id):
        if use_native:
            return tokenizer_native.NativeCLIPTokenizer(vocab, merges, pad_token_id=pad_token_id)
        return CLIPTokenizer(vocab, merges, pad_token_id=pad_token_id)

    def make(cfg, pad_token_id=None):
        if cfg is None:
            return None
        if os.path.exists(os.path.join(vocab_dir, "vocab.json")):
            tok = load_tokenizer(vocab_dir, pad_token_id=pad_token_id)
            if len(tok.encoder) == cfg.vocab_size:
                merges = [tuple(m) for m in sorted(tok.bpe_ranks, key=tok.bpe_ranks.get)]
                return build(tok.encoder, merges, pad_token_id)
            record_degradation("tokenizer", f"staged CLIP vocab ({len(tok.encoder)} tokens)",
                               "synthetic sized vocab",
                               f"size mismatch vs model vocab {cfg.vocab_size}")
        else:
            record_degradation(
                "tokenizer", "staged CLIP vocab", "synthetic sized vocab",
                f"no vocab.json under {vocab_dir}; fine for synthetic checkpoints, "
                "wrong for real SD weights — stage the CLIP tokenizer files")
        vocab, merges = build_sized_test_vocab(cfg.vocab_size, extra_words=test_words)
        return build(vocab, merges, pad_token_id)

    return make(loaded.text_encoder_config), make(loaded.text_encoder_2_config, pad_token_id=0)


def download_weights_if_needed(pretrained_model: dict) -> str:
    path = pretrained_model["path"]
    if not os.path.exists(path) and pretrained_model.get("url"):
        from sd_lora_trainer_tpu_torch.data.io import download

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        print(f"downloading {pretrained_model['url']} -> {path}")
        download(pretrained_model["url"], os.path.dirname(path) or ".", filepath=path)
    return path


def daam_img_ratio(res, train_img_size) -> float:
    """The width/height the DAAM loss factors a step's attention maps by:
    the bucket's own (res, (w, h)) under bucketing, else the train size's.
    The JAX loop gives every bucket the train size's, whose maps then do not
    factor."""
    w, h = res if res is not None else train_img_size
    return w / h


class BucketedDraws:
    """Bucketed batch draws for groups pinned to one resolution (the
    micro-batches of a step, the K steps of a call). A draw of another
    resolution than the group's waits in `pending` for a later group; the
    group leader takes the oldest waiting draw first, so every draw is
    delivered and the plan's per-image exposure holds. None is dropped (the
    JAX loop evicts the oldest past 64)."""

    def __init__(self, dataset: LatentDataset, rng: np.random.RandomState, batch_size: int):
        self.dataset, self.rng, self.batch_size = dataset, rng, batch_size
        self.pending: List = []

    def draw(self, step_res=None):
        """(batch, resolution); `step_res` pins the resolution."""
        if step_res is None:
            if self.pending:
                return self.pending.pop(0)
        else:
            for i, (_, r) in enumerate(self.pending):
                if r == step_res:
                    return self.pending.pop(i)
        for _ in range(16):
            data, res = self.dataset.bucketed_batch()
            res = tuple(res)
            if step_res is None or res == step_res:
                return data, res
            self.pending.append((data, res))
        # the plan ran dry of this resolution: resample the bucket's pool
        store = self.dataset.bucket_latents[step_res]
        pick = self.rng.choice(list(store.keys()), size=self.batch_size, replace=True)
        return {
            "latent_mean": np.stack([store[i][0] for i in pick]),
            "latent_logvar": np.stack([store[i][1] for i in pick]),
            "mask": np.stack([store[i][2] for i in pick]),
            "captions": [self.dataset.captions[i] for i in pick],
        }, step_res


def resolve_sharding(config: TrainingConfig, world: int):
    """(mode, n_data, n_model) of the mesh a run of `world` processes (one
    device each) trains on, or None for one device without a mesh: the JAX
    package's sharding block (sd_lora_trainer_tpu/main.py). Prints its
    `[sharding]` line; raises where no mesh fits."""
    n_devices = config.mesh_data_parallel or world
    if n_devices != world:
        raise ValueError(f"mesh_data_parallel={config.mesh_data_parallel} needs as many "
                         f"processes, one per device; this run has {world} (launch with "
                         f"torchrun --nproc_per_node {config.mesh_data_parallel})")
    mode = config.sharding_mode
    if mode == "tp":
        n_model = max(int(config.mesh_model_parallel), 1)
        n_data = n_devices // n_model
        tp_ok = (config.is_lora and n_model > 1 and n_devices % n_model == 0
                 and (n_data == 1 or config.train_batch_size % n_data == 0))
        if tp_ok:
            if config.use_dora:
                raise ValueError("DoRA needs each output's whole weight norm; it does not run "
                                 "under sharding_mode 'tp' (use 'dp')")
            print(f"[sharding] tp over a mesh data={n_data} x model={n_model}")
            return "tp", n_data, n_model
        mode = "dp" if config.is_lora else "fsdp"
        print(f"[sharding] tp requested but devices={n_devices} / model={n_model} / "
              f"batch={config.train_batch_size} do not divide (or run is not LoRA); "
              f"falling back to {mode}")
    if n_devices > 1 and config.train_batch_size % n_devices == 0:
        print(f"[sharding] {mode} over a mesh data={n_devices}")
        return mode, n_devices, 1
    if world > 1:
        raise ValueError(f"multi-process run needs a device mesh: batch="
                         f"{config.train_batch_size} must divide {n_devices} global devices")
    return None


def trainable_copy(tree):
    """A full finetune's trainable UNet: a copy of the base whose float
    tensors require grad (the frozen base stays for rendering, as in JAX)."""
    if torch.is_tensor(tree):
        t = tree.detach().clone()
        return t.requires_grad_() if t.is_floating_point() else t
    if isinstance(tree, dict):
        return {k: trainable_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [trainable_copy(v) for v in tree]
    return tree


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launches() -> Dict[str, int]:
    """The hand-written kernels' launches: flash's, then the norms'."""
    return {**fa.launch_counts(), **norms.launch_counts()}


def _launch_delta(before: Dict[str, int]) -> Dict[str, int]:
    now = _launches()
    return {k: now[k] - before[k] for k in now}


def train(config: TrainingConfig):
    world, rank = maybe_initialize_distributed(config.device)
    is_main = rank == 0
    layout = resolve_sharding(config, world)
    device = rank_device(config.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"config.device={config.device!r} but torch sees no CUDA device; "
                           'set "device": "cpu" in the config to train on the CPU')
    seed_everything(config.seed)
    weight_dtype = dtype_map[config.weight_type]
    if config.resume_from and not os.path.exists(config.resume_from):
        raise FileNotFoundError(f"resume_from points at a missing train state: {config.resume_from}")
    if device.type == "cuda":
        # the config's allow_tf32 governs fp32 products on the card (the
        # upstream PyTorch trainer's knob); the flash kernels do not read it
        torch.backends.cuda.matmul.allow_tf32 = config.allow_tf32
        torch.backends.cudnn.allow_tf32 = config.allow_tf32
    timings: Dict[str, object] = {}
    os.makedirs(str(config.output_dir), exist_ok=True)

    # ---- models ----
    t0 = time.perf_counter()
    loaded = load_models_from_checkpoint(download_weights_if_needed(config.pretrained_model),
                                         dtype=weight_dtype, device=device)
    _sync(device)
    timings["load_s"] = time.perf_counter() - t0
    config.sd_model_version = loaded.version
    config.pretrained_model["version"] = loaded.version
    if not config.sample_imgs_lora_scale:
        config.sample_imgs_lora_scale = 0.75 if loaded.version == "sdxl" else 0.85
    if not config.validation_img_size:
        config.validation_img_size = 1024 if loaded.version == "sdxl" else 768

    # ---- preprocessing ----
    t0 = time.perf_counter()
    # every rank derives the same dataset; each writes it into its own directory
    preprocess_dir = str(config.output_dir)
    if not is_main:
        preprocess_dir = os.path.join(preprocess_dir, f"rank{rank}")
    config, input_dir = preprocess(
        config, working_directory=preprocess_dir, concept_mode=config.concept_mode,
        input_zip_path=config.lora_training_urls, caption_text=config.caption_prefix,
        mask_target_prompts=config.mask_target_prompts, target_size=config.resolution,
        crop_based_on_salience=config.crop_based_on_salience,
        use_face_detection_instead=config.use_face_detection_instead,
        left_right_flip_augmentation=config.left_right_flip_augmentation,
        augment_imgs_up_to_n=config.augment_imgs_up_to_n, caption_model=config.caption_model,
        seed=config.seed,
    )
    timings["preprocess_s"] = time.perf_counter() - t0

    # ---- tokenizers + TI rows ----
    tok1, tok2 = build_tokenizers(loaded)
    handler = TokenEmbeddingsHandler(tokenizers=[tok1, tok2])
    tables = [loaded.text_encoder["text_model"]["embeddings"]["token_embedding"]["weight"],
              loaded.text_encoder_2["text_model"]["embeddings"]["token_embedding"]["weight"]
              if loaded.text_encoder_2 else None]
    init_gen = torch.Generator(device=device).manual_seed(config.seed)
    ti_rows = handler.initialize_new_tokens(tables, config.inserting_list_tokens, init_gen)
    description = config.training_attributes.get("gpt_description")
    if config.token_warmup_steps > 0 and not config.disable_ti and description:
        t0 = time.perf_counter()
        print(f"Warming up token embeddings with prompt: {description}...")
        encoders = {"te1": (loaded.text_encoder, loaded.text_encoder_config, tok1)}
        if loaded.text_encoder_2 is not None:
            encoders["te2"] = (loaded.text_encoder_2, loaded.text_encoder_2_config, tok2)

        def ids(tok, text):
            return torch.as_tensor(np.asarray(tok([text]), np.int64), device=device)

        rows, warmup_losses = warmup_token_embeddings(
            {w: ti_rows[i] for i, w in enumerate(encoders)},
            {w: e[0] for w, e in encoders.items()}, {w: e[1] for w, e in encoders.items()},
            loaded.version, {w: ids(e[2], config.token_dict["TOK"]) for w, e in encoders.items()},
            {w: ids(e[2], description) for w, e in encoders.items()},
            {w: handler.distribution_targets[i] for i, w in enumerate(encoders)},
            steps=config.token_warmup_steps, ti_lr=config.ti_lr,
            ti_weight_decay=config.ti_weight_decay, tok_cov_reg_w=config.tok_cov_reg_w,
        )
        for i, w in enumerate(encoders):
            ti_rows[i] = rows[w]
        _sync(device)
        timings["token_warmup"] = {"steps": config.token_warmup_steps,
                                   "s": time.perf_counter() - t0, "losses": warmup_losses}
        if config.debug and warmup_losses:
            from sd_lora_trainer_tpu_torch.utils.plots import plot_loss

            plot_loss(warmup_losses, os.path.join(str(config.output_dir), "token_warmup_loss.png"))

    # ---- trainable tree + optimizer ----
    trainable: Dict = {}
    if config.is_lora:
        trainable["unet"] = create_lora_params(
            loaded.unet, config.lora_rank, init_gen, alpha_multiplier=config.lora_alpha_multiplier,
            targets=UNET_TARGETS, use_dora=config.use_dora)
    else:
        print("Doing full fine-tuning on the U-Net")
        trainable["unet"] = trainable_copy(loaded.unet)
    if not config.disable_ti:
        trainable["ti"] = {"te1": ti_rows[0]}
        if ti_rows[1] is not None:
            trainable["ti"]["te2"] = ti_rows[1]
    if config.text_encoder_lora_optimizer is not None and config.is_lora:
        te_lora = {}
        for which, params in (("te1", loaded.text_encoder), ("te2", loaded.text_encoder_2)):
            if params is not None:
                te_lora[which] = create_lora_params(
                    params, config.text_encoder_lora_rank, init_gen,
                    alpha_multiplier=config.lora_alpha_multiplier, targets=TEXT_ENCODER_TARGETS,
                    use_dora=config.use_dora)
        trainable["te_lora"] = te_lora

    # ---- dataset: the one-time VAE latent cache ----
    t0 = time.perf_counter()
    train_dataset = LatentDataset.from_directory(
        input_dir, loaded.vae, loaded.vae_config, size=tuple(config.train_img_size),
        substitute_caption_map=config.token_dict,
        aspect_ratio_bucketing=config.aspect_ratio_bucketing,
        train_batch_size=config.train_batch_size, seed=config.seed,
    )
    timings["latent_cache_s"] = time.perf_counter() - t0
    stats = train_dataset.encode_stats
    timings["vae_encode"] = {"images": stats["images"], "s": stats["seconds"],
                             "peak_gib": stats["peak_bytes"] / 2**30,
                             "resident_gib": stats["resident_bytes"] / 2**30}
    print(f"Final training captions:\n{train_dataset.captions[:40]}")
    n_batches_per_epoch = max(len(train_dataset) // config.train_batch_size, 1)
    config.num_train_epochs = int(math.ceil(
        config.max_train_steps * config.gradient_accumulation_steps / n_batches_per_epoch))

    # ---- optional int8 frozen base, before the frozen bundle captures it ----
    quantize_base = config.resolve_quantize_base()
    if quantize_base != config.quantize_base and config.quantize_base != "auto":
        reason = "full finetune trains the base" if not config.is_lora else "tp shards bf16 kernels"
        print(f"[quantize_base] {reason}; ignoring")
    if quantize_base in ("int8", "int8+te"):
        loaded.unet = quantize_base_weights(loaded.unet)
        saved = quantized_bytes_saved(loaded.unet)
        if quantize_base == "int8+te":
            loaded.text_encoder = quantize_base_weights(loaded.text_encoder)
            saved += quantized_bytes_saved(loaded.text_encoder)
            if loaded.text_encoder_2 is not None:
                loaded.text_encoder_2 = quantize_base_weights(loaded.text_encoder_2)
                saved += quantized_bytes_saved(loaded.text_encoder_2)
        print(f"[quantize_base] frozen {'UNet+TE' if quantize_base == 'int8+te' else 'UNet'}"
              f" kernels -> int8 ({saved / 2**30:.2f} GiB freed)")
    elif quantize_base != "none":
        raise ValueError(f"quantize_base must be 'auto', 'none', 'int8' or 'int8+te', "
                         f"got {config.quantize_base!r}")

    # ---- frozen bundle + step ----
    dist_targets = {f"te{i + 1}": t for i, t in handler.distribution_targets.items()}
    schedule = DDPMSchedule.create(device=device)
    frozen = FrozenModels(
        unet_params=loaded.unet, te1_params=loaded.text_encoder, te2_params=loaded.text_encoder_2,
        schedule=schedule, distribution_targets=dist_targets, unet_config=loaded.unet_config,
        te1_config=loaded.text_encoder_config, te2_config=loaded.text_encoder_2_config,
        version=loaded.version, resolution=tuple(config.train_img_size),
    )
    if (config.fuse_qkv and config.is_lora and not config.use_dora
            and config.sharding_mode != "tp"):
        # fused qkv/kv weights for the step's copy; rendering and export read
        # loaded.unet, which stays unfused. tp splits the unfused projections
        frozen = dataclasses.replace(frozen, unet_params=fuse_attention_projections(frozen.unet_params))
    plan = None
    if layout is not None:
        mode, n_data, n_model = layout
        mesh = sharding.Mesh(n_data, n_model, device=device)
        print(f"[sharding] {mode}: mesh data={n_data} x model={n_model} over {world} "
              f"process(es), backend {mesh.backend}")
        # fsdp: the trainable UNet as this rank's shards; tp: the step's
        # frozen UNet as this rank's split (loaded.unet stays whole)
        plan, trainable, frozen = sharding.parallelize(mode, mesh, trainable, frozen)
    optimizer = GroupOptimizer(config, trainable, totals={"unet": plan.batch.total}
                               if plan is not None and plan.fsdp is not None else None)
    w0, h0 = config.train_img_size
    sc = dataclasses.replace(StepConfig.from_config(config, w0 / h0), parallel=plan)
    if config.remat == "auto":
        print(f"[remat] auto -> {sc.remat}")
    step_fns: Dict = {}

    def step_fn_for(res):
        ratio = daam_img_ratio(res, config.train_img_size)
        if ratio not in step_fns:
            # debug arms the step's phase marks: device ms by phase in the summary
            armed = {"phases": True} if config.debug else {}
            step_fns[ratio] = make_train_step(dataclasses.replace(sc, daam_img_ratio=ratio),
                                              **armed)
        return step_fns[ratio]

    steps_per_call = max(int(config.steps_per_call), 1)
    if steps_per_call > 1 and config.debug:
        print("[steps_per_call] debug needs per-step granularity; using 1")
        steps_per_call = 1
    state = TrainState(step=0, trainable=trainable, optimizer=optimizer,
                       generator=torch.Generator(device=device).manual_seed(config.seed + 1))

    resume_step = 0
    if config.resume_from:
        state = restore_train_state(config.resume_from, state, plan)
        resume_step = int(state.step)
        if resume_step >= config.max_train_steps:
            raise ValueError(f"resume_from state is at step {resume_step} >= "
                             f"max_train_steps={config.max_train_steps}; nothing to train")
        print(f"[resume] restored train state (trainable + optimizer moments + generator) "
              f"from {config.resume_from} at step {resume_step}")

    checkpoint_dir = os.path.join(str(config.output_dir), "checkpoints")
    if is_main:
        if os.path.exists(checkpoint_dir):
            shutil.rmtree(checkpoint_dir)
        os.makedirs(checkpoint_dir, exist_ok=True)

    losses: Dict[str, List] = {}  # device scalars, pulled to host lazily
    metrics_hosted: Dict[str, int] = {}
    rng = np.random.RandomState(config.seed)
    sampler = EpochSampler(len(train_dataset), config.seed)
    start_time, images_done = time.time(), 0
    global_step, last_save_step = resume_step, 0
    accum = config.gradient_accumulation_steps
    token_string = config.token_dict["TOK"]
    bucket_draws = BucketedDraws(train_dataset, rng, config.train_batch_size)

    def assemble_batch(step_res=None):
        """Host batch prep (sampling, caption dropout, tokenization, the DAAM
        caption analysis), stacked [accum, B, ...]; returns (batch, res)."""
        micro = []
        for _ in range(accum):
            if config.aspect_ratio_bucketing:
                data, res = bucket_draws.draw(step_res)
                if step_res is None:
                    step_res = tuple(res)
            else:
                data = train_dataset.batch(sampler.next_batch(config.train_batch_size))
            captions = list(data["captions"])
            if config.caption_dropout > 0.0:
                captions = [token_string if rng.rand() < config.caption_dropout else c
                            for c in captions]
            ids1 = np.asarray(tok1(captions), np.int64)
            ids2 = np.asarray(tok2(captions), np.int64) if tok2 else ids1
            lengths, positions = zip(*(handler.ti_token_positions(c) for c in captions))
            micro.append({
                "latent_mean": data["latent_mean"], "latent_logvar": data["latent_logvar"],
                "mask": data["mask"], "input_ids": ids1, "input_ids_2": ids2,
                "caption_token_lengths": np.asarray(lengths, np.int64),
                "ti_token_positions": np.asarray(positions, np.int64),
            })
        batch = {k: np.stack([m[k] for m in micro]) for k in micro[0]}
        batch["latent_scale"] = np.float32(train_dataset.vae_scaling_factor)
        return batch, step_res

    def host_tensors(batch):
        """The latent distribution and masks in the weight dtype (the step
        runs the UNet in it), ids as int64, the scale as a 0-d float32, in
        host memory: pinned for a card, so that the step's copy into its
        inputs does not wait for the card."""
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(np.asarray(v))
            if k in ("latent_mean", "latent_logvar", "mask"):
                t = t.to(weight_dtype)
            out[k] = t.pin_memory() if device.type == "cuda" else t
        return out

    def current_adapters(tr):
        unet_lora = tr.get("unet") if config.is_lora else None
        te_loras = [tr.get("te_lora", {}).get("te1"), tr.get("te_lora", {}).get("te2")]
        ti = tr.get("ti", {})
        rows = [ti["te1"].detach() if "te1" in ti else None,
                ti["te2"].detach() if "te2" in ti else None]
        return unet_lora, te_loras, rows

    ckpt_secs, render_secs, rendered, render_launches = [], [], [], []

    def do_checkpoint(output_save_dir, tr):
        _sync(device)
        t = time.perf_counter()
        unet_lora, te_loras, rows = current_adapters(tr)
        os.makedirs(output_save_dir, exist_ok=True)
        config.training_attributes["degradations"] = list(DEGRADATIONS)
        config.save_as_json(os.path.join(output_save_dir, "training_args.json"))
        save_checkpoint(
            output_dir=output_save_dir, global_step=global_step, name=config.name,
            pretrained_model_version=config.pretrained_model["version"],
            token_dict=config.token_dict, is_lora=config.is_lora, ti_rows=rows,
            unet_lora=unet_lora, te_loras=te_loras,
            unet_params=None if config.is_lora else tr["unet"],
            unet_config=None if config.is_lora else loaded.unet_config,
        )
        ckpt_secs.append(time.perf_counter() - t)

    def do_render(output_save_dir, tr):
        _sync(device)
        t, before = time.perf_counter(), _launches()
        unet_lora, te_loras, rows = current_adapters(tr)
        # a full finetune gathered under fsdp lies in host memory
        render_unet = loaded.unet if config.is_lora else sharding._map(
            tr["unet"], lambda _, t: t.to(device))
        pipe = InferencePipeline(
            version=loaded.version, unet_params=render_unet, unet_config=loaded.unet_config,
            te1_params=loaded.text_encoder, te1_config=loaded.text_encoder_config,
            te2_params=loaded.text_encoder_2, te2_config=loaded.text_encoder_2_config,
            vae_params=loaded.vae, vae_config=loaded.vae_config, tokenizer_1=tok1,
            tokenizer_2=tok2, schedule=schedule, ti_rows=rows,
        )
        size = config.validation_img_size
        size = size if isinstance(size, (list, tuple)) else [size] * 2
        prompts = render_images(
            pipe, render_size=tuple(int(v) for v in size), lora_path=output_save_dir,
            train_step=global_step, seed=config.seed, lora_scale=config.sample_imgs_lora_scale,
            disable_ti=config.disable_ti, prompt_modifier=config.prompt_modifier,
            n_imgs=config.n_sample_imgs, unet_lora=unet_lora if config.is_lora else None,
            te_loras=te_loras,
        )
        grid_path = make_validation_img_grid(output_save_dir)
        shutil.copy(grid_path, os.path.join(os.path.dirname(output_save_dir),
                                            f"validation_grid_{global_step:04d}.jpg"))
        _sync(device)
        render_secs.append(time.perf_counter() - t)
        rendered.append(len(prompts))
        render_launches.append(_launch_delta(before))
        return prompts

    def save_outputs(output_save_dir) -> List[str]:
        """One checkpoint: the fsdp shards gathered into rank 0's host memory
        (every rank enters), the train state, then on rank 0 the artifacts,
        plots and renders, while the other ranks wait at the barrier.
        Returns the render prompts."""
        t = time.perf_counter()
        tr = unshard_to_rank0(state.trainable, plan)
        if config.save_train_state:
            save_train_state(os.path.join(output_save_dir, "train_state.safetensors"), state,
                             plan, whole=tr)
        state_s = time.perf_counter() - t
        prompts: List[str] = []
        if is_main:
            do_checkpoint(output_save_dir, tr)
            ckpt_secs[-1] += state_s
            if config.debug:
                write_debug_plots()
            prompts = do_render(output_save_dir, tr)
        del tr
        barrier()
        return prompts

    validation_prompts: List[str] = []
    progress_stride = max(config.max_train_steps // 100, 1)
    lr_history: Dict[str, List[float]] = {}
    token_stds: Dict[str, List[float]] = {}

    def losses_as_floats() -> Dict[str, List[float]]:
        return {k: [float(x) for x in v] for k, v in losses.items()}

    def write_debug_plots():
        from sd_lora_trainer_tpu_torch.utils.plots import (
            plot_grad_norms, plot_loss, plot_lrs, plot_param_histogram, plot_token_stds)

        host_losses = losses_as_floats()
        out = str(config.output_dir)
        plot_loss({k: v for k, v in host_losses.items() if k != "grad_norm"},
                  os.path.join(out, "losses.png"))
        plot_lrs(lr_history, os.path.join(out, "learning_rates.png"))
        plot_grad_norms({"total": host_losses.get("grad_norm", [])},
                        os.path.join(out, "grad_norms.png"))
        targets = {f"te{i + 1}_target": handler.std_token_embedding[i]
                   for i in handler.std_token_embedding}
        plot_token_stds(token_stds, os.path.join(out, "token_stds.png"), targets)
        if config.is_lora:
            leaves = [t.detach().float().flatten().cpu().numpy()
                      for t in group_tensors(state.trainable.get("unet", {}))]
            if leaves:
                plot_param_histogram(np.concatenate(leaves),
                                     os.path.join(out, f"lora_weights_{global_step}.png"))

    if resume_step:
        # replay the completed steps' host draws, grouped as the loop groups them
        print(f"[resume] fast-forwarding host data RNG through {resume_step} steps")
        ff = 0
        while ff < resume_step:
            if steps_per_call > 1 and ff + steps_per_call <= resume_step:
                _, r = assemble_batch()
                for _ in range(steps_per_call - 1):
                    assemble_batch(r)
                ff += steps_per_call
            else:
                assemble_batch()
                ff += 1

    call_k = steps_per_call
    batch_prep_s = 0.0  # host: sampling, caption dropout, tokenization
    before_train = _launches()
    sharding.reset_collective_stats()  # the summary counts the loop's collectives
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)  # the summary's loop_peak_gib
    loop_start = time.perf_counter()

    def crossed(stride: int) -> bool:
        """Did the last call's steps cross a multiple of `stride`?"""
        return (global_step // stride) > ((global_step - call_k) // stride)

    while global_step < config.max_train_steps:
        call_k = steps_per_call if global_step + steps_per_call <= config.max_train_steps else 1
        t = time.perf_counter()
        first, call_res = assemble_batch()
        # grouped drawing: the first batch picks the resolution (bucketing),
        # the other K-1 are pinned to it, as in JAX's K-scan call
        drawn = [first] + [assemble_batch(call_res)[0] for _ in range(call_k - 1)]
        batch_prep_s += time.perf_counter() - t
        step_fn = step_fn_for(call_res)
        for batch in drawn:
            metrics = step_fn(state, host_tensors(batch), frozen)
            for k, v in metrics.items():
                losses.setdefault(k, []).append(v)
        global_step += call_k
        images_done += config.train_batch_size * accum * call_k

        if crossed(64):
            # pull the accumulated device scalars to host floats in bulk
            for k, seq in losses.items():
                start = metrics_hosted.get(k, 0)
                if start < len(seq):
                    seq[start:] = [float(x) for x in seq[start:]]
                    metrics_hosted[k] = len(seq)

        if config.debug:
            for k, v in current_lrs(config, global_step, state.optimizer).items():
                lr_history.setdefault(k, []).append(v)
            for which, rows_t in state.trainable.get("ti", {}).items():
                for i, s in enumerate(rows_t.detach().float().std(dim=1, correction=0).tolist()):
                    token_stds.setdefault(f"{which}_token_{i}", []).append(s)

        if (crossed(config.checkpointing_steps)
                and global_step < config.max_train_steps - FINAL_SAVE_MARGIN):
            fps = images_done / (time.time() - start_time)
            print(f"\n---- avg training fps: {fps:.2f}", flush=True)
            output_save_dir = f"{checkpoint_dir}/checkpoint-{global_step}"
            validation_prompts = save_outputs(output_save_dir)
            last_save_step = global_step

        if config.save_train_state and crossed(config.checkpointing_steps):
            # the rolling resume state at a fixed path, refreshed every interval
            save_train_state(os.path.join(str(config.output_dir), "train_state.safetensors"), state,
                             plan)

        if crossed(progress_stride):
            yield min(global_step / config.max_train_steps + 0.05, 1.0)

    _sync(device)
    loop_s = time.perf_counter() - loop_start - sum(ckpt_secs) - sum(render_secs)
    if device.type == "cuda":  # the steps' peak, and any checkpoint's inside the loop
        timings["loop_peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    train_launches = _launch_delta(before_train)
    for per_render in render_launches:
        for k, v in per_render.items():
            train_launches[k] -= v
    n_steps = global_step - resume_step

    # ---- final save ----
    need_final = (global_step - last_save_step) > FINAL_SAVE_MARGIN + 1 or last_save_step == 0
    output_save_dir = f"{checkpoint_dir}/checkpoint-{global_step if need_final else last_save_step}"
    if need_final:
        validation_prompts = save_outputs(output_save_dir)
    else:
        print(f"Skipping final save, {output_save_dir} already exists")

    if config.debug and is_main:
        import zipfile

        pkg_dir = os.path.dirname(os.path.abspath(__file__))
        zip_file_path = os.path.join(str(config.output_dir), "source_code.zip")
        with zipfile.ZipFile(zip_file_path, "w", zipfile.ZIP_DEFLATED) as zipf:
            for root, _dirs, files in os.walk(pkg_dir):
                for f in sorted(files):
                    if f.endswith(".py"):
                        full = os.path.join(root, f)
                        zipf.write(full, os.path.relpath(full, os.path.dirname(pkg_dir)))

    host_losses = losses_as_floats()
    config.job_time = time.time() - config.start_time
    config.training_attributes["validation_prompts"] = validation_prompts
    config.training_attributes["final_losses"] = {k: v[-5:] for k, v in host_losses.items()}
    if config.debug:
        config.training_attributes["loss_series"] = host_losses
    if is_main:
        config.save_as_json(os.path.join(output_save_dir, "training_args.json"))
    step_modes = {getattr(fn, "mode", None) for fn in step_fns.values()}
    # each step shape's eager first step and capture are one-time work;
    # the loop less them is the replays' time
    graphs = [g for fn in step_fns.values() for g in getattr(fn, "graphs", {}).values()]
    replays = n_steps - len(graphs)
    replay_s = loop_s - sum(g.warmup_s + g.capture_s for g in graphs)
    timings.update({
        "step_mode": step_modes.pop() if len(step_modes) == 1 else sorted(map(str, step_modes)),
        "captures": [c for fn in step_fns.values() for c in getattr(fn, "captures", list)()],
        "steps": n_steps, "loop_s": loop_s, "s_per_step": loop_s / max(n_steps, 1),
        "s_per_replay": replay_s / replays if graphs and replays > 0 else None,
        "batch_prep_s": batch_prep_s,
        "checkpoint_s": ckpt_secs, "render_s": render_secs, "rendered_images": rendered,
        "launches": {"train": train_launches, "render": render_launches},
        "tot_loss": host_losses.get("tot_loss", []),
        "world": world, "rank": rank, "sharding": layout[0] if layout else None,
        "collectives": sharding.collective_stats(),
    })
    if config.debug:
        timings["phase_ms"] = [getattr(fn, "phase_ms", lambda: None)() for fn in step_fns.values()]
    print(SUMMARY_TAG + " " + json.dumps(timings), flush=True)
    print("Training job complete, saving outputs...", flush=True)
    return config, output_save_dir


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Train a concept (LoRA + textual inversion)")
    parser.add_argument("config_filename", type=str, help="input JSON configuration file")
    args = parser.parse_args(argv)
    config = TrainingConfig.from_json(args.config_filename)
    print("Starting new LoRA training run with config:")
    print(config)
    print("------------------------------------------")
    for progress in train(config):
        print(f"Progress: {(100 * progress):.2f}%", end="\r")
    print("Training done :)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
