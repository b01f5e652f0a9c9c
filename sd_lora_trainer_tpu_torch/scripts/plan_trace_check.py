"""Zero-FLOP check of every remat/stash8/int8 plan at full SDXL 1024px bs=8.

    python -m sd_lora_trainer_tpu_torch.scripts.plan_trace_check [--tiny]

Counterpart of the JAX package's scripts/plan_trace_check.py: the train
step's loss, backward and optimizer update under each plan of `CASES` (the
JAX script's list and its int8+te case), traced under FakeTensorMode on
the CPU: every tensor is a fake with a shape and no storage, so nothing is
computed and nothing is allocated. A plan or name typo, a tag mismatch or a
shape error raises here, before chip time is spent. Plain attention
(`use_flash=False`), as in the JAX script; the flash op's own fake is held
by the tests. `--tiny` traces the tiny configs at 64px bs=2 (the tests).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

# (remat, stash8, base quantization): the JAX script's plans, then the
# int8+te case (the text encoders quantized too, the conditioning recomputed)
CASES = [
    ("save:flash_out*,flash_lse*", "", "none"),
    ("light+save:flash_out*,flash_lse*", "", "none"),
    ("save:flash_out*,flash_lse*", "flash_out*", "none"),
    ("save:flash_out*,flash_lse*,xattn_out_c1280", "flash_out*,xattn_out_c1280", "none"),
    ("save:flash_out*,flash_lse*,xattn_out*", "flash_out*,xattn_out*", "none"),
    ("light+save:flash_out*,flash_lse*", "flash_out*", "none"),
    ("save:flash_out*,flash_lse*", "", "int8"),
    ("save:flash_out*,flash_lse*,xattn_out*", "", "int8"),
    ("save:flash_out*,flash_lse*,xattn_out*,attn_out*", "", "int8"),
    ("light+save:flash_out*,flash_lse*", "", "int8"),
    ("save:flash_out*,flash_lse*,xattn_out*,ff_hidden_c1280", "ff_hidden_c1280", "int8"),
    ("save:flash_out*,flash_lse*,xattn_out*,attn_out*", "", "int8+te"),
]


def build(tiny: bool, batch: int, res: int):
    """Fake frozen models (bf16), the LoRA+TI trainables and one batch."""
    from sd_lora_trainer_tpu_torch.diffusion.schedulers import DDPMSchedule
    from sd_lora_trainer_tpu_torch.models import clip, unet as unet_mod
    from sd_lora_trainer_tpu_torch.models.lora import UNET_TARGETS, create_lora_params
    from sd_lora_trainer_tpu_torch.training.embeddings import initialize_new_tokens
    from sd_lora_trainer_tpu_torch.training.step import FrozenModels

    unet_cfg = unet_mod.TINY_SDXL_UNET_CONFIG if tiny else unet_mod.SDXL_UNET_CONFIG
    c1 = clip.TINY_CLIP_L_CONFIG if tiny else clip.CLIP_L_CONFIG
    c2 = clip.TINY_CLIP_G_CONFIG if tiny else clip.CLIP_BIG_G_CONFIG
    gen = torch.Generator().manual_seed(0)
    unet = unet_mod.init_unet_params(unet_cfg, gen, dtype=torch.bfloat16, device="cpu")
    te1 = clip.init_clip_params(c1, gen, dtype=torch.bfloat16, device="cpu")
    te2 = clip.init_clip_params(c2, gen, dtype=torch.bfloat16, device="cpu")
    lora = create_lora_params(unet, 16, gen, targets=UNET_TARGETS)
    rows, targets = initialize_new_tokens(
        [t["text_model"]["embeddings"]["token_embedding"]["weight"] for t in (te1, te2)], 3, gen)
    frozen = FrozenModels(
        unet_params=unet, te1_params=te1, te2_params=te2, schedule=DDPMSchedule.create(device="cpu"),
        distribution_targets=targets, unet_config=unet_cfg, te1_config=c1, te2_config=c2,
        version="sdxl", resolution=(res, res))
    lat = res // 8
    ids = torch.full((1, batch, 77), c1.eos_token_id, dtype=torch.long)
    ids[..., 1:4] = torch.arange(c1.vocab_size, c1.vocab_size + 3)
    shape = (1, batch, lat, lat, 4)
    batch_d = {
        "latent_mean": torch.zeros(shape, dtype=torch.bfloat16),
        "latent_logvar": torch.zeros(shape, dtype=torch.bfloat16),
        "mask": torch.ones(shape[:-1] + (1,), dtype=torch.bfloat16),
        "input_ids": ids, "input_ids_2": ids,
        "caption_token_lengths": torch.full((1, batch), 8),
        "ti_token_positions": torch.tensor([1, 2, 3]).repeat(1, batch, 1),
        "latent_scale": torch.tensor(0.13025),
    }
    return frozen, {"unet": lora, "ti": {"te1": rows[0], "te2": rows[1]}}, batch_d


def trace_plan(case, tiny: bool = False, batch: int = 8, res: int = 1024) -> None:
    """Trace one step (loss, backward, update) under `case` on fake tensors;
    raises where the plan does not run."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from sd_lora_trainer_tpu_torch.config import TrainingConfig
    from sd_lora_trainer_tpu_torch.models.fuse import fuse_attention_projections
    from sd_lora_trainer_tpu_torch.models.quant import quantize_frozen
    from sd_lora_trainer_tpu_torch.training.optimizers import GroupOptimizer
    from sd_lora_trainer_tpu_torch.training.step import StepConfig, TrainState, make_train_step

    remat, stash8, baseq = case
    config = TrainingConfig(lora_training_urls="x", concept_mode="style", sd_model_version="sdxl",
                            max_train_steps=400, lora_rank=16, train_batch_size=batch,
                            resolution=res, device="cpu", _testing_no_output_dir=True)
    sc = dataclasses.replace(StepConfig.from_config(config, 1.0), use_flash=False, remat=remat,
                             stash8=stash8, remat_te=baseq == "int8+te")
    with FakeTensorMode():
        frozen, trainable, batch_d = build(tiny, batch, res)
        quantize_frozen(frozen, baseq)
        frozen.unet_params = fuse_attention_projections(frozen.unet_params)
        state = TrainState(step=0, trainable=trainable, optimizer=GroupOptimizer(config, trainable),
                           generator=torch.Generator().manual_seed(1))
        metrics = make_train_step(sc)(state, batch_d, frozen)
        if tuple(metrics["tot_loss"].shape) != () or state.step != 1:
            raise RuntimeError(f"plan {case}: the step returned {metrics['tot_loss']}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tiny", action="store_true", help="tiny configs at 64px bs=2")
    args = parser.parse_args(argv)
    batch, res = (2, 64) if args.tiny else (8, 1024)
    for case in CASES:
        t0 = time.perf_counter()
        trace_plan(case, args.tiny, batch, res)
        print(f"OK  remat={case[0]!r} stash8={case[1]!r} baseq={case[2]} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"ALL {len(CASES)} PLANS TRACE at {'tiny' if args.tiny else 'full'} SDXL {res}px "
          f"bs={batch}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
