"""One AdamW (or AdamW8bit) update of the full-finetune SDXL UNet, timed on one card.

    python -m sd_lora_trainer_tpu_torch.scripts.update_time [--rounds 3] [--device cuda]
        [--optimizer adamw|adamw8bit]

Times the port's AdamW (training/optimizers.py: optax's adamw in foreach
ops, its LR and bias corrections device tensors, as a captured step needs)
against torch.optim.AdamW at the same settings and a Python LR (foreach,
the update the port ran before its step was captured), on the same
parameters and gradients: SDXL's UNet tree (`init_unet_params`, bf16, from
a seed), the full finetune's trainable, with seeded gradients. The two
alternate port, torch, torch, port per round after one warm-up update each;
each update is timed by CUDA events. Then one foreach op the port's update
makes, `_foreach_div_` of the gradients by a 0-d device scalar, is timed
with the scalar in the tensors' dtype and in float32 (the port passes the
former). Prints the card's name and power limit, each time in ms, and one
JSON line with the means and the update's bound: the bytes it must move
(read p, g, m, v; write p, m, v) over the card's memory rate
(utils/profiling.py PEAK_BYTES). With `--optimizer adamw8bit` it times the
port's AdamW8bit update (training/quantized_adam.py; no library has one
here) 2 * `--rounds` times after its warm-up, on the same tensors; its
bound moves p and g in bf16 and each moment as one byte a value.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from sd_lora_trainer_tpu_torch.scripts import resolve_device


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--optimizer", choices=("adamw", "adamw8bit"), default="adamw")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if device.type != "cuda":
        raise SystemExit("update_time: times CUDA events; it needs --device cuda")

    from sd_lora_trainer_tpu_torch.config import TrainingConfig
    from sd_lora_trainer_tpu_torch.models.unet import SDXL_UNET_CONFIG, init_unet_params
    from sd_lora_trainer_tpu_torch.training.optimizers import AdamW, base_unet_lr, group_tensors
    from sd_lora_trainer_tpu_torch.training.quantized_adam import AdamW8bit
    from sd_lora_trainer_tpu_torch.utils.profiling import PEAK_BYTES, device_description

    config = TrainingConfig(lora_training_urls="x", concept_mode="style", is_lora=False,
                            _testing_no_output_dir=True)
    wd, lr = config.lora_weight_decay, base_unet_lr(config)
    gen = torch.Generator(device).manual_seed(0)
    params = [t.requires_grad_() for t in group_tensors(
        init_unet_params(SDXL_UNET_CONFIG, gen, torch.bfloat16, device)) if t.is_floating_point()]
    with torch.no_grad():
        for p in params:
            p.grad = torch.randn(p.shape, generator=gen, dtype=p.dtype, device=device) * 1e-3
    lr_t = torch.full((), lr, dtype=torch.float32, device=device)
    if args.optimizer == "adamw8bit":
        port = AdamW8bit(params, weight_decay=wd)
        updates = {"port": lambda: port.step(lr_t)}
        # p read and written, g read (bf16); m and v read and written, a byte each
        order, value_bytes = ("port", "port"), 3 * 2 + 4 * 1
    else:
        port = AdamW(params, wd)
        library = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)
        updates = {"port": lambda: port.step(lr_t), "torch": library.step}
        order, value_bytes = ("port", "torch", "torch", "port"), 7 * params[0].element_size()

    grads = [p.grad for p in params]
    scalar = torch.full((), 0.999, device=device)
    updates.update({f"div_{dtype}": lambda dtype=dtype: torch._foreach_div_(grads, scalar.to(dtype))
                    for dtype in (params[0].dtype, torch.float32)})

    def timed(name: str) -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        updates[name]()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    for name in updates:  # the warm-up: torch's state, the port's first count
        timed(name)
    ms = {name: [] for name in updates}
    for _ in range(args.rounds):
        for name in order:
            ms[name].append(timed(name))
    for name in updates:
        if name.startswith("div_"):
            ms[name] += [timed(name) for _ in range(args.rounds)]
    n = sum(p.numel() for p in params)
    moved = value_bytes * n
    card = device_description(device)
    print(f"[update_time] card: {card}")
    print(f"[update_time] SDXL UNet full finetune under {args.optimizer}: {n / 1e9:.3f}B bf16 "
          f"params in {len(params)} tensors, lr {lr}, weight decay {wd}")
    for name, xs in ms.items():
        print(f"[update_time] {name}: {[round(x, 3) for x in xs]} ms")
    mean = {name: sum(xs) / len(xs) for name, xs in ms.items()}
    print(json.dumps({"card": card, "optimizer": args.optimizer, "params": n,
                      "tensors": len(params), "ms": ms,
                      "mean_ms": mean, "bound_ms": moved / PEAK_BYTES * 1e3,
                      "bound_by": "bytes"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
