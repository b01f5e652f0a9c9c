"""flash_bwd launched again and again on the same inputs, and timed, on one card.

    python -m sd_lora_trainer_tpu_torch.scripts.flash_bwd_repeat [--launches 10] [--rounds 2]
        [--shape 4,10,4096,64 --shape 4,20,1024,64 ...] [--device cuda]

For each shape (B, H, L, d, and optionally the valid length of a ragged
sequence, padded as the UNet pads it: ops/flash_attention.py `_pad_plan`):
q, k, v and dO from a seed (bf16, [B, L, H, d] seen as [B, H, L, d], as the
UNet hands them over), lse and di from the plain forward; then `--launches`
launches of `flash_bwd`, each compared with the first (the largest |difference|
of dq, dk and dv: 0.0 when every launch gives the same bits); then, `--rounds`
times in turn, the device ms of one `flash_bwd` call (the wrapper: its buffers,
the kernel and dq's conversion) and of SDPA's backward on the same inputs
(`torch.autograd.grad` of `F.scaled_dot_product_attention`, timed here as a
yardstick only), each the mean of `--iters` calls queued behind a sleep kernel
so that the host's time to issue them does not count. Prints the card's name
and power limit and one JSON line with every number and each shape's bound:
the larger of its FLOPs (10 B H pairs d: S, dP, dV, dK, dQ over the (query,
key) pairs the segment mask leaves) over the card's bf16 peak and its bytes (q,
k, v, dO, dq, dk, dv in bf16, lse and di in fp32) over its memory rate.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from sd_lora_trainer_tpu_torch.scripts import resolve_device

SHAPES = ("4,10,4096,64", "4,20,1024,64")  # SDXL 1024px bs=4: 10 and 60 calls a UNet pass


def _device_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~25 ms: the calls below queue behind it
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--shape", action="append", default=None,
                        help="B,H,L,d[,valid] (repeatable; default: SDXL's two)")
    parser.add_argument("--launches", type=int, default=10)
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if device.type != "cuda":
        raise SystemExit("flash_bwd_repeat: launches the CUDA kernel; it needs --device cuda")

    import torch.nn.functional as F

    from sd_lora_trainer_tpu_torch.ops import flash_attention as fa
    from sd_lora_trainer_tpu_torch.utils.profiling import (PEAK_BF16_FLOPS, PEAK_BYTES,
                                                           device_description)

    card = device_description(device)
    print(f"[flash_bwd_repeat] card: {card}", flush=True)
    rows = []
    for spec in args.shape or SHAPES:
        b, h, length, d, *rest = (int(x) for x in spec.split(","))
        lp = fa._pad_plan(length)[0]
        valid = rest[0] if rest else (length if lp != length else 0)
        g = torch.Generator(device=device).manual_seed(0)
        q, k, v, do = (torch.randn(b, lp, h, d, generator=g, device=device).bfloat16()
                       .transpose(1, 2) for _ in range(4))
        sc = 1.0 / math.sqrt(d)
        o, lse = fa.flash_fwd_ref(q, k, v, sc, valid)
        di = (o.float() * do.float()).sum(-1).contiguous()
        del o

        def kernel():
            return fa.flash_bwd(q, k, v, do, lse, di, sc, valid)

        first = kernel()
        diff = [0.0, 0.0, 0.0]
        for _ in range(args.launches - 1):
            diff = [max(m, float((x.float() - y.float()).abs().max()))
                    for m, x, y in zip(diff, first, kernel())]
        del first

        mask = fa._attend_mask(lp, valid, device) if valid else None
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, attn_mask=mask, scale=sc)

        def sdpa_bwd():
            return torch.autograd.grad(out, leaves, do, retain_graph=True)

        ms, sdpa_ms = [], []
        for _ in range(args.rounds):
            ms.append(_device_ms(kernel, args.iters))
            sdpa_ms.append(_device_ms(sdpa_bwd, args.iters))
        pairs = valid**2 + (lp - valid) ** 2 if valid else lp**2
        flops = 10 * b * h * pairs * d
        nbytes = 7 * b * h * lp * d * 2 + 2 * b * h * lp * 4
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        row = {"shape": [b, h, lp, d], "valid": valid or lp, "launches": args.launches,
               "max_abs_diff_from_first": dict(zip(("dq", "dk", "dv"), diff)),
               "ms": ms, "sdpa_bwd_ms": sdpa_ms, "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        rows.append(row)
        print(f"[flash_bwd_repeat] [{b},{h},{lp},{d}] valid {valid or lp}: {args.launches} "
              f"launches, max |diff| from the first dq {diff[0]:.3e} dk {diff[1]:.3e} dv "
              f"{diff[2]:.3e}; flash_bwd {[round(x, 4) for x in ms]} ms, SDPA backward "
              f"{[round(x, 4) for x in sdpa_ms]} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})", flush=True)
        del q, k, v, do, lse, di, leaves, out
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "shapes": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
