"""The readings that the check's limits are set from (not run by the
benchmark's own runs).

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,3 [--refs bf16,fp8] [--fault half_batch]

For each seed, in one process: the program's first steps as a run makes
them (set-up's call, no window), the reference at each of `--refs` in the
program's place, then the reference at float32, the judge of them all. One
JSON line per seed and side on stdout: `program` (or the planted fault's
name), `bf16` (a correct computation at the program's precision) and `fp8`
(the control, which the limits have to fail). `--fault half_batch` plants a
fault in the program: every micro-batch loses its second half, the mean
taken over the rest; `--fault half_batch_replay` the same after the first
step only, which on a card is every step that a replay of the captured
graph computes (the first step runs eagerly, the second is captured).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import harness  # noqa: E402


def half_batch(real, after_first: bool = False):
    """compute_loss on the first half of each micro-batch's rows (after
    its first call only, with `after_first`)."""
    calls = [0]

    def half(trainable, frozen, sc, batch, *args, **kw):
        calls[0] += 1
        if not (after_first and calls[0] == 1):
            b = batch["latent_mean"].shape[0]
            batch = {k: (v[: b // 2] if v.ndim and v.shape[0] == b else v) for k, v in batch.items()}
        return real(trainable, frozen, sc, batch, *args, **kw)

    return half


def calibrate_render(args, config, mix, device) -> None:
    """The render's readings: the program's first call, and the reference
    at bf16 and fp8 in its place, each against the reference at float32."""
    from perfbench.traffic import render

    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = render.Renderer(config, mix, seed, device)
        r.call()
        last = r.close()
        t_prog = time.perf_counter() - t
        rows = render.check_rows(mix, seed)
        t = time.perf_counter()
        ref = render.reference_images(config, mix, seed, device, rows, "fp32")
        t_ref = time.perf_counter() - t
        sides = [("program", [render.image_gap(last[i], ref[j]) for j, i in enumerate(rows)])]
        for prec in [p for p in args.refs.split(",") if p]:
            other = render.as_uint8(render.reference_images(config, mix, seed, device, rows, prec))
            sides.append((prec, [render.image_gap(other[j], ref[j]) for j in range(len(rows))]))
        for side, gaps in sides:
            print(json.dumps({"workload": args.workload, "seed": seed, "side": side,
                              "readings": {"image_gap": max(gaps)}, "gaps": gaps, "rows": rows,
                              "program_s": round(t_prog, 2), "reference_s": round(t_ref, 2)}),
                  flush=True)


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--refs", default="bf16,fp8")
    ap.add_argument("--fault", default="", choices=("", "half_batch", "half_batch_replay"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", type=int, default=0)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    _, cell, config, mix = harness.load_cell(args.workload, bool(args.tiny))
    import torch

    from perfbench import check
    from perfbench.traffic import train

    device = torch.device(args.device, 0) if args.device == "cuda" else torch.device("cpu")
    if mix["kind"] == "render":
        calibrate_render(args, config, mix, device)
        return 0
    from sd_lora_trainer_tpu_torch.training import step as step_mod

    real_loss = step_mod.compute_loss
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.fault:  # planted anew for each seed's job
            step_mod.compute_loss = half_batch(real_loss, args.fault == "half_batch_replay")
        t = time.perf_counter()
        loop = train.Loop(config, mix, seed, device)
        loop.first_steps()
        prog, batches, seed_draws, missing = loop.hand_over()
        del loop
        t_prog = time.perf_counter() - t
        sides = [(args.fault or "program", prog)]
        for prec in [p for p in args.refs.split(",") if p]:
            other = check.reference_steps(config, mix, seed, device, batches, seed_draws, prec)
            sides.append((prec, check.as_program(other)))
            del other
            gc.collect()
        t = time.perf_counter()
        ref, readings = check.judged(config, mix, seed, device, batches, seed_draws,
                                     [side for _, side in sides])
        t_ref = time.perf_counter() - t
        worst = check.worst_leaves(prog, ref)
        for (name, side), r in zip(sides, readings):
            print(json.dumps({"workload": args.workload, "seed": seed, "side": name,
                              "readings": r, "losses": side["losses"],
                              "ref_losses": ref["losses"], "lora_sites_missing": missing,
                              "worst": worst if side is prog else None,
                              "program_s": round(t_prog, 2), "reference_s": round(t_ref, 2)}),
                  flush=True)
        del ref, sides, prog
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    harness.log(f"done in {time.perf_counter() - T0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
