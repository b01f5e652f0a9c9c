"""Trace the bench's train step with torch.profiler and print its device time.

    python -m sd_lora_trainer_tpu_torch.scripts.profile_step [--steps 2] [--out DIR]
    python -m sd_lora_trainer_tpu_torch.scripts.profile_step --summarize DIR_OR_TRACE

Counterpart of the JAX package's scripts/profile_step.py. It builds the
bench's run from the same BENCH_* knobs (sd_lora_trainer_tpu_torch/bench.py),
takes two warm-up steps (the eager first step and the capture: on the card
the step is one CUDA graph, training/step.py), then traces `--steps`
steps, replays of the graph as the trainer runs them (the profiler reports
the kernels inside a graph), with
`utils.profiling.trace_steps`, which writes a Chrome trace to
`DIR/profile/trace.json` (DIR defaults to build/profile_step). It prints the
device time by kernel family (flash, GEMM, conv, other), the flash kernels
and the top kernels from the live profiler, and each flash wrapper's
launches a step, counted and as the trace shows them; the last line of
stdout is one JSON object with the family totals, those launches and the
trace's path. `--summarize`
prints the same table and JSON read from an exported trace (a file, or a
directory holding profile/trace.json), the counterpart of the JAX
script's xplane parser.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

from sd_lora_trainer_tpu_torch.scripts import ROOT


def trace_path(where: str) -> str:
    if os.path.isfile(where):
        return where
    for candidate in (os.path.join(where, "profile", "trace.json"),
                      os.path.join(where, "trace.json")):
        if os.path.isfile(candidate):
            return candidate
    raise SystemExit(f"no trace under {where} (expected profile/trace.json)")


def summarize(where: str) -> dict:
    from sd_lora_trainer_tpu_torch.utils.profiling import device_time_table, trace_kernels

    path = trace_path(where)
    table = device_time_table(trace_kernels(path))
    for line in table.lines("[trace]"):
        print(line)
    return {"trace": path, "kernels": table.kernels, "device_s": table.device_s,
            "family_ms": table.family_ms}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=2, help="steps traced after one warm-up step")
    parser.add_argument("--out", default=os.path.join(ROOT, "build", "profile_step"))
    parser.add_argument("--summarize", metavar="DIR_OR_TRACE", default=None,
                        help="only read an exported trace")
    args = parser.parse_args(argv)
    if args.summarize:
        print(json.dumps(summarize(args.summarize)))
        return 0

    from sd_lora_trainer_tpu_torch import bench
    from sd_lora_trainer_tpu_torch.ops import flash_attention as fa
    from sd_lora_trainer_tpu_torch.training.step import make_train_step
    from sd_lora_trainer_tpu_torch.utils import profiling

    try:
        levers = bench.Levers.from_env()
    except bench.BenchError as e:
        raise SystemExit(f"profile_step: {e}")
    levers = dataclasses.replace(levers, buckets=[])
    run = bench.setup(levers)
    latent = levers.resolution // 8
    batch = run.batch(latent, latent, np.random.RandomState(0))
    step = make_train_step(run.sc)
    for _ in range(2):  # the eager first step, then the capture
        step(run.state, batch, run.frozen)
    bench.log_step_mode(step)
    profiling.synchronize(levers.device)
    before = fa.launch_counts()
    with profiling.trace_steps(args.out) as prof:
        for _ in range(args.steps):
            step(run.state, batch, run.frozen)
    now = fa.launch_counts()
    launches = {k: (now[k] - before[k]) / args.steps for k in now}
    live = profiling.device_time_table(profiling.device_kernels(prof))
    traced = {k: n / args.steps for k, n in live.flash_launches.items()}
    print(f"[profile] {args.steps} traced steps of {levers.model} bs={levers.batch_size} "
          f"{levers.resolution}px, remat {run.sc.remat!r}; flash launches per step {launches}, "
          f"in the trace {traced}")
    for line in live.lines("[profile]"):
        print(line)
    print(json.dumps({"steps": args.steps, "launches_per_step": launches,
                      "traced_launches_per_step": traced,
                      "trace": trace_path(args.out), "kernels": live.kernels,
                      "device_s": live.device_s, "family_ms": live.family_ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
