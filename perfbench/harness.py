"""The benchmark's harness: one cell, one run.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Reads the cell from BENCHMARK.json, its configuration from the file the
cell's configuration names, its traffic mix from perfbench/traffic/<traffic>.json,
whose `kind` names the module under perfbench/traffic/ that runs it, the
limits of its check from perfbench/limits/<workload>.json, and each per-layer
metric's reader from perfbench/metrics/<metric>.py. It prints the check's
numbers on stderr last, and one JSON line on stdout last.

Exit codes: 0 with a result; 2 without a card (or fewer cards than the
cell asks for); 3 when JAX or the JAX package was loaded; 1 on any other
failure. `--device cpu` and `--tiny 1` (the configuration's and the mix's
tiny sizes) run the whole path on the CPU, for the benchmark's own tests;
no such run gives a device number.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "perfbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "sd_lora_trainer_tpu")
_T0 = time.perf_counter()


def log(*args) -> None:
    print(f"[perfbench +{time.perf_counter() - _T0:.1f}s]", *args, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Outcome:
    """What a traffic kind's run hands back: the end-to-end numbers it
    measured, what the per-layer readers read, the check's readings."""

    measured: Dict[str, float]
    layer: dict
    readings: Dict[str, float]
    attempted: int
    failed: int
    peak_bytes: int
    trace: object = None


@dataclasses.dataclass
class Context:
    workload: str
    seed: int
    seconds: float
    trace: bool
    device: object
    config: dict
    mix: dict
    cell: dict
    t0: float


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def set_cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    cache = ROOT / "build" / "perfbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_cell(workload: str, tiny: bool):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    if tiny:
        config = dict(config, **config["tiny"])
        mix = dict(mix, **mix["tiny"])
    return bench, cell, config, mix


def cell_metrics(bench: dict, workload: str):
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def judge(readings: Dict[str, float], limits: Dict[str, float]):
    checks = {k: {"value": readings.get(k, math.nan), "limit": v} for k, v in limits.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return correct, checks


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--tiny", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse(argv)
    set_cache_dirs()
    bench, cell, config, mix = load_cell(args.workload, bool(args.tiny))
    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            log(f"needs {cell['chips']} CUDA card(s): torch.cuda.is_available() is "
                f"{torch.cuda.is_available()}, {torch.cuda.device_count()} card(s)")
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(min(4, os.cpu_count() or 1))
    limits = json.loads((HERE / "limits" / f"{args.workload}.json").read_text())["limits"]
    ctx = Context(workload=args.workload, seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), device=device, config=config, mix=mix, cell=cell,
                  t0=t0)
    kind = load_module(HERE / "traffic" / f"{mix['kind']}.py", f"perfbench_traffic_{mix['kind']}")
    out: Outcome = kind.run(ctx)
    return report(bench, ctx, out, limits)


def report(bench: dict, ctx: Context, out: Outcome, limits: Dict[str, float]) -> int:
    import torch

    e2e, layer = cell_metrics(bench, ctx.workload)
    metrics = {}
    if ctx.trace:
        for m in layer:
            reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                                 "perfbench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(out.layer)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            log(f"per-layer {m['name']}: {value}")
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": out.measured[m["name"]], "unit": m["unit"]}
    cuda = ctx.device.type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(ctx.device) if cuda else "cpu",
              "count": ctx.cell["chips"], "memory_peak_bytes": int(out.peak_bytes)}
    line = {"correct": None, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device}
    if ctx.trace and out.trace is not None:
        device["busy_s"] = out.trace.busy_s()
        device["window_s"] = out.trace.window_s
        ops = sorted(out.trace.by_name().items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(out.trace.gap_causes().items(), key=lambda kv: -kv[1])[:10]
        line["breakdown"] = {"device_ops": [[n, s] for n, s in ops],
                             "idle_gaps": [[n, s] for n, s in gaps]}
    correct, checks = judge(out.readings, limits)
    line["correct"] = correct and out.failed == 0
    for k, v in out.readings.items():
        if k not in limits:
            log(f"reported, not compared: {k} {v}")
    bad = forbidden_modules()
    if bad:
        log(f"FATAL: modules loaded that the port must not load: {bad}")
        return 3
    line["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0
