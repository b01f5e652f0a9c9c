"""The bench's step as one CUDA graph against the eager step, on one card.

    python -m sd_lora_trainer_tpu_torch.scripts.step_modes [--cells sdxl,sd15,sd15_face]
        [--order graph,eager,eager,graph] [--out FILE]

Runs the port's bench (sd_lora_trainer_tpu_torch/bench.py) as a subprocess
for each cell in each mode of `--order` (BENCH_GRAPH=1, then 0, then 0,
then 1 by default: each mode twice, so each mode's run-to-run spread is
seen beside the difference between the modes). Cells:

- sdxl: the bench's defaults, SDXL 1024px bs=8, K=4, remat auto;
- sd15: BENCH_MODEL=sd15 at its defaults, 512px bs=8, no remat;
- sd15_face: the shape of train_configs/training_args_face_sd15.json,
  SD1.5 768px bs=4, rank 16 + TI, remat auto (save:flash_out*,flash_lse*
  on a bf16 base, as that config resolves).

Prints one line per bench run (imgs/s, s/step, the per-step spread, MFU,
busy share, peak GiB) and the card's name and power limit, and writes every
bench JSON line with the mode and cell to `--out` (default
build/step_modes.json).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from sd_lora_trainer_tpu_torch.scripts import ROOT

CELLS = {
    "sdxl": {},
    "sd15": {"BENCH_MODEL": "sd15"},
    "sd15_face": {"BENCH_MODEL": "sd15", "BENCH_RES": "768", "BENCH_BS": "4"},
}
MODES = {"graph": "1", "eager": "0"}


def card() -> str:
    """nvidia-smi's name and power limit of the card, or why it is not known."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def run_bench(cell: str, mode: str, timeout: int) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(PYTHONPATH=ROOT, BENCH_GRAPH=MODES[mode], **CELLS[cell])
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "sd_lora_trainer_tpu_torch.bench"], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=timeout)
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    if proc.returncode != 0 or not lines:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"bench {cell} {mode} exited {proc.returncode}")
    res = json.loads(lines[-1])
    res.update(cell=cell, mode=mode, wall_s=time.perf_counter() - t0,
               capture=[ln for ln in proc.stderr.splitlines() if "step mode" in ln])
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cells", default=",".join(CELLS))
    parser.add_argument("--order", default="graph,eager,eager,graph")
    parser.add_argument("--out", default=os.path.join(ROOT, "build", "step_modes.json"))
    parser.add_argument("--timeout", type=int, default=900, help="seconds per bench run")
    args = parser.parse_args(argv)
    smi = card()
    print(f"[step_modes] card: {smi}", flush=True)
    runs = []
    for cell in args.cells.split(","):
        for mode in args.order.split(","):
            r = run_bench(cell, mode, args.timeout)
            cfg = r["config"]
            secs = cfg.get("per_step_s", [])
            mean = sum(secs) / len(secs) if secs else float("nan")
            spread = (max(secs) - min(secs)) / mean if secs else float("nan")
            print(f"[step_modes] {cell} {mode} ({cfg.get('step_mode')}): {r['value']} imgs/s, "
                  f"{mean:.4f} s/step (per-step spread {spread:.2%}), MFU {r.get('mfu')}, busy "
                  f"{cfg.get('busy_share')}, peak {cfg.get('peak_gib')} GiB, "
                  f"{r['wall_s']:.0f} s; {r['capture']}", flush=True)
            runs.append(r)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": smi, "runs": runs}, f, indent=1)
    print(json.dumps({"card": smi, "out": args.out, "runs": len(runs)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
