"""A traced run's second look at the program: its named spans and phase marks.

The per-layer metrics that read the program's spans and phase marks
(utils/profiling.py in the program) need the program built with them
armed, which the window never is: the timed and traced runs measure the
program as a user runs it. So after the run's check, the first of those
metrics' readers builds the job again, on the same configuration, traffic
and seed, and keeps what it reads in the run's per-layer record; the
others read that. A program without spans and marks (`make_train_step`
without `phases`) is left alone, and the readers give nothing.

- `train`: a `TrainStep` built with `phases=True`; its eager first step
  profiled under `layer_spans()`, each kernel given to its span
  (perfbench/spans.py); its second step captured, with the phase marks in
  the graph; then `REPLAYS` replays, each waited for and its `phase_ms()`
  read, and the mean kept.
- `render`: one render call, profiled, each kernel given to its span.

Both run on the card only: a CPU run gives no device number.
"""

from __future__ import annotations

import gc
import inspect
import sys
import time
from typing import Dict, List, Optional

import torch

from perfbench import spans, yardstick
from perfbench.harness import log

REPLAYS = 8


def _armed_program() -> bool:
    from sd_lora_trainer_tpu_torch.training import step
    from sd_lora_trainer_tpu_torch.utils import profiling

    return ("phases" in inspect.signature(step.make_train_step).parameters
            and hasattr(profiling, "layer_spans"))


def run_seed(argv: Optional[List[str]] = None) -> int:
    """The run's `--seed` (0 where the command line has none)."""
    argv = sys.argv if argv is None else argv
    for i, a in enumerate(argv):
        if a == "--seed" and i + 1 < len(argv):
            return int(argv[i + 1])
        if a.startswith("--seed="):
            return int(a.split("=", 1)[1])
    return 0


def _cached(m: dict, key: str, fn) -> Optional[dict]:
    """`fn(config, mix, seed, device)` once per run, on the card only, and
    only for a program with spans; None where it cannot run or fails."""
    if key not in m:
        m[key] = None
        if m.get("platform") == "gpu" and _armed_program():
            t = time.perf_counter()
            try:
                m[key] = fn(m["config"], m["mix"], run_seed(), torch.device("cuda", 0))
            except Exception as exc:  # a reader gives nothing rather than end the run
                log(f"probe {key} failed: {type(exc).__name__}: {exc}")
            log(f"probe {key} in {time.perf_counter() - t:.1f} s")
            _free(torch.device("cuda", 0))
    return m[key]


def _free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def _profile(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    return profile(activities=acts)


def train_probe(config: dict, mix: dict, seed: int, device: torch.device) -> dict:
    """{"span_s": device seconds of the eager step by owning span,
    "phase_ms": the replays' mean device ms by phase (None off the card),
    "family_s": the same by span and kernel family,
    "armed_replay_s": seconds a replay of the armed graph, back to back,
    "steps_per_call": the job's steps a call}.
    On the CPU, host ops stand in for kernels."""
    from perfbench.traffic.train import Loop, host_tensors
    from sd_lora_trainer_tpu_torch.training.step import make_train_step
    from sd_lora_trainer_tpu_torch.utils import profiling

    _free(device)
    cuda = device.type == "cuda"
    loop = Loop(config, mix, seed, device)
    job = loop.job
    step = make_train_step(job.sc, capture=cuda, phases=True)

    def one():
        step(job.state, host_tensors(loop.pool.draw(loop.batch), loop.pool.scale, cuda),
             job.frozen)

    with profiling.layer_spans(), _profile(device) as prof:
        one()
        loop.sync()
    family = _by_family(list(prof.profiler.kineto_results.events()), cuda)
    del prof
    out = {"span_s": {name: sum(fam.values()) for name, fam in family.items()},
           "family_s": family, "phase_ms": None, "armed_replay_s": None,
           "steps_per_call": loop.k}
    if cuda:
        one()  # the capture, and its first replay
        readings = []
        for _ in range(REPLAYS):
            one()
            readings.append(step.phase_ms())
        out["phase_ms"] = {k: sum(r[k] for r in readings) / len(readings) for k in readings[0]}
        loop.sync()
        t = time.perf_counter()
        for _ in range(REPLAYS):
            one()
        loop.sync()
        out["armed_replay_s"] = (time.perf_counter() - t) / REPLAYS
    del step, job, loop
    _free(device)
    return out


def _by_family(events, cuda: bool) -> Dict[str, Dict[str, float]]:
    """Seconds by owning span and by the frozen kernel family
    (perfbench/yardstick.py): which span owns the elementwise time."""
    out: Dict[str, Dict[str, float]] = {}
    for e, name in spans.owners(events, cpu_ops=not cuda):
        fam = out.setdefault(name, {})
        k = yardstick.kernel_family(e.name())
        fam[k] = fam.get(k, 0.0) + e.duration_ns() / 1e9
    return out


def render_probe(config: dict, mix: dict, seed: int, device: torch.device) -> dict:
    """{"span_s": device seconds of one render call by owning span,
    "host_s": host seconds of each `sdlt.render.*` span of the call}."""
    from perfbench.traffic.render import Renderer

    _free(device)
    r = Renderer(config, mix, seed, device)
    try:
        with _profile(device) as prof:
            r.call()
        events = list(prof.profiler.kineto_results.events())
        del prof
    finally:
        r.close()
    names = {e.name() for e in events if e.name().startswith(spans.PREFIX + "render.")}
    return {"span_s": spans.attribute_events(events, cpu_ops=device.type != "cuda"),
            "host_s": {n: spans.host_seconds(events, n) for n in sorted(names)}}


def train(m: dict) -> Optional[dict]:
    """The train probe of this run (see `train_probe`), logged once."""
    fresh = "probe_train" not in m
    p = _cached(m, "probe_train", train_probe)
    if fresh and p is not None:
        _log_train(m, p)
    return p


def render(m: dict) -> Optional[dict]:
    fresh = "probe_render" not in m
    p = _cached(m, "probe_render", render_probe)
    if fresh and p is not None:
        log("probe render: device ms by span " + _ms(p["span_s"]))
        log("probe render: host ms by span " + _ms(p["host_s"]))
    return p


def _ms(seconds: Dict[str, float]) -> str:
    return ", ".join(f"{k} {1e3 * v:.3f}" for k, v in sorted(seconds.items(), key=lambda kv: -kv[1]))


def _log_train(m: dict, p: dict) -> None:
    """The figures PERF.md compares: the eager step's attributed device
    time and the phases' total against the traced window's busy time a
    step, an armed replay against the window's time a step, and the host
    seconds by phase of set-up's first eager step (`captures()`)."""
    log("probe train: eager step device ms by span " + _ms(p["span_s"]))
    log(f"probe train: eager step device ms in all {1e3 * sum(p['span_s'].values()):.3f}")
    for name, fam in sorted(p["family_s"].items(), key=lambda kv: -sum(kv[1].values())):
        log(f"probe train: {name} device ms by kernel family " + _ms(fam))
    if p["phase_ms"] is not None:
        log("probe train: phase ms a replay " + ", ".join(
            f"{k} {v:.3f}" for k, v in p["phase_ms"].items()))
        log(f"probe train: armed replay s {p['armed_replay_s']:.5f}")
    for c in m.get("captures") or []:
        log(f"probe train: set-up's first eager step {c['warmup_s']:.3f} s, host s by phase "
            + ", ".join(f"{k} {v:.3f}" for k, v in (c.get("warmup_phases_s") or {}).items()))
    trace, batch = m.get("trace"), m["mix"]["batch"]
    if trace is not None:
        steps = m["mix"]["trace_calls"] * p["steps_per_call"]
        log(f"probe train: traced window busy ms a step {1e3 * trace.busy_s() / steps:.3f} "
            f"({steps} steps)")
    if m.get("images"):
        log(f"probe train: window s a step {m['window_s'] * batch / m['images']:.5f}")


def phase_ms(m: dict, name: str) -> Optional[float]:
    p = train(m)
    return None if p is None or p["phase_ms"] is None else p["phase_ms"].get(name)


def span_ms(p: Optional[dict], name: str) -> Optional[float]:
    """Device ms owned by span `name` in a probe, None where it owned none."""
    if p is None or name not in p["span_s"]:
        return None
    return 1e3 * p["span_s"][name]
