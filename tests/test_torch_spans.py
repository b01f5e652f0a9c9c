"""The port's named spans and step phase marks (utils/profiling.py).

On the CPU at the tiny sizes, through CPU profiler runs:

- one eager SDXL step opens the five step phases once each, in order, none
  inside another; `phase_ms()` is None for an unarmed step and on the CPU;
- disarmed, `profiling.layer` is one shared no-op and a UNet forward holds
  no layer span; armed, every norm, LoRA site and int8 dequantization opens
  its span, and remat's recompute opens them again in the backward;
- a step captured through a CPU stand-in for CUDA graphs opens its
  warm-up, capture, fill, replay and clone spans, keeps the host seconds of
  the first step's phases, and records no timing event unarmed;
- the phase marks' device ms by phase, summed over micro-batches, with
  the body's total and the rest;
- a render call opens its merge, encode, denoise, decode and write spans
  once each.
"""

import contextlib
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import chip_smoke
from sd_lora_trainer_tpu_torch.config import TrainingConfig
from sd_lora_trainer_tpu_torch.models import quant
from sd_lora_trainer_tpu_torch.models import unet as t_unet
from sd_lora_trainer_tpu_torch.models.lora import create_lora_params, inject_lora, iter_lora_leaves
from sd_lora_trainer_tpu_torch.training import optimizers as to
from sd_lora_trainer_tpu_torch.training import step as ts
from sd_lora_trainer_tpu_torch.utils import profiling

PHASES = ["sdlt.step." + p for p in profiling.STEP_PHASES]


@pytest.fixture(autouse=True)
def _grad_mode_on():
    """Gradients need torch's grad mode, which tests/test_golden_torch.py
    switches off when imported (and pytest-xdist workers import every file)."""
    with torch.enable_grad():
        yield


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _events(prof):
    """(name, start ns, end ns) of the run's host ops and ranges."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CPU]


def _named(events, name):
    return sorted((s, e) for n, s, e in events if n == name)


def _inside(t, spans):
    return any(s <= t[0] and t[1] <= e for s, e in spans)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _events(prof)


def _tiny_run():
    return chip_smoke._build_run(t_unet.TINY_SDXL_UNET_CONFIG, "cpu", torch.float32, batch=2,
                                 latent_hw=16, rank=4, fuse=True)


def test_eager_step_opens_the_five_phases_in_order():
    run = _tiny_run()
    step = ts.make_train_step(run["sc"], capture=False)
    _, events = _profiled(lambda: step(run["state"], run["batch"], run["frozen"]))
    found = [(s, e, n) for n, s, e in events if n in PHASES]
    assert sorted(n for _, _, n in found) == sorted(PHASES)  # once each
    found.sort()
    assert [n for _, _, n in found] == PHASES
    for (_, end, _), (start, _, _) in zip(found, found[1:]):
        assert end <= start  # none inside another
    groups = {n for n, _, _ in events if n.startswith("sdlt.step.update.")}
    assert groups == {"sdlt.step.update.unet", "sdlt.step.update.ti"}
    assert all(_inside(g, _named(events, "sdlt.step.update"))
               for n in groups for g in _named(events, n))


def test_phase_ms_is_none_unarmed_and_on_the_cpu():
    run = _tiny_run()
    for phases in (False, True):
        step = ts.make_train_step(run["sc"], capture=False, phases=phases)
        step(run["state"], run["batch"], run["frozen"])
        assert step.phase_ms() is None
        assert set(step._last_marks.host_s) >= set(profiling.STEP_PHASES)


def _tiny_unet(quantized: bool):
    gen = torch.Generator().manual_seed(0)
    cfg = t_unet.TINY_SDXL_UNET_CONFIG
    base = t_unet.init_unet_params(cfg, gen, dtype=torch.float32, device="cpu")
    lora = create_lora_params(base, 2, gen)
    if quantized:
        base = quant.quantize_base_weights(base)
    b = 2
    args = (torch.randn(b, 8, 8, 4, generator=gen), torch.tensor([10, 500]),
            torch.randn(b, 77, cfg.cross_attention_dim, generator=gen), cfg)
    added = {"text_embeds": torch.randn(b, cfg.addition_pooled_dim, generator=gen),
             "time_ids": torch.randn(b, 6, generator=gen)}
    return inject_lora(base, lora), lora, args, added


def test_layer_spans_disarmed_are_one_shared_no_op():
    assert profiling.layer("norm") is profiling.layer("lora") is profiling.layer("dequant")
    with profiling.layer_spans():
        armed = profiling.layer("norm")
    assert armed is not profiling.layer("norm")
    params, _, args, added = _tiny_unet(quantized=True)
    with torch.no_grad():
        _, events = _profiled(lambda: t_unet.unet_forward(params, *args, added_cond=added,
                                                          remat=False))
    assert not [n for n, _, _ in events if n.startswith("sdlt.layer.")]
    assert not [n for n, _, _ in events if n.startswith("sdlt.")]


@pytest.mark.parametrize("remat", [False, True])
def test_armed_layer_spans_cover_every_call_and_remat(remat, monkeypatch):
    params, lora, args, added = _tiny_unet(quantized=True)
    calls = []
    real_to = quant.QTensor.to

    def counted_to(self, target):
        if isinstance(target, torch.dtype):
            calls.append(target)
        return real_to(self, target)

    monkeypatch.setattr(quant.QTensor, "to", counted_to)

    def fwd_bwd():
        out, _ = t_unet.unet_forward(params, *args, added_cond=added, remat=remat)
        forward_calls = len(calls)
        with record_function("test.backward"):
            out.float().pow(2).mean().backward()
        return forward_calls

    with profiling.layer_spans():
        forward_calls, events = _profiled(fwd_bwd)
    backward = _named(events, "test.backward")
    norm, lora_spans = _named(events, "sdlt.layer.norm"), _named(events, "sdlt.layer.lora")
    dequant = _named(events, "sdlt.layer.dequant")
    # every norm op (group_norm's var_mean, layer_norm's) inside a norm span
    norm_ops = [(s, e) for n, s, e in events if n in ("aten::var_mean", "aten::layer_norm")]
    assert norm_ops and all(_inside(op, norm) for op in norm_ops)
    assert len(norm) == len(norm_ops)
    # every adapter site once in the forward
    sites = len(list(iter_lora_leaves(lora)))
    forward_lora = [sp for sp in lora_spans if not _inside(sp, backward)]
    assert len(forward_lora) == sites
    assert len(dequant) == len(calls) and forward_calls > 0
    # remat's recompute opens them again inside the backward
    again = [sp for sp in norm + lora_spans + dequant if _inside(sp, backward)]
    assert bool(again) == remat
    if remat:
        assert len([sp for sp in lora_spans if _inside(sp, backward)]) > 0
        assert len(dequant) > forward_calls


class _StubGraphs:
    """A CPU stand-in for CudaGraphs: a capture runs the body's Python once,
    and each replay runs it again."""

    def __init__(self):
        self.replays = 0

    def supports(self, device):
        return True

    def warmup(self, device):
        return contextlib.nullcontext()

    def capture(self, body, generator, device):
        body()

        def replay():
            self.replays += 1
            return body()

        return replay

    def reserved_gib(self, device):
        return 0.0


def _phase_body(sc, state, batch, frozen, step, draws=None):
    """Every phase once, the way the step's body opens them."""
    for name in profiling.STEP_PHASES:
        with profiling.phase(name):
            pass
    return {"loss": batch["x"].sum() + step}


def _stub_step(monkeypatch, phases):
    monkeypatch.setattr(ts, "_step_body", _phase_body)
    config = TrainingConfig(lora_training_urls="x", concept_mode="style", max_train_steps=10,
                            _testing_no_output_dir=True)
    tree = {"ti": {"te1": torch.zeros(2, 3, requires_grad=True)}}
    state = ts.TrainState(step=0, trainable=tree, optimizer=to.GroupOptimizer(config, tree),
                          generator=torch.Generator())
    backend = _StubGraphs()
    step = ts.make_train_step(ts.StepConfig.from_config(config, 1.0), backend=backend,
                              phases=phases)
    return step, state, backend


def test_stub_capture_unarmed_records_no_event(monkeypatch):
    made = []
    monkeypatch.setattr(profiling, "timing_event", lambda: made.append(1))
    step, state, backend = _stub_step(monkeypatch, phases=False)
    for i in range(4):
        step(state, {"x": torch.full((2, 3), float(i))}, None)
    assert step.mode == "graph" and backend.replays == 3
    assert made == [] and step.phase_ms() is None


def test_stub_replays_open_fill_replay_and_clone(monkeypatch):
    step, state, backend = _stub_step(monkeypatch, phases=False)
    step(state, {"x": torch.zeros(2, 3)}, None)  # the eager first step
    (caps, events) = _profiled(lambda: [step(state, {"x": torch.full((2, 3), float(i))}, None)
                                        for i in range(3)])
    count = {n: len(_named(events, "sdlt.step." + n))
             for n in ("warmup", "capture", "fill", "replay", "clone")}
    assert count == {"warmup": 0, "capture": 1, "fill": 3, "replay": 3, "clone": 3}
    # the stub's replay runs the body's Python, inside the replay span
    replays = _named(events, "sdlt.step.replay")
    assert all(_inside(sp, replays) for sp in _named(events, "sdlt.step.loss")[1:])
    (cap,) = step.captures()
    assert set(cap["warmup_phases_s"]) == set(profiling.STEP_PHASES) | {"total"}
    assert all(v >= 0.0 for v in cap["warmup_phases_s"].values())
    assert state.step == 4


class _FakeEvent:
    """A timing event whose record() reads a fake device clock."""

    clock = [0.0]

    def record(self):
        self.t = self.clock[0]
        self.clock[0] += 1.0

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


def test_phase_marks_sum_micro_batches_with_total_and_other(monkeypatch):
    monkeypatch.setattr(profiling, "timing_event", _FakeEvent)
    _FakeEvent.clock = [0.0]
    marks = profiling.PhaseMarks(device=True)
    with profiling.marking(marks):  # total: opened at t=0
        for _ in range(2):  # two micro-batches
            for name in profiling.STEP_PHASES[:4]:
                with profiling.phase(name):  # each phase spans one tick
                    pass
        with profiling.phase("update"):
            with profiling.phase("update.unet"):
                pass
    ms = marks.ms()
    assert {k: ms[k] for k in profiling.STEP_PHASES[:4]} == dict.fromkeys(
        profiling.STEP_PHASES[:4], 2.0)
    assert ms["update.unet"] == 1.0 and ms["update"] == 3.0
    assert ms["total"] == 21.0  # the events recorded after the body's first
    assert ms["other"] == ms["total"] - 8.0 - 3.0
    assert profiling.PhaseMarks(device=False).ms() is None


def test_render_opens_its_spans_once_each_a_call(tmp_path):
    from sd_lora_trainer_tpu_torch import inference
    from sd_lora_trainer_tpu_torch.diffusion.schedulers import DDPMSchedule
    from sd_lora_trainer_tpu_torch.models import synthesize as syn
    from sd_lora_trainer_tpu_torch.models import tokenizer as tt
    from sd_lora_trainer_tpu_torch.models import weights as tw

    path = str(tmp_path / "tiny.safetensors")
    syn.synthesize_checkpoint(path, "sdxl", t_unet.TINY_SDXL_UNET_CONFIG, syn.TINY_VAE_CONFIG,
                              syn.TINY_CLIP_L_CONFIG, syn.TINY_CLIP_G_CONFIG, seed=5, device="cpu")
    m = tw.load_models_from_checkpoint(path, dtype=torch.float32, device="cpu")
    vocab, merges = tt.build_sized_test_vocab(256, extra_words=["photo", "style", "the"])
    pipe = inference.InferencePipeline(
        version="sdxl", unet_params=m.unet, unet_config=m.unet_config,
        te1_params=m.text_encoder, te1_config=m.text_encoder_config,
        te2_params=m.text_encoder_2, te2_config=m.text_encoder_2_config, vae_params=m.vae,
        vae_config=m.vae_config, tokenizer_1=tt.CLIPTokenizer(vocab, merges),
        tokenizer_2=tt.CLIPTokenizer(vocab, merges, pad_token_id=0),
        schedule=DDPMSchedule.create(device="cpu"))
    (tmp_path / "special_params.json").write_text(json.dumps({"TOK": "<s0>"}))
    (tmp_path / "training_args.json").write_text(json.dumps(
        {"name": "tiny", "concept_mode": "style", "training_attributes": {"trigger_text": "TOK"}}))
    lora = create_lora_params(m.unet, 2, torch.Generator().manual_seed(0))

    def two_calls():
        for i in range(2):
            inference.render_images(pipe, render_size=(64, 64), lora_path=str(tmp_path),
                                    train_step=i, seed=3, n_steps=2, n_imgs=2, unet_lora=lora)

    _, events = _profiled(two_calls)
    found = {n: len(_named(events, "sdlt.render." + n))
             for n in ("merge", "encode", "denoise", "decode", "write")}
    assert found == dict.fromkeys(found, 2)
    assert len(list(tmp_path.glob("img_*.jpg"))) == 4
    order = sorted((s, n) for n, s, _ in events if n.startswith("sdlt.render."))[:5]
    assert [n for _, n in order] == ["sdlt.render." + n
                                     for n in ("merge", "encode", "denoise", "decode", "write")]
