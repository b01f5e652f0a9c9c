"""The port's train step as one captured program (training/step.py).

On the card a step is a CUDA graph: captured once per step shape and
replayed for every step, so nothing that changes from step to step may be a
Python value inside it. This file imports neither jax nor the JAX package,
so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_step_graph.py -q

- a CPU stand-in for capture: `make_fx` traces the step body once and bakes
  every Python scalar in as a constant, as capture does; the trace's own
  run is undone (a capture runs nothing), and its replays mutate the same
  trainables and optimizer state. make_fx refuses the selective
  remat plans (torch.utils.checkpoint takes it for torch.compile and wants
  dispatch modes from the plan's context_fn), so these runs keep every
  activation; on the card the plans are captured. A tiny SDXL LoRA+TI run traced at
  step 2 and replayed through steps 2-8, across the end of the UNet's LR
  warm-up and the TI freeze, matches the eager run within 1e-6 of each
  tensor's largest value under AdamW, Prodigy and AdamW8bit (the same ops
  on the same values: measured equal), and under AdamW with each option of
  chip_smoke's phase 12 (TE-LoRA across its LR warm-up, int8+te with the
  conditioning recomputed, DoRA);
- the LRs the update reads at the device count the host fills equal the
  schedules at that step (float32 of the float64 value), and the TI
  freeze and the bias corrections equal the host's rules, at every step;
- the bookkeeping, with a stub graph: flash launches counted on the device
  by each replay, the host step mirror, one graph per batch shape, the
  eager reasons;
- `cuda`-marked tests (skipped without a card): the graph step against the
  eager step on the card (losses per step within 1e-3 relative: under
  PyTorch's default algorithms cuDNN's weight gradients and the index
  backward add in a varying order; the generator's state bit-equal;
  the same launch counts), and two buckets' graphs sharing a memory pool,
  replayed in another order than their capture.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch.fx.experimental import proxy_tensor
from torch.fx.experimental.proxy_tensor import make_fx

import chip_smoke
from sd_lora_trainer_tpu_torch.config import TrainingConfig
from sd_lora_trainer_tpu_torch.models import unet as t_unet
from sd_lora_trainer_tpu_torch.models.quant import quantize_frozen
from sd_lora_trainer_tpu_torch.ops import flash_attention as fa
from sd_lora_trainer_tpu_torch.training import optimizers as to
from sd_lora_trainer_tpu_torch.training import step as ts

FX_TOL = 1e-6  # of each tensor's largest value: the replay runs the eager step's ops
CUDA_LOSS_TOL = 1e-3  # relative, graph vs eager on the card (torch's atomic backward ops)

OPTIMIZERS = {"adamw": ("adamw", "adamw"), "prodigy": ("prodigy", "prodigy"),
              "adamw8bit": ("AdamW8bit", "adamw")}


@pytest.fixture(autouse=True)
def _grad_mode_on():
    """Gradients need torch's grad mode, which tests/test_golden_torch.py
    switches off when imported (and pytest-xdist workers import every file)."""
    with torch.enable_grad():
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _no_node_values(val, include_real=False):
    """make_fx's per-node metadata without the fake tensor it makes for each
    real one (a new FakeTensorMode per node: 2/3 of the trace's time); a
    replay reads none of it."""
    if isinstance(val, torch.Tensor) and not proxy_tensor.is_fake(val):
        return None
    return _extract_val(val, include_real)


_extract_val = proxy_tensor.extract_val


class MakeFxGraphs:
    """Capture's stand-in on the CPU: `make_fx` traces the body, which runs
    it, so the trainables, the optimizer state and the generator are set
    back after the trace, as a capture runs nothing; a replay runs the
    trace."""

    def __init__(self, state):
        self.state = state
        self.traces = []

    def supports(self, device):
        return True

    def warmup(self, device):
        return contextlib.nullcontext()

    def capture(self, body, generator, device):
        opt = self.state.optimizer
        kept = opt.params() + list(opt.state_tensors().values())
        saved, drawn = [t.detach().clone() for t in kept], generator.get_state()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(proxy_tensor, "extract_val", _no_node_values)
            gm = make_fx(body)()
        with torch.no_grad():
            for t, s in zip(kept, saved):
                t.copy_(s)
        generator.set_state(drawn)
        self.traces.append(gm)

        def replay():
            with torch.no_grad():  # the trace holds the backward's ops
                return gm()

        return replay

    def reserved_gib(self, device):
        return 0.0


# the tiny SDXL UNet with one transformer layer a block: a third fewer
# ops for make_fx to trace, every kind of layer kept
TRACED_UNET = dataclasses.replace(t_unet.TINY_SDXL_UNET_CONFIG, transformer_layers=(0, 1, 1))


def _tiny_run(device, unet_opt, ti_opt, batch=2, latent=16, dtype=torch.float32, remat=True,
              ucfg=t_unet.TINY_SDXL_UNET_CONFIG, overrides=None):
    """chip_smoke's SDXL LoRA+TI run at the tiny widths: 8 steps, the UNet's
    and TE-LoRA's LR warm-up over 4, TI frozen after half the run, the
    config's `overrides` (chip_smoke.OPTIONS; int8+te quantizes the frozen
    models); `remat=False` keeps every UNet activation."""
    run = chip_smoke._build_run(ucfg, device, dtype, batch=batch, latent_hw=latent, rank=4,
                                fuse=True, overrides=overrides)
    config = dataclasses.replace(run["config"], max_train_steps=8, unet_lr_warmup_steps=4,
                                 txt_encoders_lr_warmup_steps=4,
                                 freeze_ti_after_completion_f=0.5, unet_optimizer_type=unet_opt,
                                 ti_optimizer=ti_opt)
    if config.resolve_quantize_base() == "int8+te":
        quantize_frozen(run["frozen"], "int8+te")
    run = chip_smoke._assemble(config, run["frozen"], run["state"].trainable, run["batch"],
                               run["generator"])
    if not remat:
        run["sc"] = dataclasses.replace(run["sc"], remat=False, stash8="")
    return run


def _batches(run, n, seed=5):
    """n batches like the run's own, with seeded latents and masks."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = dict(run["batch"])
        shape = tuple(b["latent_mean"].shape)
        like = b["latent_mean"]
        b["latent_mean"] = torch.tensor(rng.standard_normal(shape), dtype=like.dtype).to(like.device)
        b["mask"] = torch.tensor(rng.random(shape[:-1] + (1,)) > 0.3, dtype=like.dtype).to(like.device)
        out.append(b)
    return out


def _close(got, want, tol, what):
    scale = want.abs().max().clamp(min=1e-30)
    assert (got.float() - want.float()).abs().max() <= tol * scale, what


@pytest.mark.parametrize("optimizer", sorted(OPTIMIZERS))
def test_traced_step_replays_like_the_eager_step(optimizer):
    """Step 1 eager, step 2 traced (its run undone), steps 2-8 replays of
    the trace with new batches in its static inputs: the losses, the
    trainables and the optimizer state equal the eager run's."""
    _check_replays([_tiny_run("cpu", *OPTIMIZERS[optimizer], remat=False, ucfg=TRACED_UNET)
                    for _ in range(2)])


@pytest.mark.parametrize("option", sorted(chip_smoke.OPTIONS))
def test_traced_option_step_replays_like_the_eager_step(option):
    """As above under AdamW for each option of chip_smoke's phase 12: TE-LoRA
    (a third group whose LR warms up over steps 0-4, both encoders under
    autograd), int8+te (int8 encoders, the conditioning recomputed in the
    backward: torch.utils.checkpoint inside the trace) and DoRA (its norms
    and magnitudes)."""
    runs = [_tiny_run("cpu", "adamw", "adamw", remat=False, ucfg=TRACED_UNET,
                      overrides=chip_smoke.OPTIONS[option]) for _ in range(2)]
    assert runs[0]["sc"].remat_te == (option == "int8_te")
    _check_replays(runs)


def _check_replays(runs):
    """Two identical runs, one eager, one traced and replayed."""
    batches = _batches(runs[0], 8)
    backend = MakeFxGraphs(runs[1]["state"])
    steps = [ts.make_train_step(runs[0]["sc"], capture=False),
             ts.make_train_step(runs[1]["sc"], backend=backend)]
    losses = [[], []]
    for run, step, out in zip(runs, steps, losses):
        for b in batches:
            out.append(step(run["state"], b, run["frozen"]))
    assert steps[0].mode == "eager" and steps[1].mode == "graph"
    assert len(backend.traces) == 1 and len(steps[1].graphs) == 1
    for i, (a, b) in enumerate(zip(*losses)):
        assert sorted(a) == sorted(b)
        for k in a:
            _close(b[k], a[k], FX_TOL, f"step {i + 1} {k}")
    eager, graph = (r["state"] for r in runs)
    assert eager.step == graph.step == 8 and eager.optimizer.count == graph.optimizer.count == 8
    for i, (a, b) in enumerate(zip(eager.optimizer.params(), graph.optimizer.params())):
        _close(b.detach(), a.detach(), FX_TOL, f"trainable {i}")
    sa, sb = eager.optimizer.state_tensors(), graph.optimizer.state_tensors()
    assert sa.keys() == sb.keys()
    for k in sa:
        _close(sb[k].float(), sa[k].float(), FX_TOL, k)
    # the run crossed the TI freeze: the rows stopped at its LR of 0
    assert float(to.ti_lr_schedule(runs[0]["config"])(8)) == 0.0


def test_device_schedules_equal_the_host_schedules():
    """Every group's LR, the TI freeze and AdamW's bias corrections, from
    the device counts the host fills, at every step 0..max_train_steps:
    the LRs as the schedules at the host's step (the update's float32 of
    their float64), the rest as the host's rules."""
    base = dict(lora_training_urls="x", concept_mode="style", sd_model_version="sdxl",
                max_train_steps=20, _testing_no_output_dir=True, unet_lr_warmup_steps=6,
                txt_encoders_lr_warmup_steps=4, freeze_ti_after_completion_f=0.55,
                freeze_unet_before_completion_f=0.1, text_encoder_lora_optimizer="adamw",
                text_encoder_lora_lr=1e-3, ti_lr=2e-3, unet_lr=3e-4)
    for unet_opt in ("adamw", "AdamW8bit"):
        config = TrainingConfig(**base, unet_optimizer_type=unet_opt)
        tree = {"unet": {"w": torch.zeros(4, requires_grad=True)},
                "ti": {"te1": torch.zeros(2, 3, requires_grad=True)},
                "te_lora": {"te1": {"q": torch.zeros(3, requires_grad=True)}}}
        opt = to.GroupOptimizer(config, tree)
        sc = ts.StepConfig.from_config(config, 1.0)
        host = {"unet": to.unet_lr_schedule(config), "ti": to.ti_lr_schedule(config),
                "te_lora": to.te_lora_lr_schedule(config)}
        for n in range(config.max_train_steps + 1):
            opt.count = n
            for g in opt.groups.values():
                g.count = n
            opt.sync()
            lrs = opt.device_lrs()
            assert sorted(lrs) == sorted(host)
            for name, lr in lrs.items():
                want = host[name](n)
                assert lr.dtype == torch.float32 and float(lr) == float(np.float32(want))
            active = ts.ti_active(sc, torch.tensor(n))
            assert float(active) == (0.0 if n / config.max_train_steps > sc.ti_freeze_f else 1.0), n
            # the host's fp32 bias corrections (AdamW8bit's before they moved
            # to the device; the JAX package's): the same bits
            count = torch.tensor(n + 1, dtype=torch.float32)
            for g in opt.groups.values():
                bc1, bc2 = g.bias_corrections()
                assert float(bc1) == float(1.0 - 0.9**count), (n, g.kind)
                assert float(bc2) == float(1.0 - 0.999**count), (n, g.kind)
        assert float(ts.ti_active(sc, 11)) == 1.0 and float(ts.ti_active(sc, 12)) == 0.0


# ---------------------------------------------------------------------------
# Bookkeeping, with a stub graph
# ---------------------------------------------------------------------------


class StubGraphs:
    """Runs the body's Python once per capture with the launch counters
    recording, as a capture does (a launch's device count is recorded, not
    made: set back after); a replay runs the body again with only the device
    counts kept, as a CUDA graph runs its recorded work without Python."""

    def __init__(self):
        self.captured = 0
        self.replayed = 0
        self.recording = False

    def supports(self, device):
        return True

    def warmup(self, device):
        return contextlib.nullcontext()

    def _recorded(self, body):
        self.recording = True
        try:
            return body()
        finally:
            self.recording = False

    def capture(self, body, generator, device):
        self.captured += 1
        held = {k: int(v) for k, v in fa._REPLAYED.items()}
        self._recorded(body)
        for k, v in held.items():
            fa._REPLAYED[k].fill_(v)

        def replay():
            self.replayed += 1
            held = dict(fa.RECORDED)
            out = self._recorded(body)
            fa.RECORDED.update(held)
            return out

        return replay

    def reserved_gib(self, device):
        return 0.0


def _fake_body(sc, state, batch, frozen, step, draws=None):
    """Two flash_fwd and one flash_bwd a step; the loss reads the static
    input and the device step count."""
    for name in ("flash_fwd", "flash_fwd", "flash_bwd"):
        fa.count_launch(name, batch["x"].device)
    return {"loss": batch["x"].sum() + step}


def _stub_state():
    config = TrainingConfig(lora_training_urls="x", concept_mode="style", max_train_steps=10,
                            _testing_no_output_dir=True)
    tree = {"ti": {"te1": torch.zeros(2, 3, requires_grad=True)}}
    return config, ts.TrainState(step=0, trainable=tree, optimizer=to.GroupOptimizer(config, tree),
                                 generator=torch.Generator())


def test_graph_bookkeeping(monkeypatch):
    monkeypatch.setattr(ts, "_step_body", _fake_body)
    config, state = _stub_state()
    sc = ts.StepConfig.from_config(config, 1.0)
    backend = StubGraphs()
    monkeypatch.setattr(fa, "_capturing", lambda: backend.recording)
    step = ts.make_train_step(sc, backend=backend)
    shapes = [(2, 3), (4, 3)]  # two buckets, alternating
    fa.reset_launch_counts()
    losses = []
    for i in range(8):
        x = torch.full(shapes[i % 2], float(i))
        losses.append(float(step(state, {"x": x}, None)["loss"]))
    assert step.mode == "graph" and len(step.graphs) == 2
    # steps 0-1 eager (a key's first), 2-3 captured then replayed, 4-7 replays
    assert backend.captured == 2 and backend.replayed == 6
    assert losses == [i * 6 * (1 + i % 2) + i for i in range(8)]
    assert state.step == 8 and state.optimizer.count == 8
    # the two eager first steps on the host, the 6 replays on the device
    assert fa.LAUNCHES == {"flash_fwd": 4, "flash_bwd": 2}
    assert fa.launch_counts() == {"flash_fwd": 16, "flash_bwd": 8}
    assert [c["launches"] for c in step.captures()] == [{"flash_fwd": 2, "flash_bwd": 1}] * 2
    # the same steps eagerly count the same launches
    _, eager_state = _stub_state()
    eager = ts.make_train_step(sc, capture=False)
    fa.reset_launch_counts()
    for i in range(8):
        eager(eager_state, {"x": torch.full(shapes[i % 2], float(i))}, None)
    assert fa.LAUNCHES == fa.launch_counts() == {"flash_fwd": 16, "flash_bwd": 8}
    assert eager.eager_reason
    # another state is another key
    _, other = _stub_state()
    step(other, {"x": torch.zeros(2, 3)}, None)
    assert len(step.graphs) == 3
    with pytest.raises(ValueError, match="explicit draws"):
        step(state, {"x": torch.zeros(2, 3)}, None, draws=[{}])


@pytest.mark.parametrize("case", ["offload", "parallel", "cpu"])
def test_eager_reasons(case, capsys, monkeypatch):
    monkeypatch.setattr(ts, "_step_body", _fake_body)
    config, state = _stub_state()
    sc = ts.StepConfig.from_config(config, 1.0)
    backend = StubGraphs()
    if case == "offload":
        sc = dataclasses.replace(sc, remat="offload:flash_out*,flash_lse*")
    elif case == "parallel":
        sc = dataclasses.replace(sc, parallel=object())
    else:
        backend = ts.CudaGraphs()  # the real one: no card here
    step = ts.make_train_step(sc, backend=backend)
    step(state, {"x": torch.zeros(2)}, None)
    step(state, {"x": torch.zeros(2)}, None)
    want = {"offload": "offload:", "parallel": "multi-process", "cpu": "cpu"}[case]
    assert step.mode == "eager" and want in step.eager_reason
    err = capsys.readouterr().err
    assert err.count("[step] eager:") == 1 and want in err
    assert state.step == 2 and not step.graphs


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step is captured only there")
    return torch.device("cuda")


def _card_steps(run, step, batches):
    out = []
    for b in batches:
        out.append({k: float(v) for k, v in step(run["state"], b, run["frozen"]).items()})
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", sorted(OPTIMIZERS))
def test_graph_step_matches_eager_on_the_card(cuda_device, optimizer):
    """4 steps eager and as graph (1 eager, 1 captured, 2 replays) from the
    same state: the losses, the generator's state and the flash launches."""
    # latent 32: the second level's self-attention runs at 256 tokens, the
    # flash kernels' gate
    runs = [_tiny_run("cuda", *OPTIMIZERS[optimizer], latent=32) for _ in range(2)]
    batches = _batches(runs[0], 4)
    counts, metrics = [], []
    for run, capture in zip(runs, (False, True)):
        step = ts.make_train_step(run["sc"], capture=capture)
        fa.reset_launch_counts()
        metrics.append(_card_steps(run, step, batches))
        counts.append(fa.launch_counts())
        assert step.mode == ("graph" if capture else "eager")
    assert counts[0] == counts[1] and counts[0]["flash_fwd"] > 0 and counts[0]["flash_bwd"] > 0
    for a, b in zip(*metrics):
        for k in a:
            assert b[k] == pytest.approx(a[k], rel=CUDA_LOSS_TOL, abs=1e-6), k
    assert torch.equal(runs[0]["generator"].get_state(), runs[1]["generator"].get_state())
    assert runs[0]["state"].step == runs[1]["state"].step == 4


@pytest.mark.cuda
def test_bucket_graphs_share_a_pool_in_any_order(cuda_device):
    """Two bucket shapes captured into one pool, then replayed in another
    order than their capture: every step's loss as the eager run's."""
    order = [0, 1, 0, 1, 1, 0, 0, 1]  # capture 0 then 1; later replays 1, 0, 0, 1
    runs = [_tiny_run("cuda", "adamw", "adamw", latent=32) for _ in range(2)]
    small = _batches(runs[0], 4, seed=1)  # 256 and 576 flash tokens
    big = _batches(_tiny_run("cuda", "adamw", "adamw", latent=48), 4, seed=2)
    seq = [(small, big)[o][i // 2] for i, o in enumerate(order)]
    fa.reset_launch_counts()
    got = []
    for run, capture in zip(runs, (False, True)):
        step = ts.make_train_step(run["sc"], capture=capture)
        got.append(_card_steps(run, step, seq))
    assert len(step.graphs) == 2 and fa.launch_counts()["flash_fwd"] > 0
    for a, b in zip(*got):
        assert b["tot_loss"] == pytest.approx(a["tot_loss"], rel=CUDA_LOSS_TOL)
    assert torch.equal(runs[0]["generator"].get_state(), runs[1]["generator"].get_state())
