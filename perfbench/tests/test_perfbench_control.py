"""The check has to fail what it exists to catch, at the tiny sizes on the
CPU under each cell's own limits (perfbench/limits/):

- the control: the reference at fp8 put in the program's place;
- a run with the timed path broken underneath (the harness's look for a
  card skipped, the rest of the run driven): a step that returns its state
  unchanged, and a step that leaves out half of each batch and takes the
  mean over the rest, in every step or only after the first (on a card,
  the steps that replays of the captured graph compute).

    python -m pytest perfbench/tests -q
"""

import io
import json
from contextlib import redirect_stdout

import pytest
import torch

from perfbench import check, harness
from perfbench.harness import ROOT

TRAIN_CELLS = ["sdxl_style_1024_bs4", "sd15_face_768_bs4"]


def _limits(workload):
    return json.loads((ROOT / f"perfbench/limits/{workload}.json").read_text())["limits"]


@pytest.mark.parametrize("workload", TRAIN_CELLS)
def test_control_fails_the_limits(workload):
    from perfbench.traffic import train

    _, _, config, mix = harness.load_cell(workload, tiny=True)
    dev = torch.device("cpu")
    loop = train.Loop(config, mix, 21, dev)
    loop.first_steps()
    prog, batches, seed_draws, _ = loop.hand_over()
    control = check.as_program(check.reference_steps(config, mix, 21, dev, batches, seed_draws, "fp8"))
    _, (sound, readings) = check.judged(config, mix, 21, dev, batches, seed_draws, [prog, control])
    assert harness.judge(dict(sound, lora_sites=0.0), _limits(workload))[0], sound
    correct, _ = harness.judge(dict(readings, lora_sites=0.0), _limits(workload))
    assert not correct, readings


def _run_broken(workload):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = harness.main(["--workload", workload, "--seed", "9", "--seconds", "1", "--trace",
                           "0", "--device", "cpu", "--tiny", "1"], 0.0)
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("workload", TRAIN_CELLS)
def test_state_left_unchanged_is_not_correct(workload, monkeypatch):
    from sd_lora_trainer_tpu_torch.training import optimizers

    monkeypatch.setattr(optimizers.GroupOptimizer, "update", lambda self: None)
    assert _run_broken(workload)["correct"] is False


@pytest.mark.parametrize("workload", TRAIN_CELLS)
def test_half_batch_is_not_correct(workload, monkeypatch):
    from perfbench import calibrate
    from sd_lora_trainer_tpu_torch.training import step as step_mod

    monkeypatch.setattr(step_mod, "compute_loss", calibrate.half_batch(step_mod.compute_loss))
    assert _run_broken(workload)["correct"] is False


@pytest.mark.parametrize("workload", TRAIN_CELLS)
def test_half_batch_after_the_first_step_is_not_correct(workload, monkeypatch):
    """The fault only where a card's captured graph would compute it: the
    first step whole, every later one on half of its rows."""
    from perfbench import calibrate
    from sd_lora_trainer_tpu_torch.training import step as step_mod

    monkeypatch.setattr(step_mod, "compute_loss",
                        calibrate.half_batch(step_mod.compute_loss, after_first=True))
    assert _run_broken(workload)["correct"] is False


def test_render_control_fails_the_limit():
    from perfbench.traffic import render

    _, _, config, mix = harness.load_cell("sdxl_render_1024_n6", tiny=True)
    dev = torch.device("cpu")
    r = render.Renderer(config, mix, 21, dev)
    r.call()
    last = r.close()
    rows = render.check_rows(mix, 21)
    ref = render.reference_images(config, mix, 21, dev, rows, "fp32")
    limit = _limits("sdxl_render_1024_n6")["image_gap"]
    assert max(render.image_gap(last[i], ref[j]) for j, i in enumerate(rows)) <= limit
    control = render.as_uint8(render.reference_images(config, mix, 21, dev, rows, "fp8"))
    assert max(render.image_gap(control[j], ref[j]) for j in range(len(rows))) > limit


def test_render_answer_altered_is_not_correct(monkeypatch):
    """Each decoded image a few levels off where the program produces it."""
    from sd_lora_trainer_tpu_torch import inference

    real = inference.decode_images

    def altered(pipe, z):
        imgs = real(pipe, z).astype("int16") + 12
        return imgs.clip(0, 255).astype("uint8")

    monkeypatch.setattr(inference, "decode_images", altered)
    assert _run_broken("sdxl_render_1024_n6")["correct"] is False
