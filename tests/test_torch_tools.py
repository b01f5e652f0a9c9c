"""The port's tools (sd_lora_trainer_tpu_torch/scripts/) on the CPU, tiny.

- `profile_step`: traces tiny bench steps and prints the family table from
  the live profiler; `--summarize` reads the same from the exported trace;
- `convergence_run --device cpu` over a few steps writes a report with
  every key of the JAX run's committed convergence/convergence_report.json,
  and its dataset is the JAX script's, byte for byte;
- `real_weights_check --synthesize tiny --steps 2 --device cpu` ends with
  REAL-WEIGHTS CHECK PASSED, on the JAX script's dataset;
- `render_checkpoint` writes a grid per LoRA scale from that checkpoint;
- `auto_eval_model` writes the JAX script's not-staged report, and with a
  stand-in scorer the port's CLIP metrics equal the JAX script's;
- `bench_inference --tiny --device cpu` prints its one JSON line;
- each tool that runs a model (all but profile_step, which reads the
  bench's `BENCH_PLATFORM`) exits 1 without a card unless given `--device
  cpu`, and does not fall back to the CPU.
"""

import filecmp
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))  # the JAX package's scripts

import auto_eval_model as j_eval  # noqa: E402
import convergence_run as j_conv  # noqa: E402

from sd_lora_trainer_tpu_torch.scripts import (  # noqa: E402
    auto_eval_model, bench_inference, convergence_run, profile_step, real_weights_check,
    render_checkpoint)


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


def _last_json(text: str) -> dict:
    return json.loads([ln for ln in text.splitlines() if ln.strip()][-1])


def test_profile_step_tables_agree(tmp_path, monkeypatch, capsys):
    for k, v in {"BENCH_TINY": "1", "BENCH_PLATFORM": "cpu", "BENCH_RES": "64",
                 "BENCH_BS": "1"}.items():
        monkeypatch.setenv(k, v)
    assert profile_step.main(["--steps", "1", "--out", str(tmp_path)]) == 0
    live = _last_json(capsys.readouterr().out)
    assert live["steps"] == 1 and os.path.isfile(live["trace"])
    assert profile_step.main(["--summarize", str(tmp_path)]) == 0
    read = _last_json(capsys.readouterr().out)
    assert read["trace"] == live["trace"]
    assert read["family_ms"] == live["family_ms"] and read["kernels"] == live["kernels"] == 0


def test_profile_step_summarize(tmp_path, capsys):
    from sd_lora_trainer_tpu_torch.utils.profiling import trace_steps

    with trace_steps(str(tmp_path)):
        torch.randn(32, 32) @ torch.randn(32, 32)
    assert profile_step.main(["--summarize", str(tmp_path)]) == 0
    out = _last_json(capsys.readouterr().out)
    assert out["trace"] == str(tmp_path / "profile" / "trace.json")
    assert out["kernels"] == 0 and set(out["family_ms"]) == {"flash", "conv", "gemm", "other"}
    with pytest.raises(SystemExit, match="no trace"):
        profile_step.main(["--summarize", str(tmp_path / "missing")])


def test_convergence_dataset_is_the_jax_scripts(tmp_path):
    j_conv.make_structured_dataset(str(tmp_path / "j"), n=3, size=64, seed=5)
    convergence_run.make_structured_dataset(str(tmp_path / "t"), n=3, size=64, seed=5)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == 6
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "j", tmp_path / "t", names, shallow=False)
    assert not mismatch and not errors


def test_convergence_run_report(tmp_path, capsys):
    out = tmp_path / "out"
    rc = convergence_run.main(["--steps", "3", "--checkpointing-steps", "100", "--resolution",
                               "64", "--device", "cpu", "--out", str(out)])
    assert rc in (0, 1)  # 1: the loss did not fall in 3 steps (a warning, as in JAX)
    with open(out / "convergence_report.json") as f:
        report = json.load(f)
    with open(os.path.join(REPO, "convergence", "convergence_report.json")) as f:
        jax_report = json.load(f)
    assert set(jax_report) <= set(report), sorted(set(jax_report) - set(report))
    assert report["steps"] == 3 and report["resolution"] == 64
    assert report["quality_proxy"]["metric"] == "x0_latent_mse_train"
    assert list(report["held_out_trend"]["per_checkpoint"]) == ["3"]  # the final save
    assert all(np.isfinite(v) for v in report["quality_proxy"]["per_checkpoint"].values())
    assert (out / "validation_grid.jpg").exists()
    assert '"loss_drop_pct"' in capsys.readouterr().out


@pytest.fixture(scope="module")
def checked(tmp_path_factory):
    """One `real_weights_check --synthesize tiny` run: (its root, stdout)."""
    root = tmp_path_factory.mktemp("rw")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.enable_grad():
            import contextlib
            import io

            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = real_weights_check.main(["--synthesize", "tiny", "--steps", "2", "--device",
                                              "cpu", "--out", str(root)])
    finally:
        torch.set_num_threads(n)
    assert rc == 0
    return root, buf.getvalue()


def _save_dir(root):
    runs = root / "runs"
    (run,) = os.listdir(runs)
    ckpts = runs / run / "checkpoints"
    (ckpt,) = [d for d in os.listdir(ckpts) if d.startswith("checkpoint-")]
    return ckpts / ckpt


def test_real_weights_check_passes(checked, tmp_path):
    root, stdout = checked
    assert stdout.rstrip().splitlines()[-1] == "REAL-WEIGHTS CHECK PASSED"
    assert "DEGRADED: CLIP scorer not staged" in stdout
    assert os.path.exists(root / "synth_sdxl_tiny.safetensors")
    import real_weights_check as j_rw  # the JAX script's dataset, byte for byte

    j_dir = j_rw.make_dataset(str(tmp_path))
    names = sorted(os.listdir(j_dir))
    assert names == sorted(os.listdir(root / "dataset"))
    assert not filecmp.cmpfiles(j_dir, root / "dataset", names, shallow=False)[1]


def test_render_checkpoint_writes_a_grid_per_scale(checked):
    root, _ = checked
    save_dir = _save_dir(root)
    rc = render_checkpoint.main([str(save_dir), "--base_checkpoint",
                                 str(root / "synth_sdxl_tiny.safetensors"), "--lora_scales",
                                 "0.5,1.0", "--n_imgs", "2", "--render_size", "64", "--device",
                                 "cpu"])
    assert rc == 0
    for scale in ("0.50", "1.00"):
        files = os.listdir(save_dir / f"scale_{scale}")
        assert "validation_grid.jpg" in files
        assert sorted(f for f in files if f.startswith("img_")) == ["img_0000_0.jpg",
                                                                     "img_0000_1.jpg"]


def test_auto_eval_model_without_a_scorer(checked, tmp_path):
    root, _ = checked
    save_dir = _save_dir(root)
    out = tmp_path / "eval.json"
    assert auto_eval_model.main([str(save_dir), "--output", str(out), "--device", "cpu"]) == 0
    report = json.loads(out.read_text())
    want_out = tmp_path / "jax_eval.json"
    sys_argv = sys.argv
    try:
        sys.argv = ["auto_eval_model.py", str(save_dir), "--output", str(want_out)]
        j_eval.main()
    finally:
        sys.argv = sys_argv
    assert report == json.loads(want_out.read_text())
    assert report["error"].startswith("CLIP scorer weights not staged") and report["n_images"] == 2


class _FakeScorer:
    """A stand-in CLIP: features are fixed functions of the pixels and the text."""

    def get_image_features(self, pixel_values):
        return pixel_values.reshape(pixel_values.shape[0], -1)[:, :8].float() + 1.0

    def get_text_features(self, input_ids, **kwargs):
        return torch.stack([torch.arange(8).float() * (1 + len(t)) for t in input_ids])


def _fake_processor(images=None, text=None, **kwargs):
    if images is not None:
        arr = np.asarray(images, np.float32)[:4, :4].reshape(1, -1) / 255.0
        return {"pixel_values": torch.from_numpy(arr)}
    return {"input_ids": [t.split() for t in text]}


def test_clip_metrics_equal_the_jax_scripts(checked, monkeypatch):
    root, _ = checked
    save_dir = _save_dir(root)
    imgs = sorted(str(save_dir / f) for f in os.listdir(save_dir) if f.startswith("img_"))
    train = auto_eval_model.get_all_jpg_filenames(str(root / "dataset"))
    results = []
    for mod, args in ((auto_eval_model, (torch.device("cpu"),)), (j_eval, ())):
        monkeypatch.setattr(mod, "_load_clip_scorer", lambda *a: (_FakeScorer(), _fake_processor))
        ev = mod.Evaluation(imgs, *args)
        assert ev.available
        results.append((ev.clip_diversity(), ev.image_text_alignment(["a b", "a b c"]),
                        ev.training_image_alignment(train)))
    np.testing.assert_allclose(results[0], results[1], rtol=1e-6)


def test_bench_inference_tiny(capsys):
    rc = bench_inference.main(["--tiny", "--device", "cpu", "--res", "64", "--steps", "2",
                               "--batch", "2", "--images", "2"])
    assert rc == 0
    out = _last_json(capsys.readouterr().out)
    assert out["metric"] == "sdxl_render_seconds_per_image_64px_2steps_batch2"
    assert out["unit"] == "s/img" and out["value"] > 0 and out["vs_baseline"] is None
    assert out["config"]["launches_per_call"] == {"flash_fwd": 0, "flash_bwd": 0}


@pytest.mark.parametrize("module,args", [
    ("bench_inference", []),
    ("convergence_run", ["--steps", "1"]),
    ("real_weights_check", ["--synthesize", "tiny"]),
    ("render_checkpoint", [".", "--base_checkpoint", "x.safetensors"]),
    ("auto_eval_model", ["."]),
])
def test_tools_refuse_without_a_card(module, args):
    env = {**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": ""}
    r = subprocess.run([sys.executable, "-m", f"sd_lora_trainer_tpu_torch.scripts.{module}",
                        *args], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 1 and "no CUDA device" in r.stderr, r.stderr[-2000:]
    assert r.stdout.strip() == ""
