"""The port's cog and ComfyUI front-ends against the root ones (the JAX package's).

- the port's node has the root node's INPUT_TYPES, RETURN_TYPES,
  RETURN_NAMES, FUNCTION and CATEGORY, and its comfyui_init exports both
  mappings of the port's node;
- a tiny CPU `Predictor.predict` streams progress and ends with a tar of
  the final checkpoint holding the JAX package's artifact set; a tiny
  `train_lora` redirects the model paths into ComfyUI's folders, drives
  the ProgressBar and returns the grid stack as a torch tensor with the
  LoRA and embedding paths. The config each front-end builds is patched
  with a tiny synthetic checkpoint and the CPU, as tests/test_torch_main.py's
  `env` fixture makes them.
"""

import importlib.util
import os
import sys
import tarfile
import types

import numpy as np
import pytest
import torch
from PIL import Image

from sd_lora_trainer_tpu_torch import comfyui_init, node, predict
from sd_lora_trainer_tpu_torch.config import TrainingConfig, model_paths
from sd_lora_trainer_tpu_torch.models import synthesize as ts
from sd_lora_trainer_tpu_torch.models.unet import TINY_SDXL_UNET_CONFIG

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _root_module(name):
    spec = importlib.util.spec_from_file_location(f"root_{name}", os.path.join(ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_node_schema_is_the_root_nodes():
    ours, root = node.Eden_LoRa_trainer, _root_module("node").Eden_LoRa_trainer
    assert ours.INPUT_TYPES() == root.INPUT_TYPES()
    for attr in ("RETURN_TYPES", "RETURN_NAMES", "FUNCTION", "CATEGORY"):
        assert getattr(ours, attr) == getattr(root, attr), attr
    assert callable(getattr(ours, ours.FUNCTION))
    assert comfyui_init.NODE_CLASS_MAPPINGS is node.NODE_CLASS_MAPPINGS
    assert comfyui_init.NODE_DISPLAY_NAME_MAPPINGS is node.NODE_DISPLAY_NAME_MAPPINGS
    assert set(comfyui_init.__all__) == {"NODE_CLASS_MAPPINGS", "NODE_DISPLAY_NAME_MAPPINGS"}
    assert comfyui_init.NODE_CLASS_MAPPINGS["Eden_LoRa_trainer"] is ours


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("frontends")
    ckpt = str(root / "tiny.safetensors")
    ts.synthesize_checkpoint(ckpt, "sdxl", TINY_SDXL_UNET_CONFIG, ts.TINY_VAE_CONFIG,
                             ts.TINY_CLIP_L_CONFIG, ts.TINY_CLIP_G_CONFIG, seed=0, device="cpu")
    rs = np.random.RandomState(0)
    data = root / "data"
    data.mkdir()
    for i in range(4):
        Image.fromarray(rs.randint(0, 255, (64, 64, 3), dtype=np.uint8)).save(data / f"{i}.png")
        (data / f"{i}.txt").write_text(f"a photo of a thing number {i}")
    return {"root": root, "ckpt": ckpt, "data": str(data)}


def _tiny_config(monkeypatch, module, env, out):
    """Patch the module's TrainingConfig: the front-end's own fields, plus
    the tiny checkpoint, the CPU and an offline data path."""
    tiny = dict(ckpt_path=env["ckpt"], device="cpu", weight_type="fp32",
                caption_model="no_caption", skip_gpt_cleanup=True, augment_imgs_up_to_n=0,
                validation_img_size=64, n_sample_imgs=1, output_dir=str(out))
    built = []

    def make(**kw):
        built.append(TrainingConfig(**{**kw, **tiny}))
        return built[-1]

    monkeypatch.setattr(module, "TrainingConfig", make)
    return built


# the artifacts of one checkpoint, under the JAX package's names
# (tests/test_torch_main.py holds them against its save_checkpoint)
def _artifacts(name, step):
    return sorted([f"{name}_sdxl_lora.safetensors", f"{name}_sdxl_embeddings.safetensors",
                   "special_params.json", "training_args.json", "validation_grid.jpg",
                   f"img_{step:04d}_0.jpg"])


def test_predict_streams_progress_and_tars_the_artifacts(env, monkeypatch):
    built = _tiny_config(monkeypatch, predict, env, env["root"] / "cog")
    outs = list(predict.Predictor().predict(
        name="cogrun", lora_training_urls=env["data"], concept_mode="style",
        sd_model_version="sdxl", max_train_steps=2, checkpointing_steps=10000, resolution=64,
        unet_lr=3e-4, ti_lr=1e-3, lora_rank=4, n_tokens=3, train_batch_size=2, n_sample_imgs=1,
        validation_img_size=64, sample_imgs_lora_scale=None, seed=0))
    assert len(built) == 1 and built[0].lora_rank == 4 and built[0].max_train_steps == 2
    assert outs[0].progress == 0.0 and not outs[0].isFinal
    steps = [o.progress for o in outs[1:-1]]
    assert steps and steps == sorted(steps) and all(0 < p <= 1 for p in steps)
    final = outs[-1]
    assert final.isFinal and final.progress == 1.0 and final.name == "cogrun"
    assert "validation_prompts" in final.attributes and "final_losses" in final.attributes
    (tarball,) = final.files
    with tarfile.open(str(tarball)) as tar:
        names = sorted(os.path.basename(m.name) for m in tar.getmembers() if m.isfile())
    assert names == _artifacts("cogrun", 2)


def test_train_lora_returns_the_grid_and_paths(env, monkeypatch):
    built = _tiny_config(monkeypatch, node, env, env["root"] / "comfy")
    models_dir = str(env["root"] / "comfy_models")
    monkeypatch.setitem(sys.modules, "folder_paths", types.SimpleNamespace(models_dir=models_dir))
    updates = []

    class ProgressBar:
        def __init__(self, total):
            assert total == 100

        def update_absolute(self, value):
            updates.append(value)

    comfy = types.ModuleType("comfy")
    comfy.utils = types.SimpleNamespace(ProgressBar=ProgressBar)
    monkeypatch.setitem(sys.modules, "comfy", comfy)
    monkeypatch.setitem(sys.modules, "comfy.utils", comfy.utils)
    monkeypatch.setattr(model_paths, "paths", dict(model_paths.paths))

    grid, lora_path, embedding_path, msg = node.Eden_LoRa_trainer().train_lora(
        name="comfyrun", training_images_folder=env["data"], mode="style",
        sd_model_version="sdxl", training_resolution=64, train_batch_size=2, max_train_steps=2,
        ti_lr=1e-3, unet_lr=3e-4, lora_rank=4, n_tokens=3, seed=0)

    assert model_paths.get_path("SD") == os.path.join(models_dir, "eden", "sd")
    assert model_paths.get_path("CLIP") == os.path.join(models_dir, "eden", "clip")
    assert built[0].resolution == 64 and built[0].seed == 0
    assert updates and updates == sorted(updates) and updates[-1] <= 100
    assert isinstance(grid, torch.Tensor) and grid.dtype == torch.float32
    assert grid.ndim == 4 and grid.shape[0] == 1 and grid.shape[-1] == 3
    assert 0.0 <= float(grid.min()) and float(grid.max()) <= 1.0
    save_dir = os.path.dirname(lora_path)
    assert lora_path.endswith("comfyrun_sdxl_lora.safetensors")
    assert embedding_path == os.path.join(save_dir, "comfyrun_sdxl_embeddings.safetensors")
    assert sorted(os.listdir(save_dir)) == _artifacts("comfyrun", 2)
    assert msg == f"Trained LoRA 'comfyrun' for 2 steps -> {save_dir}"
