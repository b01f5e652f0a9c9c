"""The port's CLI in a 2-process gloo group against its 1-process run.

The counterpart of tests/test_multihost.py: tiny SDXL on the CPU, the same
config (global batch 2, 2 steps, the train state saved) run by
`python -m sd_lora_trainer_tpu_torch.main` once as one process and once as
two ranks formed from torchrun's environment variables (the 2-rank run
splits the batch, one row a rank). Both runs start together.

- the exported LoRA and TI rows of the 2-rank run equal the 1-process
  run's within 1e-3 of each tensor's L2 norm (the gradients are averaged
  over the ranks in another order; tests/test_torch_parallel.py holds the
  same step against JAX's);
- each rank prints `[distributed] process r/2` and the `[sharding] dp` line;
- rank 0 alone writes the artifacts and the train state: rank 1's own
  directory (`output_dir/rank1`) holds its preprocessing only.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from sd_lora_trainer_tpu_torch.models import synthesize as tsyn
from sd_lora_trainer_tpu_torch.models.unet import TINY_SDXL_UNET_CONFIG
from sd_lora_trainer_tpu_torch.utils.safetensors_io import load_safetensors

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("multihost")
    ckpt = str(root / "tiny.safetensors")
    tsyn.synthesize_checkpoint(ckpt, "sdxl", TINY_SDXL_UNET_CONFIG, tsyn.TINY_VAE_CONFIG,
                               tsyn.TINY_CLIP_L_CONFIG, tsyn.TINY_CLIP_G_CONFIG, seed=0,
                               device="cpu")
    data = root / "data"
    data.mkdir()
    rs = np.random.RandomState(0)
    for i in range(4):
        Image.fromarray(rs.randint(0, 255, (64, 64, 3), dtype=np.uint8)).save(data / f"{i}.png")
        (data / f"{i}.txt").write_text(f"a photo of a thing number {i}")
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    port = _free_port()
    procs = {}
    for name, world in (("one", 1), ("two", 2)):
        cfg = dict(name="mh", lora_training_urls=str(data), concept_mode="style",
                   caption_model="no_caption", sd_model_version="sdxl", ckpt_path=ckpt, seed=0,
                   resolution=64, validation_img_size=64, train_batch_size=2, max_train_steps=2,
                   checkpointing_steps=100, n_sample_imgs=1, lora_rank=4, skip_gpt_cleanup=True,
                   augment_imgs_up_to_n=0, weight_type="fp32", device="cpu",
                   save_train_state=True, output_dir=str(root / name),
                   _testing_no_output_dir=True)
        cfg_path = root / f"{name}.json"
        cfg_path.write_text(json.dumps(cfg))
        for rank in range(world):
            extra = ({"WORLD_SIZE": "2", "RANK": str(rank), "LOCAL_RANK": str(rank),
                      "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)} if world > 1 else {})
            procs[(name, rank)] = subprocess.Popen(
                [sys.executable, "-m", "sd_lora_trainer_tpu_torch.main", str(cfg_path)],
                cwd=str(root), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env={**env, **extra})
    out = {}
    for key, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        out[key] = stdout
        assert p.returncode == 0, (key, stdout[-3000:], stderr[-3000:])
    return root, out


def _artifacts(folder):
    save = os.path.join(folder, "checkpoints", "checkpoint-2")
    lora = load_safetensors(os.path.join(save, "mh_sdxl_lora.safetensors"))
    emb = load_safetensors(os.path.join(save, "mh_sdxl_embeddings.safetensors"))
    return {**lora, **emb}


def test_two_ranks_export_the_one_process_lora(runs):
    root, _ = runs
    one, two = _artifacts(root / "one"), _artifacts(root / "two")
    assert one.keys() == two.keys() and len(one) > 0
    for k in one:
        err, norm = float((two[k] - one[k]).norm()), float(one[k].norm())
        assert err <= 1e-3 * norm or (norm == 0 and err == 0), (k, err, norm)
    ups = [k for k in one if k.endswith("lora_up.weight")]
    assert sum(float(one[k].abs().sum()) for k in ups) > 0  # the adapters trained


def test_each_rank_prints_its_process_and_mesh(runs):
    _, out = runs
    for rank in (0, 1):
        lines = out[("two", rank)].splitlines()
        assert any(ln.startswith(f"[distributed] process {rank}/2") for ln in lines)
        assert any(ln.startswith("[sharding] dp over a mesh data=2") for ln in lines)
        summary = json.loads(next(ln for ln in lines if ln.startswith("[train-summary]"))[15:])
        assert summary["world"] == 2 and summary["rank"] == rank
        assert summary["collectives"]["all_reduce"]["bytes"] > 0
    assert not any(ln.startswith("[distributed]") for ln in out[("one", 0)].splitlines())


def test_rank0_alone_writes_the_train_state(runs):
    root, _ = runs
    two = root / "two"
    states = sorted(str(p.relative_to(two)) for p in two.rglob("train_state*.safetensors"))
    assert states == ["checkpoints/checkpoint-2/train_state.safetensors"], states
    assert (two / "rank1").is_dir()
    assert not (two / "rank1" / "checkpoints").exists()
    one_state = load_safetensors(str(root / "one" / states[-1]))
    two_state = load_safetensors(str(two / states[-1]))
    assert one_state.keys() == two_state.keys()
    assert torch.equal(one_state["step"], two_state["step"])
