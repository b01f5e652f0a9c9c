"""The port's export surface (kohya LoRA, TI rows, LDM UNet) and resume.

Checked against the JAX package and the golden manifests, on the CPU:
- `kohya_state_dict` keys, shapes and alphas equal
  tests/golden/kohya_{sdxl,sd15}_rank16.json (adapter trees built from
  shapes on the meta device: no full-width tensor is allocated);
- for the same adapters (through `from_jax_params`) the port's kohya dict
  equals JAX's exactly, and `load_kohya_state_dict` inverts it;
- `export_ldm_unet` keys and shapes equal the UNet family of
  tests/golden/ldm_{sdxl,sd15}_inventory.json;
- the port's safetensors writer and reader round-trip every dtype they
  take, 0-d alphas stay 0-d, and files cross with the `safetensors` package
  both ways (skipped where that package is absent);
- `save_checkpoint` writes the JAX package's artifact names and contents,
  and `load_checkpoint` reads them back exactly;
- a train state saved after one step and restored into a fresh state
  continues bit for bit like an uninterrupted run.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from sd_lora_trainer_tpu import checkpoint as j_ckpt
from sd_lora_trainer_tpu.models import clip as j_clip
from sd_lora_trainer_tpu.models import lora as j_lora
from sd_lora_trainer_tpu.models import synthesize as j_synth
from sd_lora_trainer_tpu_torch import checkpoint as t_ckpt
from sd_lora_trainer_tpu_torch.interop import from_jax_params
from sd_lora_trainer_tpu_torch.models import clip as t_clip
from sd_lora_trainer_tpu_torch.models import unet as t_unet
from sd_lora_trainer_tpu_torch.models.lora import (
    TEXT_ENCODER_TARGETS,
    UNET_TARGETS,
    create_lora_params,
    iter_lora_leaves,
    kohya_state_dict,
    load_kohya_state_dict,
)
from sd_lora_trainer_tpu_torch.models.weights import UNET_PREFIX, export_ldm_unet
from sd_lora_trainer_tpu_torch.training import step as ts
from sd_lora_trainer_tpu_torch.utils.safetensors_io import load_safetensors, save_safetensors
from tests.test_torch_named_remat import tiny_sdxl

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


@pytest.fixture(autouse=True)
def _grad_mode_on():
    """Gradients need torch's grad mode, which tests/test_golden_torch.py
    switches off when imported (and pytest-xdist workers import every file)."""
    with torch.enable_grad():
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU threads contend with the JAX CPU client's (8 virtual
    devices, tests/conftest.py): the tiny UNet's step takes ~10x longer."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meta_models(version):
    ucfg = t_unet.SDXL_UNET_CONFIG if version == "sdxl" else t_unet.SD15_UNET_CONFIG
    clips = [t_clip.CLIP_L_CONFIG] + ([t_clip.CLIP_BIG_G_CONFIG] if version == "sdxl" else [])
    unet = t_unet.init_unet_params(ucfg, None, device="meta")
    tes = [t_clip.init_clip_params(c, None, device="meta") for c in clips]
    return ucfg, unet, tes


@pytest.mark.parametrize("version", ["sdxl", "sd15"])
def test_kohya_export_matches_the_golden_manifest(version):
    with open(os.path.join(GOLDEN, f"kohya_{version}_rank16.json")) as f:
        manifest = json.load(f)
    _, unet, tes = _meta_models(version)
    unet_lora = create_lora_params(unet, 16, None, targets=UNET_TARGETS)
    te_loras = [create_lora_params(te, 16, None, targets=TEXT_ENCODER_TARGETS) for te in tes]
    sd = kohya_state_dict(unet_lora, te_loras)
    assert set(sd) == set(manifest["keys"])
    for k, v in sd.items():
        if k.endswith(".alpha"):
            assert v.shape == () and float(v) == manifest["alpha"], k
        else:
            assert list(v.shape) == manifest["keys"][k] and v.dtype == torch.float32, k
    n_unet = sum(k.startswith("lora_unet_") for k in sd)
    assert n_unet == {"sdxl": 3 * 577, "sd15": 3 * 150}[version]  # 3 keys a site


@pytest.mark.parametrize("version", ["sdxl", "sd15"])
def test_ldm_export_keys_match_the_inventory(version):
    with open(os.path.join(GOLDEN, f"ldm_{version}_inventory.json")) as f:
        inv = json.load(f)
    want = {k[len(UNET_PREFIX):]: v["shape"] for k, v in inv.items() if v["family"] == "unet"}
    ucfg, unet, _ = _meta_models(version)
    got = export_ldm_unet(unet, ucfg)
    assert {k: list(v.shape) for k, v in got.items()} == want


@pytest.fixture(scope="module")
def jax_adapters():
    """JAX adapter trees (nonzero B) of the tiny SDXL UNet and both encoders."""
    _, params, _, _, _ = tiny_sdxl()
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    unet_lora = j_lora.create_lora_params(keys[0], jax.tree.map(jnp.asarray, params), rank=4)
    tes = [jax.jit(j_clip.init_clip_params, static_argnums=1)(keys[1], c)
           for c in (j_synth.TINY_CLIP_L_CONFIG, j_synth.TINY_CLIP_G_CONFIG)]
    te_loras = [j_lora.create_lora_params(keys[2], te, rank=4,
                                          targets=j_lora.TEXT_ENCODER_TARGETS) for te in tes]
    bump = jax.tree.map(lambda x: x + 0.01 if hasattr(x, "ndim") and x.ndim > 1 else x,
                        (unet_lora, te_loras))
    return params, tes, bump[0], bump[1]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_kohya_dict_equals_jax_and_loads_back(jax_adapters):
    params, tes, unet_lora, te_loras = jax_adapters
    want = j_lora.kohya_state_dict(unet_lora, te_loras)
    tlora = from_jax_params(_np(unet_lora), device="cpu")
    tte = [from_jax_params(_np(t), device="cpu") for t in te_loras]
    got = kohya_state_dict(tlora, tte)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == np.shape(want[k]), k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    base = from_jax_params(_np(params), device="cpu")
    tbase_tes = [from_jax_params(_np(t), device="cpu") for t in tes]
    for sd in (got, {k: torch.tensor(np.asarray(v)) for k, v in want.items()}):
        unet_back, te_back = load_kohya_state_dict(sd, base, tbase_tes, device="cpu")
        for back, ref in [(unet_back, tlora)] + list(zip(te_back, tte)):
            leaves, ref_leaves = dict(iter_lora_leaves(back)), dict(iter_lora_leaves(ref))
            assert sorted(leaves) == sorted(ref_leaves)
            for path, e in ref_leaves.items():
                assert torch.equal(leaves[path]["a"], e["a"]) and torch.equal(leaves[path]["b"], e["b"])
                assert leaves[path]["alpha"].value == e["a"].shape[0]


def test_safetensors_round_trip_and_interop(tmp_path):
    g = torch.Generator().manual_seed(0)
    tensors = {
        "f32_transposed": torch.randn(3, 5, generator=g).t(),
        "alpha": torch.tensor(16.0),
        "bf16": torch.randn(4, 2, generator=g).bfloat16(),
        "f16": torch.randn(7, generator=g).half(),
        "i8": torch.randint(-127, 128, (2, 3), generator=g, dtype=torch.int8),
        "u8": torch.randint(0, 255, (9,), generator=g, dtype=torch.uint8),
        "i64": torch.tensor([2**40, -3]),
        "empty": torch.zeros(0, 4),
        "numpy": np.arange(6, dtype=np.float64).reshape(2, 3),
    }
    path = str(tmp_path / "x.safetensors")
    save_safetensors(tensors, path, metadata={"format": "pt"})
    back = load_safetensors(path)
    assert sorted(back) == sorted(tensors)
    for k, v in tensors.items():
        v = torch.from_numpy(v) if isinstance(v, np.ndarray) else v
        assert back[k].dtype == v.dtype and back[k].shape == v.shape and torch.equal(back[k], v), k
    safetensors = pytest.importorskip("safetensors.numpy")
    lib = safetensors.load_file(path)
    assert lib["alpha"].shape == () and np.array_equal(lib["f32_transposed"],
                                                       tensors["f32_transposed"].numpy())
    theirs = str(tmp_path / "y.safetensors")
    arrays = {"w": np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32),
              "alpha": np.asarray(4.0, np.float32), "ids": np.arange(5, dtype=np.int32)}
    safetensors.save_file(arrays, theirs)
    for k, v in load_safetensors(theirs).items():
        assert v.shape == arrays[k].shape and np.array_equal(v.numpy(), arrays[k]), k


def test_save_checkpoint_writes_the_jax_artifacts(jax_adapters, tmp_path):
    params, tes, unet_lora, te_loras = jax_adapters
    rows = [np.random.default_rng(i).standard_normal((3, 32)).astype(np.float32) for i in (1, 2)]
    token_dict = {"TOK": "<s0><s1><s2>"}
    j_ckpt.save_checkpoint(str(tmp_path / "jax"), 7, "my run", "sdxl", token_dict, True,
                           ti_rows=[jnp.asarray(r) for r in rows], unet_lora=unet_lora,
                           te_loras=te_loras)
    tlora = from_jax_params(_np(unet_lora), device="cpu")
    tte = [from_jax_params(_np(t), device="cpu") for t in te_loras]
    t_ckpt.save_checkpoint(str(tmp_path / "port"), 7, "my run", "sdxl", token_dict, True,
                           ti_rows=[torch.tensor(r) for r in rows], unet_lora=tlora, te_loras=tte)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [
        "my_run_sdxl_embeddings.safetensors", "my_run_sdxl_lora.safetensors",
        "special_params.json"]
    for name in names[:2]:
        a, b = (load_safetensors(str(tmp_path / d / name)) for d in ("jax", "port"))
        assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a), name
    with open(tmp_path / "port" / "special_params.json") as f:
        assert json.load(f) == token_dict
    base = from_jax_params(_np(params), device="cpu")
    loaded = t_ckpt.load_checkpoint(str(tmp_path / "jax"), base,
                                    [from_jax_params(_np(t), device="cpu") for t in tes],
                                    device="cpu")
    assert loaded["token_dict"] == token_dict
    for got, want in zip(loaded["ti_rows"], rows):
        assert torch.equal(got, torch.tensor(want))
    leaves = dict(iter_lora_leaves(loaded["unet_lora"]))
    for path, e in iter_lora_leaves(tlora):
        assert torch.equal(leaves[path]["a"], e["a"]) and torch.equal(leaves[path]["b"], e["b"])


def _tiny_run():
    """chip_smoke's SDXL run at the tiny widths on the CPU: the frozen models,
    the trainable tree and its optimizer, one batch and the generator."""
    return chip_smoke._build_run(t_unet.TINY_SDXL_UNET_CONFIG, "cpu", torch.float32, batch=2,
                                 latent_hw=16, rank=4, fuse=True)


def test_resume_continues_bit_for_bit(tmp_path):
    def step(run):
        return ts.make_train_step(run["sc"])(run["state"], run["batch"], run["frozen"])

    straight = _tiny_run()
    step(straight)
    want = step(straight)

    first = _tiny_run()
    step(first)
    path = str(tmp_path / "state" / "train_state.safetensors")
    t_ckpt.save_train_state(path, first["state"])
    resumed = _tiny_run()
    with torch.no_grad():  # a fresh state that differs everywhere until restored
        for t in resumed["tensors"]:
            t.add_(1.0)
    resumed["generator"].manual_seed(99)
    t_ckpt.restore_train_state(path, resumed["state"])
    assert resumed["state"].step == 1 and resumed["state"].optimizer.count == 1
    got = step(resumed)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for a, b in zip(resumed["tensors"], straight["tensors"]):
        assert torch.equal(a, b)
    assert torch.equal(resumed["generator"].get_state(), straight["generator"].get_state())
    with pytest.raises(ValueError, match="configuration"):
        bare = _tiny_run()
        del bare["state"].trainable["ti"]
        bare["state"].optimizer.opt.param_groups.pop()
        t_ckpt.restore_train_state(path, bare["state"])
