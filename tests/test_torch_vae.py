"""The port's VAE and its converter against the JAX package's.

One tiny SDXL single file, written by the port's `synthesize_checkpoint`
(tests/test_torch_synthesize.py holds it to the JAX package's), is loaded by
both loaders in float32 on the CPU.
Tolerance: relative L2 <= 1e-5 for encode (mean, logvar), decode, the
batch-chunked decode and the tiled decode (the same float32 convolutions,
norms and attention in another summation order). The converter is
key-complete on the real SD1.5 and SDXL VAE inventories (meta tensors).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd_lora_trainer_tpu.models import vae as jv
from sd_lora_trainer_tpu.models import weights as jw
from sd_lora_trainer_tpu.models.synthesize import TINY_VAE_CONFIG
from sd_lora_trainer_tpu_torch.interop import from_jax_params
from sd_lora_trainer_tpu_torch.models import synthesize as ts
from sd_lora_trainer_tpu_torch.models.unet import TINY_SDXL_UNET_CONFIG
from sd_lora_trainer_tpu_torch.models import vae as tv
from sd_lora_trainer_tpu_torch.models import weights as tw

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
TOL = 1e-5


def _rel(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(port - ref) / np.linalg.norm(ref))


def _flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = tree
    return out


@pytest.fixture(scope="module")
def both_vaes(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vae") / "tiny_sdxl.safetensors")
    ts.synthesize_checkpoint(path, "sdxl", TINY_SDXL_UNET_CONFIG, ts.TINY_VAE_CONFIG,
                             ts.TINY_CLIP_L_CONFIG, ts.TINY_CLIP_G_CONFIG, seed=3, device="cpu")
    jm = jw.load_models_from_checkpoint(path, dtype=jnp.float32)
    tm = tw.load_models_from_checkpoint(path, dtype=torch.float32, device="cpu")
    return jm, tm


def test_converted_vae_equals_jax(both_vaes):
    jm, tm = both_vaes
    assert tm.vae_config == tv.VAEConfig(**TINY_VAE_CONFIG.__dict__)
    port, ref = _flat(tm.vae), _flat(from_jax_params(jm.vae, device="cpu"))
    assert sorted(port) == sorted(ref)
    for k in port:
        np.testing.assert_array_equal(port[k].numpy(), ref[k].numpy(), err_msg=k)


def _images(b, hw, seed):
    return np.random.RandomState(seed).uniform(-1, 1, (b, hw, hw, 3)).astype(np.float32)


def test_encode_matches_jax(both_vaes):
    jm, tm = both_vaes
    imgs = _images(2, 32, 0)
    jmean, jlogvar = jv.vae_encode(jm.vae, jnp.asarray(imgs), jm.vae_config)
    with torch.no_grad():
        tmean, tlogvar = tv.vae_encode(tm.vae, torch.from_numpy(imgs), tm.vae_config)
    assert tmean.shape == (2, 16, 16, 4)
    assert _rel(tmean, jmean) <= TOL
    assert _rel(tlogvar, jlogvar) <= TOL
    eps = torch.from_numpy(np.random.RandomState(1).randn(*tmean.shape).astype(np.float32))
    z = tv.vae_sample(tmean, tlogvar, eps, 0.13025)
    want = (np.asarray(jmean) + np.exp(0.5 * np.asarray(jlogvar)) * eps.numpy()) * 0.13025
    assert _rel(z, want) <= TOL


@pytest.mark.parametrize("kind", ["plain", "batched", "tiled"])
def test_decode_matches_jax(both_vaes, kind):
    jm, tm = both_vaes
    hw = 40 if kind == "tiled" else 16
    z = np.random.RandomState(2).randn(3, hw, hw, 4).astype(np.float32)
    if kind == "plain":
        want = jv.vae_decode(jm.vae, jnp.asarray(z), jm.vae_config)
        run = lambda: tv.vae_decode(tm.vae, torch.from_numpy(z), tm.vae_config)  # noqa: E731
    elif kind == "batched":  # one image a chunk: the JAX side maps over three
        want = jv.vae_decode_batched(jm.vae, jnp.asarray(z), jm.vae_config, max_latent_px=hw * hw)
        run = lambda: tv.vae_decode_batched(tm.vae, torch.from_numpy(z),  # noqa: E731
                                            tm.vae_config, max_latent_px=hw * hw)
    else:  # 2 x 2 tiles of 24 with >= 8 px overlap, two images a chunk
        kw = dict(tile=24, overlap=8, max_latent_px=2 * 24 * 24)
        want = jv.vae_decode_tiled(jm.vae, jnp.asarray(z), jm.vae_config, **kw)
        run = lambda: tv.vae_decode_tiled(tm.vae, torch.from_numpy(z), tm.vae_config, **kw)  # noqa: E731
    with torch.no_grad():
        got = run()
    assert got.shape == want.shape == (3, 2 * hw, 2 * hw, 3)
    assert _rel(got, want) <= TOL
    assert _rel(tv._taper(48, 8), jv._taper(48, 8)) <= 1e-7


@pytest.mark.parametrize("version", ["sd15", "sdxl"])
def test_vae_converter_consumes_the_real_inventory(version):
    with open(os.path.join(GOLDEN, f"ldm_{version}_inventory.json")) as f:
        inv = json.load(f)
    sd = {k: torch.empty(tuple(v["shape"]), device="meta") for k, v in inv.items()}
    cfg = tv.SDXL_VAE_CONFIG if version == "sdxl" else tv.SD15_VAE_CONFIG
    vae = tw.convert_ldm_vae(tw._take_prefix(sd, tw.VAE_PREFIX), cfg, device="meta")
    init = tv.init_vae_params(cfg, None, device="meta")
    shapes = {k: tuple(v.shape) for k, v in _flat(vae).items()}
    assert shapes == {k: tuple(v.shape) for k, v in _flat(init).items()}
    missing = tw._take_prefix(sd, tw.VAE_PREFIX)
    missing.pop("decoder.mid.attn_1.q.weight")
    with pytest.raises(KeyError, match="attn_1.q"):
        tw.convert_ldm_vae(missing, cfg, device="meta")
