"""Synthetic checkpoints across the two packages.

A tiny SD1.5 or SDXL file written by the port's `synthesize_checkpoint`
(float32 or float16) loads in the JAX package's loader, configs from the
file's metadata alone, and every UNet, VAE and text-encoder tensor equals
the port loader's after the layout transpose, exactly (float32 on both sides;
fp16 values widen exactly). The other direction, a JAX-written file in the
port's loader, is tests/test_torch_weights.py. The port's own reader: a
memory-mapped read equals a plain one, and the metadata reads back.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd_lora_trainer_tpu.models import weights as jw
from sd_lora_trainer_tpu_torch.interop import from_jax_params
from sd_lora_trainer_tpu_torch.models import synthesize as ts
from sd_lora_trainer_tpu_torch.models import unet as tu
from sd_lora_trainer_tpu_torch.models import weights as tw
from sd_lora_trainer_tpu_torch.utils.safetensors_io import load_safetensors, read_safetensors_metadata


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


def _assert_same(port_tree, jax_tree):
    pt, jt = _flat(port_tree), _flat(from_jax_params(jax_tree, device="cpu"))
    assert sorted(pt) == sorted(jt)
    for k in pt:
        np.testing.assert_array_equal(pt[k].float().numpy(), jt[k].numpy(), err_msg=k)


@pytest.mark.parametrize("version,dtype", [("sd15", torch.float32), ("sdxl", torch.float32),
                                           ("sdxl", torch.float16)])
def test_port_written_file_loads_in_jax(version, dtype, tmp_path):
    ucfg = tu.TINY_SDXL_UNET_CONFIG if version == "sdxl" else tu.TINY_SD15_UNET_CONFIG
    path = str(tmp_path / "tiny.safetensors")
    ts.synthesize_checkpoint(path, version, ucfg, ts.TINY_VAE_CONFIG, ts.TINY_CLIP_L_CONFIG,
                             ts.TINY_CLIP_G_CONFIG if version == "sdxl" else None, seed=1,
                             dtype=dtype, device="cpu")
    want_dtype = {torch.float32: "F32", torch.float16: "F16"}[dtype]
    import json
    import struct

    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    assert {v["dtype"] for k, v in header.items() if k != "__metadata__"} == {want_dtype}

    jm = jw.load_models_from_checkpoint(path, dtype=jnp.float32)
    tm = tw.load_models_from_checkpoint(path, dtype=torch.float32, device="cpu")
    assert jm.version == tm.version == version
    embedded_j, embedded_t = jw.read_embedded_configs(path), tw.read_embedded_configs(path)
    for key in ("unet", "vae", "clip_l", "clip_g"):
        j, t = embedded_j[key], embedded_t[key]
        assert (j is None and t is None) or j.__dict__ == t.__dict__, key
    assert tm.unet_config == ucfg
    _assert_same(tm.unet, jm.unet)
    _assert_same(tm.vae, jm.vae)
    _assert_same(tm.text_encoder, jm.text_encoder)
    if version == "sdxl":
        _assert_same(tm.text_encoder_2, jm.text_encoder_2)


def test_exports_invert_the_converters(tmp_path):
    """export_ldm_vae / export_hf_clip / export_openclip give back the
    family's state dict the converters consumed."""
    path = str(tmp_path / "tiny.safetensors")
    ts.synthesize_checkpoint(path, "sdxl", tu.TINY_SDXL_UNET_CONFIG, ts.TINY_VAE_CONFIG,
                             ts.TINY_CLIP_L_CONFIG, ts.TINY_CLIP_G_CONFIG, seed=2, device="cpu")
    sd = load_safetensors(path)
    assert read_safetensors_metadata(path)[tw.EMBEDDED_CONFIG_KEY]
    # the read maps the file copy-on-write: writing into a tensor leaves the file as it was
    key = next(iter(sd))
    kept = sd[key].clone()
    sd[key].add_(1.0)
    assert torch.equal(load_safetensors(path)[key], kept)
    sd[key].copy_(kept)
    tm = tw.load_models_from_checkpoint(path, dtype=torch.float32, device="cpu")
    for prefix, exported in (
        (tw.VAE_PREFIX, ts.export_ldm_vae(tm.vae, tm.vae_config)),
        (tw.CLIP_SDXL_L_PREFIX, ts.export_hf_clip(tm.text_encoder, tm.text_encoder_config)),
        (tw.CLIP_SDXL_G_PREFIX, ts.export_openclip(tm.text_encoder_2, tm.text_encoder_2_config)),
    ):
        family = tw._take_prefix(sd, prefix)
        assert sorted(exported) == sorted(family)
        for k, v in family.items():
            assert torch.equal(exported[k], v), k
