"""The reference against the program's own functions at float32 on the CPU,
at the tiny sizes: the same inputs and draws give the same loss and
gradients, so a gap on the card is precision, not a different model.

    python -m pytest perfbench/tests -q
"""

import json

import pytest
import torch

from perfbench import inputs as inp
from perfbench.harness import ROOT
from perfbench.reference.nn import Prec
from perfbench.reference.train import Trainer

CELLS = {"sdxl": ("sdxl_base", "style_1024_bs4"), "sd15": ("sd15_base", "face_768_bs4")}


def _tiny(model):
    cfg_name, traffic = CELLS[model]
    config = json.loads((ROOT / f"perfbench/configs/{cfg_name}.json").read_text())
    mix = json.loads((ROOT / f"perfbench/traffic/{traffic}.json").read_text())
    return dict(config, **config["tiny"]), dict(mix, **mix["tiny"])


@pytest.mark.parametrize("model", ["sdxl", "sd15"])
def test_reference_loss_and_grads_match_program_fp32(model):
    from perfbench.traffic import train as tr
    from sd_lora_trainer_tpu_torch.training.optimizers import group_tensors
    from sd_lora_trainer_tpu_torch.training.step import compute_loss

    torch.manual_seed(0)
    config, mix = _tiny(model)
    # float32 weights on both sides and no int8 base: the two must agree to
    # rounding; the recipe's int8 base is checked on its own below
    mix = dict(mix, overrides=dict(mix["overrides"], quantize_base="none"),
               reference_recipe=dict(mix["reference_recipe"], int8_base=False))
    dev = torch.device("cpu")
    real = inp.make_inputs
    try:
        inp.make_inputs = lambda *a, **k: real(*a, **dict(k, dtype=torch.float32))
        job = tr.build_job(config, mix, 3, dev)
        w, h = mix["resolution"]
        r = dict(mix["reference_recipe"], train_img_size=[w, h], daam_img_ratio=w / h)
        ref = Trainer(config, r, real(config, 3, dev, dtype=torch.float32), Prec("fp32"), dev,
                      remat=False)
    finally:
        inp.make_inputs = real
    pool = tr.Pool(mix, config, 3)
    batch = {k: torch.as_tensor(v[0]) for k, v in pool.draw(mix["batch"]).items()}
    batch["latent_scale"] = torch.tensor(float(pool.scale))
    gen = torch.Generator().manual_seed(11)
    b, hh, ww, c = batch["latent_mean"].shape
    draws = {"latent_eps": torch.randn(b, hh, ww, c, generator=gen),
             "noise": torch.randn(b, hh, ww, c, generator=gen),
             "offset_noise": torch.randn(b, 1, 1, c, generator=gen),
             "timesteps": torch.randint(0, 1000, (b,), generator=gen)}
    # nonzero B everywhere, so that every path of the adapters is exercised
    with torch.no_grad():
        for p in group_tensors(job.state.trainable):
            name = job.names[id(p)]
            if name.endswith(".b"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.01)
                ref.params[name].copy_(p)
    loss_p, _ = compute_loss(job.state.trainable, job.frozen, job.sc, batch, 0, None, **draws)
    loss_p.backward()
    loss_r, _ = ref.loss(batch, draws, 0)
    names = list(ref.params)
    grads_r = torch.autograd.grad(loss_r, [ref.params[k] for k in names])
    assert abs(float(loss_p) - float(loss_r)) <= 1e-5 * abs(float(loss_r))
    by_name = {job.names[id(p)]: p for p in group_tensors(job.state.trainable)}
    assert set(by_name) == set(names)
    for k, g in zip(names, grads_r):
        gp = by_name[k].grad
        scale = float(g.norm()) + 1e-12
        assert float((gp - g).norm()) <= 1e-4 * scale + 1e-10, k


def test_int8_base_matches_program_codes():
    from sd_lora_trainer_tpu_torch.models.quant import quantize_kernel
    from perfbench.reference.train import int8_rowwise

    gen = torch.Generator().manual_seed(0)
    for shape in [(64, 32), (16, 8, 3, 3)]:
        w = (torch.randn(shape, generator=gen) * 0.02).to(torch.bfloat16)
        assert torch.equal(quantize_kernel(w).float(), int8_rowwise(w))


def test_render_reference_matches_program_fp32(tmp_path):
    """The render's latents (prompts, encodes, blend, merged adapters, CFG
    Euler) and the VAE decode, against the program at float32."""
    from perfbench.reference import render as ref_render, vae as ref_vae
    from perfbench.traffic import render as tr
    from sd_lora_trainer_tpu_torch import inference
    from sd_lora_trainer_tpu_torch.models.vae import vae_decode

    config = json.loads((ROOT / "perfbench/configs/sdxl_base.json").read_text())
    mix = json.loads((ROOT / "perfbench/traffic/render_1024_n6.json").read_text())
    config, mix = dict(config, **config["tiny"]), dict(mix, **mix["tiny"])
    dev = torch.device("cpu")
    real = inp.make_inputs
    try:
        inp.make_inputs = lambda *a, **k: real(*a, **dict(k, dtype=torch.float32))
        tc, pipe, lora = tr.build(config, mix, 4, dev, str(tmp_path))
        data = inp.make_inputs(config, 4, dev, vae=True, lora_b_std=mix["lora_b_std"])
    finally:
        inp.make_inputs = real
    seen = []
    real_decode = inference.decode_images
    inference.decode_images = lambda p, z: seen.append(z) or real_decode(p, z)
    try:
        w, h = mix["resolution"]
        inference.render_images(pipe, render_size=(w, h), lora_path=str(tmp_path), train_step=0,
                                seed=tc.seed, lora_scale=tc.sample_imgs_lora_scale,
                                n_steps=mix["n_steps"], n_imgs=tc.n_sample_imgs, unet_lora=lora,
                                precision="fp32")
    finally:
        inference.decode_images = real_decode
    z_prog = seen[0]
    rows = [0, 2]
    z_ref = ref_render.sample(config, mix, data, 4, Prec("fp32"), dev, rows)
    z_ref = z_ref.permute(0, 2, 3, 1)
    for j, i in enumerate(rows):
        err = float((z_prog[i] - z_ref[j]).norm() / z_ref[j].norm())
        assert err < 1e-4, (i, err)
    img_prog = vae_decode(data["vae"], z_prog[:1], pipe.vae_config)
    img_ref = ref_vae.decode(data["vae"], z_prog[:1].permute(0, 3, 1, 2), config["vae"], Prec("fp32"))
    img_ref = img_ref.permute(0, 2, 3, 1)
    assert float((img_prog - img_ref).norm() / img_ref.norm()) < 1e-4
