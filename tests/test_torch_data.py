"""The port's data pipeline against the JAX package's.

- `preprocess`: one input folder, one seed, both packages: byte-equal
  captions.csv, equal pixels in every written image and mask, and equal
  training attributes (Python `random` and the same Pillow operations on
  both sides: exact).
- `BucketPlan`, `EpochSampler`: equal batch sequences from the same seed.
- `LatentDataset.from_directory` (square and bucketed) on the same
  preprocessed folder and the same tiny VAE: latents within 1e-5 relative
  L2 (float32 VAE encodes), masks and captions equal.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sd_lora_trainer_tpu.config import TrainingConfig as JConfig
from sd_lora_trainer_tpu.data import bucketing as jb
from sd_lora_trainer_tpu.data import dataset as jd
from sd_lora_trainer_tpu.data.preprocess import preprocess as j_preprocess
from sd_lora_trainer_tpu.models import weights as jw
from sd_lora_trainer_tpu_torch.config import TrainingConfig as TConfig
from sd_lora_trainer_tpu_torch.data import bucketing as tb
from sd_lora_trainer_tpu_torch.data import dataset as td
from sd_lora_trainer_tpu_torch.data.preprocess import preprocess as t_preprocess
from sd_lora_trainer_tpu_torch.models import synthesize as ts
from sd_lora_trainer_tpu_torch.models import weights as tw
from sd_lora_trainer_tpu_torch.models.unet import TINY_SDXL_UNET_CONFIG

SIZES = [(96, 80), (80, 96), (72, 72), (120, 64), (64, 100)]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    src = root / "src"
    src.mkdir()
    rs = np.random.RandomState(0)
    for i, (w, h) in enumerate(SIZES):
        Image.fromarray(rs.randint(0, 255, (h, w, 3), dtype=np.uint8)).save(src / f"{i}.png")
        if i % 2 == 0:
            (src / f"{i}.txt").write_text(f"a photo of a thing,, number {i}")
    return root


def _config(cls, src, out, **kw):
    base = dict(lora_training_urls=str(src), concept_mode="object", caption_model="no_caption",
                sd_model_version="sdxl", seed=7, resolution=64, skip_gpt_cleanup=True,
                augment_imgs_up_to_n=14, output_dir=str(out), _testing_no_output_dir=True)
    return cls(**{**base, **kw})


def _run_both(inputs, **kw):
    outs = {}
    for name, cls, fn in (("jax", JConfig, j_preprocess), ("port", TConfig, t_preprocess)):
        work = inputs / f"work_{name}_{len(kw)}"
        config = _config(cls, inputs / "src", work, **kw)
        config, out_dir = fn(
            config, working_directory=str(work), concept_mode=config.concept_mode,
            input_zip_path=config.lora_training_urls, caption_text=config.caption_prefix,
            mask_target_prompts=config.mask_target_prompts, target_size=config.resolution,
            crop_based_on_salience=config.crop_based_on_salience,
            use_face_detection_instead=config.use_face_detection_instead,
            left_right_flip_augmentation=config.left_right_flip_augmentation,
            augment_imgs_up_to_n=config.augment_imgs_up_to_n, caption_model=config.caption_model,
            seed=config.seed)
        outs[name] = (config, out_dir)
    return outs


@pytest.fixture(scope="module")
def preprocessed(inputs):
    return _run_both(inputs)


@pytest.mark.parametrize("mode", ["object", "style"])
def test_preprocess_writes_what_jax_writes(inputs, preprocessed, mode):
    outs = preprocessed if mode == "object" else _run_both(inputs, concept_mode="style",
                                                           left_right_flip_augmentation=False)
    (jc, jdir), (tc, tdir) = outs["jax"], outs["port"]
    with open(os.path.join(jdir, "captions.csv"), "rb") as f:
        j_csv = f.read()
    with open(os.path.join(tdir, "captions.csv"), "rb") as f:
        assert f.read() == j_csv
    files = sorted(os.listdir(jdir))
    assert files == sorted(os.listdir(tdir))
    # flips and augmentation fill up to augment_imgs_up_to_n in whole rounds
    assert len([f for f in files if f.endswith(".src.jpg")]) == (20 if mode == "object" else 15)
    for f in files:
        if f.endswith(".jpg"):
            a = np.asarray(Image.open(os.path.join(jdir, f)))
            b = np.asarray(Image.open(os.path.join(tdir, f)))
            np.testing.assert_array_equal(a, b, err_msg=f)
    for key in ("n_training_imgs", "trigger_text", "segmentation_prompt", "captions",
                "degradations"):
        assert tc.training_attributes[key] == jc.training_attributes[key], key
    assert list(tc.train_img_size) == list(jc.train_img_size)
    assert list(tc.validation_img_size) == list(jc.validation_img_size)


def test_bucket_plan_and_epoch_sampler_draw_like_jax():
    sizes = {i: (int(w), int(h)) for i, (w, h) in enumerate(
        np.random.RandomState(1).randint(200, 1400, size=(37, 2)))}
    kw = dict(batch_size=3, max_size=(1536, 1024), base_res=(1024, 1024), seed=5)
    jp, tp = jb.BucketPlan.build(sizes, **kw), tb.BucketPlan.build(sizes, **kw)
    assert tp.used_resolutions() == jp.used_resolutions()
    assert tb.generate_resolutions((1536, 1024), base_res=(1024, 1024)) == jb.generate_resolutions(
        (1536, 1024), base_res=(1024, 1024))
    for _ in range(40):
        j_ids, j_res = jp.get_batch()
        t_ids, t_res = tp.get_batch()
        assert (t_ids, tuple(t_res)) == (j_ids, tuple(j_res))
    js, tsamp = jd.EpochSampler(11, 3), td.EpochSampler(11, 3)
    for _ in range(20):
        assert tsamp.next_batch(4) == js.next_batch(4)


@pytest.fixture(scope="module")
def vaes(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.safetensors")
    ts.synthesize_checkpoint(path, "sdxl", TINY_SDXL_UNET_CONFIG, ts.TINY_VAE_CONFIG,
                             ts.TINY_CLIP_L_CONFIG, ts.TINY_CLIP_G_CONFIG, seed=4, device="cpu")
    return (jw.load_models_from_checkpoint(path, dtype=jnp.float32),
            tw.load_models_from_checkpoint(path, dtype=torch.float32, device="cpu"))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("bucketing", [False, True])
def test_latent_cache_matches_jax(preprocessed, vaes, bucketing):
    jm, tm = vaes
    (jc, jdir) = preprocessed["jax"]
    kw = dict(size=tuple(jc.train_img_size), substitute_caption_map={"TOK": "<s0><s1><s2>"},
              aspect_ratio_bucketing=bucketing, train_batch_size=2, seed=3, encode_batch=4)
    jds = jd.LatentDataset.from_directory(jdir, jm.vae, jm.vae_config, **kw)
    tds = td.LatentDataset.from_directory(jdir, tm.vae, tm.vae_config, **kw)
    assert tds.captions == jds.captions and "<s0><s1><s2>" in tds.captions[0]
    if not bucketing:
        assert _rel(tds.latent_mean, jds.latent_mean) <= 1e-5
        assert _rel(tds.latent_logvar, jds.latent_logvar) <= 1e-5
        np.testing.assert_array_equal(tds.masks, jds.masks)
        assert tds.encode_stats["images"] == len(tds) == 20
        return
    assert sorted(tds.bucket_latents) == sorted(jds.bucket_latents)
    for res, store in jds.bucket_latents.items():
        mine = tds.bucket_latents[res]
        assert sorted(mine.keys()) == sorted(store.keys())
        assert _rel(mine.mean, store.mean) <= 1e-5
        assert _rel(mine.logvar, store.logvar) <= 1e-5
        np.testing.assert_array_equal(mine.mask, store.mask)
    for _ in range(6):
        (jb_, jr), (tb_, tr) = jds.bucketed_batch(), tds.bucketed_batch()
        assert tr == tuple(jr) and tb_["captions"] == jb_["captions"]
        assert _rel(tb_["latent_mean"], jb_["latent_mean"]) <= 1e-5


def test_preprocess_keeps_a_supplied_description(inputs, monkeypatch):
    """A concept description the config supplies survives preprocessing
    unless GPT writes one (the TI warmup needs it offline). The JAX package
    overwrites it with None without GPT; everything else it writes is the
    same."""
    outs = _run_both(inputs, training_attributes={"gpt_description": "a red fox"})
    (jc, jdir), (tc, tdir) = outs["jax"], outs["port"]
    assert jc.training_attributes["gpt_description"] is None  # the JAX fault, not copied
    assert tc.training_attributes["gpt_description"] == "a red fox"
    with open(os.path.join(jdir, "captions.csv"), "rb") as f, \
            open(os.path.join(tdir, "captions.csv"), "rb") as g:
        assert f.read() == g.read()

    from sd_lora_trainer_tpu_torch.data import preprocess as tp

    real = tp.post_process_captions

    def with_gpt(captions, *a, **kw):
        captions, trigger, _ = real(captions, *a, **kw)
        return captions, trigger, "a fox written by GPT"

    monkeypatch.setattr(tp, "post_process_captions", with_gpt)
    work = inputs / "work_port_gpt"
    config = _config(TConfig, inputs / "src", work,
                     training_attributes={"gpt_description": "a red fox"})
    config, _ = t_preprocess(
        config, working_directory=str(work), concept_mode=config.concept_mode,
        input_zip_path=config.lora_training_urls, caption_text=config.caption_prefix,
        mask_target_prompts=config.mask_target_prompts, target_size=config.resolution,
        crop_based_on_salience=config.crop_based_on_salience,
        use_face_detection_instead=config.use_face_detection_instead,
        left_right_flip_augmentation=config.left_right_flip_augmentation,
        augment_imgs_up_to_n=config.augment_imgs_up_to_n, caption_model=config.caption_model,
        seed=config.seed)
    assert config.training_attributes["gpt_description"] == "a fox written by GPT"
