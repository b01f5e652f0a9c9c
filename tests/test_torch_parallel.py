"""The port's parallel training against the JAX package's single-device step.

The port's side runs in a 2-process gloo group on the CPU
(tests/torch_parallel_worker.py, started once for the module); the JAX side
here, one compile for the module. Tiny SDXL, float32, a global batch of 4
rows whose masks, caption lengths, TI positions (one row lost a TI token)
and timesteps differ, so the losses' batch-level reductions are exercised.

- group rules: the port's trainable and optimizer-state rules against
  JAX's `trainable_shardings`, and `unet_tp_spec` against JAX's leaf by leaf
  on the tiny SDXL UNet (layouts mapped: torch [out, in] against JAX
  [in, out]). The port shards a tensor's flat storage padded to whole
  AdamW8bit blocks where JAX picks its largest divisible axis, so a leaf
  JAX shards is sharded by the port, and the port also shards the small or
  indivisible leaves JAX replicates;
- the UNet's transformer block under tp (`shard_block_tp`: each rank its
  own heads of the self-attention, the Megatron split of the cross-attention
  and GEGLU) against JAX's block with `flash_tp` (its self-attention's
  per-head `tp_shard` split), heads 2 and 4, and heads (3) and batch (3)
  that do not divide: 2e-5 (float32, another summation order);
- one step's loss terms and gradients under dp (LoRA, TI, TE-LoRA), tp (the
  same on the Megatron split) and fsdp (full finetune + TI) against JAX's
  `compute_loss` on the global batch with JAX's draws: the tolerances of
  tests/test_torch_step.py (loss 1e-5 relative; each gradient 1e-3 relative
  + 1e-6 absolute per element and within 1e-4 of its tensor's largest). The
  full finetune's gradients are JAX's gradients of the LoRA loss with
  respect to the base weights (the adapters start with B = 0, so the
  forward is the base's), and its loss is that loss less the L1 penalty;
- two steps under each plan and optimizer (fsdp under AdamW, Prodigy and
  AdamW8bit; the first step on JAX's draws, the second on the generator's,
  every rank drawing the global batch's) against the port's one-process steps:
  each step's update within 1e-3 of the one-process update, relative L2
  over all tensors (the gradients differ in their last bits: sums over the
  ranks in another order, which Adam's normalized first steps pass on);
  both ranks hold the same values;
- collective bytes > 0 in every 2-rank case;
- an fsdp AdamW8bit state saved by 2 ranks restores bit for bit in 2 ranks
  and in 1; rank 0 alone holds the gathered state.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd_lora_trainer_tpu.diffusion import losses as jl
from sd_lora_trainer_tpu.diffusion.schedulers import DDPMSchedule as JSchedule
from sd_lora_trainer_tpu.models.clip import init_clip_params as j_init_clip
from sd_lora_trainer_tpu.models.lora import TEXT_ENCODER_TARGETS as J_TE_TARGETS
from sd_lora_trainer_tpu.models.lora import create_lora_params as j_create_lora
from sd_lora_trainer_tpu.models.synthesize import TINY_CLIP_G_CONFIG, TINY_CLIP_L_CONFIG
from sd_lora_trainer_tpu.models.unet import TINY_SDXL_UNET_CONFIG, init_unet_params
from sd_lora_trainer_tpu.models.unet import _transformer_block as j_block
from sd_lora_trainer_tpu.parallel import sharding as jsh
from sd_lora_trainer_tpu.config import TrainingConfig as JConfig
from sd_lora_trainer_tpu.training import step as js
from sd_lora_trainer_tpu_torch.diffusion import losses as tl
from sd_lora_trainer_tpu_torch.diffusion.schedulers import DDPMSchedule as TSchedule
from sd_lora_trainer_tpu_torch.interop import from_jax_params
from sd_lora_trainer_tpu_torch.models import clip as t_clip
from sd_lora_trainer_tpu_torch.models import unet as t_unet
from sd_lora_trainer_tpu_torch.parallel import sharding as tsh
from sd_lora_trainer_tpu_torch.training import step as ts
from sd_lora_trainer_tpu_torch.training.optimizers import GroupOptimizer, group_tensors
from sd_lora_trainer_tpu_torch.utils.safetensors_io import load_safetensors
from sd_lora_trainer_tpu_torch import checkpoint as ck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
BATCH = 4
# transformer block cases: (heads, batch, (data, model) mesh)
ATTENTION = {"heads2": (2, 4, (1, 2)), "heads4": (4, 4, (1, 2)),
             "heads3_indivisible": (3, 4, (1, 2)), "batch3_indivisible": (2, 3, (2, 1))}
CROSS = 32  # the blocks' context width


def _jax_block(r, c: int) -> dict:
    """A transformer block's params in JAX's layout, random biases and norms
    included (the row split adds a bias after its sum)."""

    def lin(i, o, bias=True):
        out = {"kernel": (r.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)}
        if bias:
            out["bias"] = (0.1 * r.standard_normal(o)).astype(np.float32)
        return out

    def ln():
        return {"scale": (1 + 0.1 * r.standard_normal(c)).astype(np.float32),
                "bias": (0.1 * r.standard_normal(c)).astype(np.float32)}

    return {"norm1": ln(), "attn1": {"to_q": lin(c, c, False), "to_k": lin(c, c, False),
                                     "to_v": lin(c, c, False), "to_out.0": lin(c, c)},
            "norm2": ln(), "attn2": {"to_q": lin(c, c, False), "to_k": lin(CROSS, c, False),
                                     "to_v": lin(CROSS, c, False), "to_out.0": lin(c, c)},
            "norm3": ln(), "ff.net.0.proj": lin(c, 8 * c), "ff.net.2": lin(4 * c, c)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_draws(key, shape):
    """The draws JAX compute_loss makes from `key` (training/step.py)."""
    k_latent, k_noise, k_offset, k_t = jax.random.split(key, 4)
    return {
        "latent_eps": torch.tensor(np.asarray(jax.random.normal(k_latent, shape))),
        "noise": torch.tensor(np.asarray(jax.random.normal(k_noise, shape, jnp.float32))),
        "offset_noise": torch.tensor(np.asarray(
            jax.random.normal(k_offset, (shape[0], 1, 1, shape[-1]), jnp.float32))),
        "timesteps": torch.tensor(np.asarray(jax.random.randint(k_t, (shape[0],), 0, 1000))),
    }


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX's reference (one compile) and the workers' results."""
    ks = jax.random.split(jax.random.PRNGKey(0), 8)
    unet = init_unet_params(ks[0], TINY_SDXL_UNET_CONFIG, dtype=jnp.float32)
    te1 = j_init_clip(ks[1], TINY_CLIP_L_CONFIG, dtype=jnp.float32)
    te2 = j_init_clip(ks[2], TINY_CLIP_G_CONFIG, dtype=jnp.float32)
    tables = [t["text_model"]["embeddings"]["token_embedding"]["weight"] for t in (te1, te2)]
    jfrozen = js.FrozenModels(
        unet_params=unet, unet_config=TINY_SDXL_UNET_CONFIG, te1_params=te1,
        te1_config=TINY_CLIP_L_CONFIG, te2_params=te2, te2_config=TINY_CLIP_G_CONFIG,
        schedule=JSchedule.create(), version="sdxl", resolution=(16, 16),
        distribution_targets={f"te{i + 1}": jl.DistributionLossTargets.from_embeddings(t)
                              for i, t in enumerate(tables)},
    )
    trainable = {
        "unet": j_create_lora(ks[3], unet, rank=4),
        "ti": {"te1": jax.random.normal(ks[4], (3, 32)) * 0.01,
               "te2": jax.random.normal(ks[5], (3, 32)) * 0.01},
        "te_lora": {"te1": j_create_lora(ks[6], te1, rank=4, targets=J_TE_TARGETS),
                    "te2": j_create_lora(ks[7], te2, rank=4, targets=J_TE_TARGETS)},
    }
    rng = np.random.default_rng(7)
    ids = np.full((1, BATCH, 77), 255, np.int32)
    ids[..., 0], ids[..., 1] = 254, 5
    ids[..., 2:5] = [256, 257, 258]
    positions = np.tile(np.asarray([[[2, 3, 4]]], np.int32), (1, BATCH, 1))
    positions[0, 3, 0] = -1  # the last row (rank 1's) lost a TI token
    batch = {
        "latent_mean": rng.standard_normal((1, BATCH, 16, 16, 4), np.float32),
        "latent_logvar": np.full((1, BATCH, 16, 16, 4), -6.0, np.float32),
        "latent_scale": np.asarray(0.13025, np.float32),
        "mask": (rng.random((1, BATCH, 16, 16, 1)) > np.asarray([0.1, 0.3, 0.6, 0.8])[
            None, :, None, None, None]).astype(np.float32),
        "input_ids": ids, "input_ids_2": ids,
        "caption_token_lengths": np.asarray([[6, 7, 8, 9]], np.int32),
        "ti_token_positions": positions,
    }
    kw = dict(lora_training_urls="x", concept_mode="style", sd_model_version="sdxl",
              max_train_steps=50, lora_rank=4, _testing_no_output_dir=True, resolution=16,
              unet_lr=1e-3, cond_reg_w=1e-5, tok_cov_reg_w=1e-5, quantize_base="none",
              text_encoder_lora_optimizer="adamw")
    jsc = dataclasses.replace(js.StepConfig.from_config(JConfig(**kw), 1.0), remat=False)
    mb = {k: (v[0] if v.ndim > 0 else v) for k, v in batch.items()}
    key = jax.random.PRNGKey(2)
    draws = _jax_draws(key, mb["latent_mean"].shape)

    tfrozen = ts.FrozenModels(
        unet_params=from_jax_params(_np(unet), device="cpu"),
        te1_params=from_jax_params(_np(te1), device="cpu"),
        te2_params=from_jax_params(_np(te2), device="cpu"),
        schedule=TSchedule.create(device="cpu"),
        distribution_targets={f"te{i + 1}": tl.DistributionLossTargets.from_embeddings(
            torch.tensor(np.asarray(t))) for i, t in enumerate(tables)},
        unet_config=t_unet.TINY_SDXL_UNET_CONFIG, te1_config=t_clip.TINY_CLIP_L_CONFIG,
        te2_config=t_clip.TINY_CLIP_G_CONFIG, version="sdxl", resolution=(16, 16),
    )
    lora_tr = from_jax_params(_np(trainable), device="cpu")
    full_tr = {"unet": from_jax_params(_np(unet), device="cpu"), "ti": lora_tr["ti"]}
    attention = {}
    for name, (heads, b, _) in ATTENTION.items():
        r = np.random.default_rng(len(name))
        attention[name] = {"block": _jax_block(r, 8 * heads),
                           "x": r.standard_normal((b, 64, 8 * heads)).astype(np.float32),
                           "ctx": r.standard_normal((b, 8, CROSS)).astype(np.float32)}
    folder = str(tmp_path_factory.mktemp("parallel"))
    torch.save({"frozen": tfrozen, "lora_trainable": lora_tr, "full_trainable": full_tr,
                "batch": {k: torch.tensor(v) for k, v in batch.items()}, "draws": draws,
                "attention": {name: {"block": from_jax_params(a["block"], device="cpu"),
                                     "x": torch.tensor(a["x"]), "ctx": torch.tensor(a["ctx"])}
                              for name, a in attention.items()}},
               os.path.join(folder, "inputs.pt"))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, WORKER, folder], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "WORLD_SIZE": "2", "RANK": str(r), "LOCAL_RANK": str(r),
             "MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "OMP_NUM_THREADS": "1"})
        for r in range(2)]
    logs = []
    # JAX's compile runs while the workers do: gradients with respect to the
    # adapters and to the base weights at once
    (loss, aux), (g_tr, g_base) = jax.jit(jax.value_and_grad(
        lambda t, base: js.compute_loss(t, dataclasses.replace(jfrozen, unet_params=base), jsc,
                                        mb, key, jnp.asarray(0)),
        argnums=(0, 1), has_aux=True))(trainable, unet)
    for p in procs:
        out, _ = p.communicate(timeout=600)
        logs.append(out)
    assert all(p.returncode == 0 for p in procs), "\n".join(x[-3000:] for x in logs)
    ranks = [torch.load(os.path.join(folder, f"rank{r}.pt"), weights_only=False) for r in (0, 1)]
    return {"loss": float(loss), "aux": {k: float(v) for k, v in aux.items()},
            "l1_penalty": jsc.l1_penalty,
            "g_tr": from_jax_params(_np(g_tr), device="cpu"),
            "g_base": from_jax_params(_np(g_base), device="cpu"), "unet": unet,
            "trainable": trainable, "attention": attention, "ranks": ranks, "logs": logs,
            "folder": folder, "inputs": os.path.join(folder, "inputs.pt")}


def _leaves(tree, path=()):
    if torch.is_tensor(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))


# ---------------------------------------------------------------------------
# Group rules and the Megatron split
# ---------------------------------------------------------------------------


def _jax_specs(tree_sh):
    out = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(
            tree_sh, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]:
        keys = tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        out[keys] = tuple(sh.spec)
    return out


def _torch_keys(path):
    """A JAX param path in the port's names."""
    return tuple({"kernel": "weight", "scale": "weight"}.get(k, k) for k in path)


@pytest.mark.parametrize("mode", ["dp", "fsdp", "tp"])
def test_group_rules_match_jax(eight_cpu_devices, setup, mode):
    trainable = {"unet": setup["unet"],
                 "ti": {"te1": jnp.zeros((3, 32)), "te2": jnp.zeros((3, 32))}}
    mesh = jsh.create_mesh(2)
    jspec = _jax_specs(jsh.trainable_shardings(trainable, mesh, mode=mode))
    ttrain = from_jax_params(_np(trainable), device="cpu")
    specs = tsh.trainable_shardings(ttrain, mode, 2)

    def flat(tree, path=()):
        if isinstance(tree, tuple):
            yield path, tree
        elif isinstance(tree, dict):
            for k, v in tree.items():
                yield from flat(v, path + (str(k),))
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from flat(v, path + (str(i),))

    tspec = dict(flat(specs))
    assert {_torch_keys(k) for k in jspec} == set(tspec)
    for k, spec in jspec.items():
        port = tspec[_torch_keys(k)]
        if any(spec):
            assert port == ("data",), (k, spec, port)  # a leaf JAX shards, the port shards
        group_sharded = mode == "fsdp" and k[0] == "unet"
        assert bool(port) == group_sharded, (k, port)
    # the moments follow their group, never their shape: a TI row shaped like
    # a UNet tensor replicates with its group
    cfg_kw = dict(lora_training_urls="x", concept_mode="style", sd_model_version="sdxl",
                  _testing_no_output_dir=True, is_lora=False, device="cpu")
    from sd_lora_trainer_tpu_torch.config import TrainingConfig as TConfig

    ttrain = {"unet": {"w": torch.zeros(3, 32, requires_grad=True)},
              "ti": {"te1": torch.zeros(3, 32, requires_grad=True)}}
    opt = GroupOptimizer(TConfig(**cfg_kw, unet_optimizer_type="prodigy",
                                 ti_optimizer="prodigy"), ttrain)
    osh = tsh.optimizer_state_shardings(opt, tsh.trainable_shardings(ttrain, mode, 2))
    for key, spec in osh.items():
        sharded = mode == "fsdp" and key.startswith("unet.") and key.split(".")[1] in (
            "exp_avg", "exp_avg_sq", "s", "p0")
        assert bool(spec) == sharded, (key, spec)


def _to_torch_spec(jspec: tuple, ndim: int, geglu: bool) -> tuple:
    """A JAX spec of an [in, out] kernel (GEGLU [in, 2, inner]) in the torch
    layout ([out, in], GEGLU [2, inner, in])."""
    spec = tuple(jspec) + (None,) * (ndim - len(jspec))
    if not any(spec):
        return ()
    if ndim == 2 and not geglu:
        return spec[::-1]
    if ndim == 3:
        return (spec[1], spec[2], spec[0])
    return spec


def test_unet_tp_spec_matches_jax(eight_cpu_devices, setup):
    unet = jsh.unet_tp_geglu_reshape(setup["unet"])
    mesh = jsh.create_mesh_2d(4, 2)
    jspec = _jax_specs(jsh.unet_tp_shardings(unet, mesh))
    tunet = tsh.unet_tp_geglu_reshape(from_jax_params(_np(setup["unet"]), device="cpu"))
    tleaves = dict(_leaves(tunet))
    n_split = 0
    for path, spec in jspec.items():
        tpath = _torch_keys(path)
        leaf = tleaves[tpath]
        geglu = "ff.net.0.proj" in path
        want = _to_torch_spec(spec, leaf.ndim, geglu) if path[-1] == "kernel" or geglu else (
            tuple(spec) if any(spec) else ())
        got = tsh.unet_tp_spec(tpath, leaf, 2)
        assert got == want, (path, spec, got, want)
        n_split += bool(got)
    assert n_split == sum(any(spec) for spec in jspec.values()) > 0


@pytest.mark.parametrize("name", sorted(ATTENTION))
def test_tp_self_attention_matches_jax(eight_cpu_devices, setup, name):
    """The UNet's transformer block under tp, each rank on its own heads,
    against JAX's block whose self-attention takes `tp_shard`."""
    heads, _, (n_data, n_model) = ATTENTION[name]
    a = setup["attention"][name]
    mesh = jsh.create_mesh_2d(n_data, n_model)
    want, _ = j_block(a["block"], a["x"], a["ctx"], heads, False, True,
                      flash_tp=(mesh, "data", "model"))
    for r in setup["ranks"]:
        got = r["attention"][name]
        assert got["split"] == (n_model > 1 and heads % n_model == 0), (name, got["split"])
        np.testing.assert_allclose(got["out"].numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# One step against JAX
# ---------------------------------------------------------------------------


def _close_to_largest(t, j, what):
    np.testing.assert_allclose(t.numpy(), j.numpy(), rtol=1e-3, atol=1e-6, err_msg=str(what))
    err, scale = float((t - j).abs().max()), float(j.abs().max())
    assert err <= 1e-4 * scale, (what, err, scale)


@pytest.mark.parametrize("mode", ["dp", "tp", "fsdp"])
def test_parallel_step_matches_jax(setup, mode):
    res = [r[f"{mode}_adamw"] for r in setup["ranks"]]
    m = res[0]["metrics"]
    want_loss, want_grads = setup["loss"], setup["g_tr"]
    if mode == "fsdp":  # the full finetune's loss has no L1 penalty on adapters
        want_loss -= setup["l1_penalty"] * setup["aux"]["l1_norm"]
        want_grads = {"unet": setup["g_base"], "ti": setup["g_tr"]["ti"]}
    for k in set(m) - {"tot_loss", "grad_norm"}:
        np.testing.assert_allclose(m[k], setup["aux"][k], rtol=1e-5, atol=1e-9, err_msg=k)
    assert set(setup["aux"]) - set(m) == ({"l1_norm"} if mode == "fsdp" else set())
    np.testing.assert_allclose(m["tot_loss"], want_loss, rtol=1e-5)
    assert res[1]["metrics"] == m
    got = dict(_leaves(res[0]["grads"]))
    want = dict(_leaves(want_grads))
    assert set(got) == set(want) and len(got) > 0
    for path in want:
        _close_to_largest(got[path], want[path], path)
        assert torch.equal(got[path], dict(_leaves(res[1]["grads"]))[path]), path
    assert res[0]["collectives"]["total_bytes"] > 0, res[0]["collectives"]


# ---------------------------------------------------------------------------
# Steps against the port's one-process steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["dp_adamw", "tp_adamw", "fsdp_adamw", "fsdp_prodigy",
                                  "fsdp_AdamW8bit"])
def test_parallel_steps_match_one_process(setup, case):
    r0, r1 = (r[case] for r in setup["ranks"])
    ref = r0.get("one_process") or r1["one_process"]
    for i in (1, 2):
        got = dict(_leaves(r0["params"][i]))
        prev = dict(_leaves(ref[i - 1]))
        want = dict(_leaves(ref[i]))
        assert set(got) == set(want)
        err = sum(float(((got[p] - want[p]) ** 2).sum()) for p in want) ** 0.5
        move = sum(float(((want[p] - prev[p]) ** 2).sum()) for p in want) ** 0.5
        assert move > 0 and err <= 1e-3 * move, (case, i, err, move)
        other = dict(_leaves(r1["params"][i]))
        assert all(torch.equal(got[p], other[p]) for p in got), case
    assert r0["collectives"]["total_bytes"] > 0, r0["collectives"]


# ---------------------------------------------------------------------------
# Train state across rank counts
# ---------------------------------------------------------------------------


def _same_files(a: str, b: str) -> None:
    sa, sb = load_safetensors(a), load_safetensors(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("ranks", [2, 1])
def test_state_saved_by_two_ranks_restores(setup, ranks):
    first = setup["ranks"][0]["state"]["first"]
    assert [r["state"]["keeps"] for r in setup["ranks"]] == [True, False]
    if ranks == 2:
        _same_files(first, setup["ranks"][0]["state"]["again"])
        return
    inp = torch.load(setup["inputs"], weights_only=False)
    from sd_lora_trainer_tpu_torch.config import TrainingConfig as TConfig

    cfg = TConfig(lora_training_urls="x", concept_mode="style", sd_model_version="sdxl",
                  _testing_no_output_dir=True, is_lora=False, unet_optimizer_type="AdamW8bit",
                  device="cpu", max_train_steps=50)
    tr = inp["full_trainable"]
    with torch.no_grad():
        for t in group_tensors(tr):
            t.zero_()
    state = ts.TrainState(step=0, trainable=tr, optimizer=GroupOptimizer(cfg, tr),
                          generator=torch.Generator().manual_seed(9))
    ck.restore_train_state(first, state)
    assert state.step == 2
    again = os.path.join(setup["folder"], "state_1rank.safetensors")
    ck.save_train_state(again, state)
    _same_files(first, again)
