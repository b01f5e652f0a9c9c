"""The port's Prodigy, AdamW8bit and optimizer groups against the JAX package's.

Float32 on the CPU; the same seeded numpy inputs go through both packages.
Tolerances, each with its reason:

- Prodigy over 12 steps of a quadratic: params, d, d_max, d_numerator and
  the effective LR 1e-5 relative (float32 sums over the tensors in another
  order, ~1e-7; the ratio d_numerator / d_denom carries that into d);
- the codebooks, `quantize_blockwise` and an AdamW8bit trajectory whose
  gradients do not depend on the params: uint8 indices and fp32 scales
  equal bit for bit (the same float32 operations in the same order); the
  params 1e-6 relative + 1e-9 absolute (the LR schedule is computed in
  double here and in float32 in JAX: a relative 6e-8 of each update, which
  is at most 1e-2 here, and a float32 rounding of p + u);
- `GroupOptimizer` against `build_optimizer` over 3 steps with the
  schedules: each element within 1e-3 of its tensor's largest total update,
  plus two float32 roundings of p + u at the element's magnitude. torch's
  AdamW decays p by (1 - lr * wd) before its step, optax adds wd * p into
  the step: measured 4.7e-4 beyond the two roundings on one element;
  Prodigy and AdamW8bit stay within the two roundings;
- the train state: saved, restored and run on, bit for bit.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sd_lora_trainer_tpu.config import TrainingConfig as JConfig
from sd_lora_trainer_tpu.training import quantized_adam as jq
from sd_lora_trainer_tpu.training.optimizers import build_optimizer
from sd_lora_trainer_tpu.training.optimizers import current_lrs as j_current_lrs
from sd_lora_trainer_tpu.training.prodigy import prodigy, prodigy_effective_lr
from sd_lora_trainer_tpu_torch.checkpoint import restore_train_state, save_train_state
from sd_lora_trainer_tpu_torch.config import TrainingConfig as TConfig
from sd_lora_trainer_tpu_torch.training import optimizers as to
from sd_lora_trainer_tpu_torch.training import quantized_adam as tq
from sd_lora_trainer_tpu_torch.training.prodigy import Prodigy
from sd_lora_trainer_tpu_torch.training.prodigy import prodigy_effective_lr as t_effective_lr
from sd_lora_trainer_tpu_torch.training.step import TrainState

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "bnb_dynamic_map.json")
SHAPES = [(5, 40), (300,), (2, 3, 7), (4,)]


def _close(t, j, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(np.asarray(t.detach() if torch.is_tensor(t) else t),
                               np.asarray(j), rtol=rtol, atol=atol)


@pytest.mark.parametrize("growth_rate,weight_decay,safeguard", [
    (1.05, 0.0, True), (math.inf, 0.01, True), (1.5, 0.004, False)])
def test_prodigy_matches_jax(growth_rate, weight_decay, safeguard):
    rng = np.random.default_rng(0)
    init = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    target = [rng.standard_normal(s).astype(np.float32) * 3 for s in SHAPES]
    kw = dict(growth_rate=growth_rate, weight_decay=weight_decay, safeguard_warmup=safeguard,
              betas=(0.9, 0.99), d_coef=2.0)
    jopt = prodigy(**kw)
    jp = [jnp.asarray(x) for x in init]
    state = jopt.init(jp)
    tp = [torch.tensor(x, requires_grad=True) for x in init]
    topt = Prodigy(tp, **kw)
    ds, bound = [], 0
    for _ in range(12):
        grads = [2 * (np.asarray(p) - t) for p, t in zip(jp, target)]
        d_before = float(state.d)
        updates, state = jopt.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, p_j, t in zip(tp, jp, target):
            p.grad = 2 * (p.detach() - torch.tensor(t))
        topt.step()
        for p, p_j in zip(tp, jp):
            _close(p, p_j, rtol=1e-5, atol=1e-7)
        for name in ("d", "d_max", "d_numerator"):
            _close(getattr(topt, name), getattr(state, name), rtol=1e-5)
        _close(t_effective_lr(topt), prodigy_effective_lr(state), rtol=1e-5)
        assert int(topt.count) == int(state.count)
        ds.append(float(state.d))
        # after the first move off d0, the cap binds when d grew by exactly growth_rate
        bound += d_before > 1e-6 and np.isclose(ds[-1], d_before * growth_rate, rtol=1e-6)
    assert ds[-1] > 2e-6  # d left d0 = 1e-6
    if math.isfinite(growth_rate):
        assert bound >= 5  # the growth cap bound on most steps


def test_codebooks_match_jax_and_bitsandbytes():
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert torch.equal(tq._SMAP, torch.tensor(np.asarray(jq._SMAP)))
    assert torch.equal(tq._UMAP, torch.tensor(np.asarray(jq._UMAP)))
    np.testing.assert_array_equal(tq._SMAP.double().numpy(), np.asarray(golden["signed"]))
    np.testing.assert_array_equal(tq._UMAP.double().numpy(), np.asarray(golden["unsigned"]))
    assert (tq._SZERO, tq._UZERO) == (jq._SZERO, jq._UZERO)
    assert tq._SMAP[tq._SZERO] == 0 and tq._UMAP[tq._UZERO] == 0


@pytest.mark.parametrize("signed", [True, False])
def test_quantize_blockwise_matches_jax(signed):
    """Sizes that are not a multiple of 2048, an all-zero block (scale 1),
    and values at the midpoint of two codebook entries (the tie rule)."""
    rng = np.random.default_rng(1)
    codebook = np.asarray(jq._SMAP if signed else jq._UMAP)
    mids = ((codebook[:-1] + codebook[1:]) / 2).astype(np.float32)
    mids = mids[(mids - codebook[:-1]) == (codebook[1:] - mids)]  # exact ties in float32
    assert mids.size > 20
    x = rng.standard_normal(3 * 2048 + 517).astype(np.float32) * 1e-3
    if not signed:
        x = np.abs(x)
    x[:2048] = 0.0  # an all-zero block
    x[2048:2048 + mids.size] = mids
    x[2048 + mids.size] = 1.0  # this block's absmax: its values are their own codes
    x[-50:] = rng.standard_normal(50).astype(np.float32) ** 2 * 1e-7  # tiny values
    for shape in [(x.size,), (5, 3), (2049,)]:
        v = x[: int(np.prod(shape))].reshape(shape)
        qj, sj = jq.quantize_blockwise(jnp.asarray(v), signed=signed)
        qt, st = tq.quantize_blockwise(torch.tensor(v), signed=signed)
        assert qt.dtype == torch.uint8 and st.dtype == torch.float32
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        back_j = jq.dequantize_blockwise(qj, sj, shape, signed=signed)
        back_t = tq.dequantize_blockwise(qt, st, shape, signed=signed)
        np.testing.assert_array_equal(back_t.numpy(), np.asarray(back_j))
    assert float(tq.quantize_blockwise(torch.tensor(x))[1][0]) == 1.0  # absmax 0 -> scale 1


@pytest.mark.parametrize("bucket", [tq.BUCKET, 2 * 2048])
def test_adamw8bit_trajectory_matches_jax(bucket):
    """8 steps at a schedule LR with weight decay; gradients spanning seven
    decades. The flat layout (one buffer, or one per tensor or two) gives
    JAX's per-tensor states bit for bit. Each tensor is in its package's
    layout, as in a model (a matrix transposed, a conv weight HWIO in JAX
    and OIHW in the port): blocks follow JAX's element order."""
    from sd_lora_trainer_tpu_torch.interop import _to_torch_layout as port_layout

    rng = np.random.default_rng(2)
    shapes = SHAPES + [(3000,), (2, 2100), (3, 3, 16, 48)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]

    def schedule(count):
        return 1e-3 * (1.0 + count.astype(jnp.float32))

    jopt = jq.adamw8bit(schedule, weight_decay=0.01)
    jp = [jnp.asarray(x) for x in init]
    state = jopt.init(jp)
    tp = [torch.tensor(np.ascontiguousarray(port_layout(x)), requires_grad=True) for x in init]
    topt = tq.AdamW8bit(tp, weight_decay=0.01, bucket=bucket)
    assert len(topt.buckets) == (1 if bucket == tq.BUCKET else 5)
    for k in range(8):
        grads = [(rng.standard_normal(s) * 10.0 ** rng.integers(-6, 1)).astype(np.float32)
                 for s in shapes]
        updates, state = jopt.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(tp, grads):
            p.grad = torch.tensor(np.ascontiguousarray(port_layout(g)))
        topt.step(1e-3 * (1.0 + k))
        for i, (p, p_j) in enumerate(zip(tp, jp)):
            _close(p, port_layout(np.asarray(p_j)), rtol=1e-6, atol=1e-9)
            mom = topt.moments(i)
            assert mom["mu_q"].dtype == torch.uint8 and mom["mu_scale"].shape == (mom["mu_q"].shape[0],)
            for name, ref in (("mu_q", state.mu[i].q), ("mu_scale", state.mu[i].scale),
                              ("nu_q", state.nu[i].q), ("nu_scale", state.nu[i].scale)):
                np.testing.assert_array_equal(mom[name].numpy(), np.asarray(ref), err_msg=name)
    assert topt.count == int(state.count) == 8
    state_bytes = sum(t.numel() * t.element_size() for k, t in topt.state_tensors().items()
                      if k not in ("count", tq.JAX_ORDER_KEY))
    assert state_bytes == sum(2 * (m.q.size + 4 * m.q.shape[0]) for m in state.mu)


def _config(unet, ti, **kw):
    base = dict(lora_training_urls="x", concept_mode="style", sd_model_version="sdxl",
                max_train_steps=10, _testing_no_output_dir=True, unet_optimizer_type=unet,
                ti_optimizer=ti, unet_lr_warmup_steps=4, txt_encoders_lr_warmup_steps=2,
                text_encoder_lora_optimizer="adamw", text_encoder_lora_lr=1e-3,
                prodigy_d_coef=1.5, unet_prodigy_growth_factor=1.2, ti_weight_decay=0.01)
    base.update(kw)
    return JConfig(**base), TConfig(**base)


def _tree(rng):
    return {"unet": {"down": {"a": rng.standard_normal((4, 6)).astype(np.float32),
                              "b": rng.standard_normal((6, 4)).astype(np.float32)},
                     "mid": {"w": rng.standard_normal(3000).astype(np.float32)}},
            "ti": {"te1": rng.standard_normal((3, 8)).astype(np.float32),
                   "te2": rng.standard_normal((3, 8)).astype(np.float32)},
            "te_lora": {"te1": {"q": rng.standard_normal((2, 8)).astype(np.float32)}}}


def _moment(opt, i, m, signed):
    """Tensor i's moment `m` ("mu" or "nu") dequantized, in its layout."""
    from sd_lora_trainer_tpu_torch.interop import from_jax_order

    p, mom = opt.params[i], opt.moments(i)
    flat = tq.dequantize_blockwise(mom[f"{m}_q"], mom[f"{m}_scale"], (p.numel(),), signed=signed)
    return from_jax_order(flat, p.shape)


def test_adamw8bit_reblocks_a_state_saved_in_storage_order():
    """A state saved before the blocks followed JAX's element order (no
    JAX_ORDER_KEY, each tensor blocked in the port's storage order) is not
    copied in as it is: a matrix's and a conv weight's moments are
    re-blocked, so they dequantize to the saved ones within the codes'
    rounding (read as JAX-order blocks they would be other elements'), and a
    vector's codes are taken bit for bit. Under fsdp such a state is
    refused."""
    rng = np.random.default_rng(3)
    shapes = [(64, 96), (48, 16, 3, 3), (300,)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    params = [torch.tensor(x, requires_grad=True) for x in init]
    opt = tq.AdamW8bit(params, weight_decay=0.01)
    for _ in range(2):
        for p in params:
            p.grad = torch.tensor(rng.standard_normal(p.shape).astype(np.float32))
        opt.step(1e-3)
    old, want = {"count": torch.tensor(opt.count)}, {}
    for i, p in enumerate(params):
        for m, signed in (("mu", True), ("nu", False)):
            want[i, m] = _moment(opt, i, m, signed)
            old[f"{m}_q.{i:05d}"], old[f"{m}_scale.{i:05d}"] = tq.quantize_blockwise(
                want[i, m], signed=signed)
    assert tq.JAX_ORDER_KEY in opt.state_tensors() and tq.JAX_ORDER_KEY not in old

    fresh = tq.AdamW8bit([torch.tensor(x, requires_grad=True) for x in init], weight_decay=0.01)
    fresh.load_state_tensors(old)
    assert fresh.count == 2
    for i, shape in enumerate(shapes):
        for m, signed in (("mu", True), ("nu", False)):
            got, ref = _moment(fresh, i, m, signed), want[i, m]
            assert float((got - ref).norm() / ref.norm()) < 2e-2, (shape, m)
            if len(shape) == 1:
                assert torch.equal(fresh.moments(i)[f"{m}_q"], old[f"{m}_q.{i:05d}"])
            else:  # the old codes read as JAX-order blocks
                as_is = tq.AdamW8bit([torch.zeros(shape)])
                as_is.load_state_tensors({tq.JAX_ORDER_KEY: torch.tensor(1), "count": old["count"],
                                          **{f"{n}.00000": old[f"{n}.{i:05d}"] for n in
                                             ("mu_q", "mu_scale", "nu_q", "nu_scale")}})
                assert float((_moment(as_is, 0, m, signed) - ref).norm() / ref.norm()) > 0.5

    shard = torch.zeros(64 * 96 // 2, requires_grad=True)
    shard.fsdp_whole_shape = torch.Size((64, 96))
    with pytest.raises(ValueError, match="storage order"):
        tq.AdamW8bit([shard]).load_state_tensors(
            {k: v for k, v in old.items() if k.endswith((".00000", "count"))})


def _by_path(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _by_path(tree[key], f"{prefix}/{key}").items()}
    return {prefix: tree}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.tensor(tree, requires_grad=True)


@pytest.mark.parametrize("ti", ["adamw", "prodigy"])
@pytest.mark.parametrize("unet", ["adamw", "prodigy", "AdamW8bit"])
def test_group_optimizer_matches_jax(unet, ti):
    jcfg, tcfg = _config(unet, ti)
    rng = np.random.default_rng(3)
    init, target = _tree(rng), _tree(rng)
    jopt = build_optimizer(jcfg, init)
    jp = jax.tree.map(jnp.asarray, init)
    state = jopt.init(jp)
    tp = _torch_tree(init)
    topt = to.GroupOptimizer(tcfg, tp)
    assert topt.kinds() == {"unet": {"AdamW8bit": "adamw8bit"}.get(unet, unet), "ti": ti,
                            "te_lora": "adamw"}
    for _ in range(3):
        grads = jax.tree.map(lambda p, t: 2 * (np.asarray(p) - t), jp, target)
        updates, state = jopt.update(jax.tree.map(jnp.asarray, grads), state, jp)
        jp = optax.apply_updates(jp, updates)
        for (p, t) in zip(to.group_tensors(tp), to.group_tensors(_torch_tree(target))):
            p.grad = 2 * (p.detach() - t.detach())
        topt.step()
    assert topt.count == 3
    final_j, start = _by_path(jax.tree.map(np.asarray, jp)), _by_path(init)
    for path, p in _by_path(tp).items():
        moved_j = np.abs(final_j[path] - start[path]).max()
        ulps = 2 * np.spacing(np.abs(final_j[path]))  # the roundings of p + u at |p| ~ 1
        assert moved_j > 0 and (np.abs(p.detach().numpy() - final_j[path])
                                <= 1e-3 * moved_j + ulps).all(), path
    lrs = to.current_lrs(tcfg, 3, topt)
    assert {k for k in lrs if k.endswith("_prodigy")} == {
        f"{g}_prodigy" for g, k in topt.kinds().items() if k == "prodigy"}
    for k in ("unet", "textual_inversion", "text_encoders"):
        assert lrs[k] == pytest.approx(float(j_current_lrs(jcfg, jnp.asarray(3))[k]), rel=1e-5)


@pytest.mark.parametrize("unet,ti", [("adamw", "adamw"), ("prodigy", "prodigy"),
                                     ("AdamW8bit", "adamw")])
def test_train_state_resumes_bit_for_bit(unet, ti, tmp_path):
    """Steps 1-2, save; steps 3-4; a fresh state restored from the file runs
    steps 3-4 again and ends equal bit for bit. A state written under other
    optimizers is refused."""
    _, tcfg = _config(unet, ti)
    rng = np.random.default_rng(4)
    init, target = _tree(rng), _torch_tree(_tree(rng))

    def fresh():
        tree = _torch_tree(init)
        return TrainState(step=0, trainable=tree, optimizer=to.GroupOptimizer(tcfg, tree),
                          generator=torch.Generator().manual_seed(0))

    def run(state, n):
        for _ in range(n):
            for p, t in zip(to.group_tensors(state.trainable), to.group_tensors(target)):
                p.grad = 2 * (p.detach() - t.detach()) + torch.randn(
                    p.shape, generator=state.generator)
            state.optimizer.step()
            state.step += 1

    whole = fresh()
    run(whole, 2)
    path = str(tmp_path / "state.safetensors")
    save_train_state(path, whole)
    run(whole, 2)
    resumed = restore_train_state(path, fresh())
    assert resumed.step == 2 and resumed.optimizer.count == 2
    run(resumed, 2)
    for a, b in zip(whole.optimizer.params(), resumed.optimizer.params()):
        assert torch.equal(a, b)
    sa, sb = whole.optimizer.state_tensors(), resumed.optimizer.state_tensors()
    assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)

    other = "prodigy" if unet != "prodigy" else "adamw"
    _, ocfg = _config(other, ti)
    tree = _torch_tree(init)
    wrong = TrainState(step=0, trainable=tree, optimizer=to.GroupOptimizer(ocfg, tree),
                       generator=torch.Generator())
    with pytest.raises(ValueError, match="written under the optimizers"):
        restore_train_state(path, wrong)
