"""The port's TI token warmup against the JAX package's `warmup_token_embeddings`.

Tiny SDXL (CLIP-L + bigG, concatenated penultimate states and the pooled
term) and SD1.5 (CLIP-L's last state), with the covariance regularizer on
and off; the same encoders (JAX's init carried over), rows, token ids and
description ids, 10 AdamW steps in float32 on the CPU. Tolerances: the
warmed rows within 2e-4 of the largest total move of the rows (Adam
divides each gradient by its own running magnitude, so float32 rounding in
a small gradient moves that element by a fraction of the LR, 1e-2 here;
measured 1.2e-5), and the history's terms 2e-4 relative (they are
taken at the rows of step 10, which carry the rows' differences; measured
5e-5). The history holds the last step's terms only, as in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd_lora_trainer_tpu.diffusion.losses import DistributionLossTargets as JTargets
from sd_lora_trainer_tpu.models.clip import init_clip_params as j_init_clip
from sd_lora_trainer_tpu.models.synthesize import TINY_CLIP_G_CONFIG as J_G
from sd_lora_trainer_tpu.models.synthesize import TINY_CLIP_L_CONFIG as J_L
from sd_lora_trainer_tpu.training.token_warmup import warmup_token_embeddings as j_warmup
from sd_lora_trainer_tpu_torch.diffusion.losses import DistributionLossTargets as TTargets
from sd_lora_trainer_tpu_torch.interop import from_jax_params
from sd_lora_trainer_tpu_torch.models import clip as tc
from sd_lora_trainer_tpu_torch.training.token_warmup import warmup_token_embeddings as t_warmup


@pytest.fixture(autouse=True)
def _grad_mode_on():
    """Gradients need torch's grad mode, which tests/test_golden_torch.py
    switches off when imported (and pytest-xdist workers import every file)."""
    with torch.enable_grad():
        yield


def _ids(rng, tokens):
    ids = np.full((1, 77), 255, np.int64)  # EOS fills the rest
    ids[0, 0] = 254  # BOS
    ids[0, 1:1 + len(tokens)] = tokens
    return ids


@pytest.mark.parametrize("cov_w", [0.0, 1e-2])
@pytest.mark.parametrize("version", ["sdxl", "sd15"])
def test_warmup_matches_jax(version, cov_w):
    which = ["te1", "te2"] if version == "sdxl" else ["te1"]
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    jparams = {"te1": j_init_clip(keys[0], J_L, dtype=jnp.float32),
               "te2": j_init_clip(keys[1], J_G, dtype=jnp.float32)}
    jcfgs, tcfgs = {"te1": J_L, "te2": J_G}, {"te1": tc.TINY_CLIP_L_CONFIG, "te2": tc.TINY_CLIP_G_CONFIG}
    rng = np.random.default_rng(0)
    rows = {w: rng.standard_normal((3, 32)).astype(np.float32) * 0.02 for w in which}
    token = _ids(rng, [256, 257, 258])  # "<s0><s1><s2>", the rows appended to the table
    target = _ids(rng, rng.integers(1, 250, size=6))  # the description
    tables = {w: np.asarray(jparams[w]["text_model"]["embeddings"]["token_embedding"]["weight"])
              for w in which}
    kw = dict(steps=10, ti_lr=1e-2, ti_weight_decay=0.01, tok_cov_reg_w=cov_w)

    rows_j, hist_j = j_warmup(
        {w: jnp.asarray(r) for w, r in rows.items()}, {w: jparams[w] for w in which},
        {w: jcfgs[w] for w in which}, version, {w: jnp.asarray(token, jnp.int32) for w in which},
        {w: jnp.asarray(target, jnp.int32) for w in which},
        {w: JTargets.from_embeddings(tables[w]) for w in which}, **kw)
    start = {w: torch.tensor(r, requires_grad=True) for w, r in rows.items()}
    rows_t, hist_t = t_warmup(
        start, {w: from_jax_params(jax.tree.map(np.asarray, jparams[w]), device="cpu")
                for w in which},
        {w: tcfgs[w] for w in which}, version, {w: torch.tensor(token) for w in which},
        {w: torch.tensor(target) for w in which},
        {w: TTargets.from_embeddings(torch.tensor(tables[w])) for w in which}, **kw)

    assert sorted(hist_t) == sorted(hist_j)
    assert ("covariance_tok_reg_loss" in hist_t) == (cov_w > 0)
    assert "token_std_loss" in hist_t and all(len(v) == 1 for v in hist_t.values())
    for k in hist_j:
        np.testing.assert_allclose(hist_t[k], hist_j[k], rtol=2e-4)
    for w in which:
        r = rows_t[w]
        assert r.requires_grad and r.is_leaf and r.grad is None
        moved = np.abs(np.asarray(rows_j[w]) - rows[w]).max()
        assert moved > 1e-2  # the rows trained
        np.testing.assert_allclose(r.detach().numpy(), np.asarray(rows_j[w]), rtol=0,
                                   atol=2e-4 * moved)
        assert torch.equal(start[w].detach(), torch.tensor(rows[w]))  # the input rows are kept


def test_no_steps_returns_the_rows():
    rows = {"te1": torch.zeros(3, 4, requires_grad=True)}
    out, hist = t_warmup(rows, {}, {}, "sd15", {}, {}, {}, steps=0, ti_lr=1e-3)
    assert out is rows and hist == {}
