"""The port's experimental distribution losses against the JAX package's.

`GaussianKDE.score_samples` / `log_prob`, `DifferentiableHistogram`'s NLL
and its gradient, on the same numpy inputs from a seed, relative 1e-5
(float32 on both sides); `GaussianKDE.sample` given the JAX draws; and the
four properties of tests/test_experimental_and_merge.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd_lora_trainer_tpu.diffusion import experimental_losses as jel
from sd_lora_trainer_tpu_torch.diffusion import experimental_losses as tel

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _grad_mode_on():
    """Gradients need torch's grad mode, which tests/test_golden_torch.py
    switches off when imported (and pytest-xdist workers import every file)."""
    with torch.enable_grad():
        yield


def _close(got: torch.Tensor, want, rtol=RTOL):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy()
    scale = max(np.abs(want).max(), 1e-12)
    assert np.abs(got - want).max() <= rtol * scale, (got, want)


@pytest.mark.parametrize("bw", [0.1, 0.5])
def test_kde_scores_match_jax(bw):
    rs = np.random.RandomState(0)
    x = rs.randn(64, 5).astype(np.float32) * 0.3
    y = rs.randn(17, 5).astype(np.float32) * 0.4
    jk, tk = jel.GaussianKDE(jnp.asarray(x), bw=bw), tel.GaussianKDE(torch.from_numpy(x), bw=bw)
    _close(tk.score_samples(torch.from_numpy(y)), jk.score_samples(jnp.asarray(y)))
    _close(tk.log_prob(torch.from_numpy(y)), jk.log_prob(jnp.asarray(y)))


def test_kde_sample_with_the_jax_draws():
    rs = np.random.RandomState(1)
    x = rs.randn(40, 3).astype(np.float32)
    jk, tk = jel.GaussianKDE(jnp.asarray(x), bw=0.2), tel.GaussianKDE(torch.from_numpy(x), bw=0.2)
    key = jax.random.PRNGKey(3)
    want = jk.sample(key, 25)
    k1, k2 = jax.random.split(key)  # the draws of the JAX sample, replayed
    idx = np.array(jax.random.randint(k1, (25,), 0, 40))
    eps = np.array(jax.random.normal(k2, (25, 3)))
    got = tk.sample(25, idx=torch.from_numpy(idx), eps=torch.from_numpy(eps))
    _close(got, want)


@pytest.mark.parametrize("bins,ranged", [(64, False), (32, True)])
def test_histogram_nll_and_gradient_match_jax(bins, ranged):
    rs = np.random.RandomState(2)
    x = (rs.randn(800) * 0.014).astype(np.float32)
    y = (rs.randn(120) * 0.02).astype(np.float32)
    kw = {"min_range": -0.05, "max_range": 0.05} if ranged else {}
    jh = jel.DifferentiableHistogram(jnp.asarray(x), bins=bins, **kw)
    th = tel.DifferentiableHistogram(torch.from_numpy(x), bins=bins, **kw)
    _close(th.pdf, jh.pdf)
    yt = torch.from_numpy(y).requires_grad_()
    nll = th(yt)
    nll.backward()
    _close(nll, jh(jnp.asarray(y)))
    _close(yt.grad, jax.grad(lambda v: jh(v))(jnp.asarray(y)))


# the properties of tests/test_experimental_and_merge.py, on the port


def test_kde_scores_higher_near_data():
    x = torch.randn(200, 4, generator=torch.Generator().manual_seed(0)) * 0.1
    kde = tel.GaussianKDE(x, bw=0.2)
    near = kde.score_samples(torch.zeros(1, 4))
    far = kde.score_samples(torch.ones(1, 4) * 5.0)
    assert float(near[0]) > float(far[0])
    assert np.isfinite(float(kde.log_prob(x[:10])))


def test_kde_sampling_tracks_distribution():
    x = torch.cat([torch.full((100, 2), -3.0), torch.full((100, 2), 3.0)])
    kde = tel.GaussianKDE(x, bw=0.1)
    samples = kde.sample(500, generator=torch.Generator().manual_seed(1))
    assert abs(float(samples.abs().mean()) - 3.0) < 0.3  # bimodal +-3


def test_histogram_nll_direction():
    g = torch.Generator().manual_seed(2)
    hist = tel.DifferentiableHistogram(torch.randn(2000, generator=g) * 0.014, bins=64)
    nll_in = float(hist(torch.randn(200, generator=g) * 0.014))
    nll_out = float(hist(torch.full((200,), 0.2)))
    assert nll_in < nll_out


def test_histogram_is_differentiable():
    hist = tel.DifferentiableHistogram(torch.randn(500, generator=torch.Generator().manual_seed(4)),
                                       bins=32)
    y = (torch.ones(50) * 0.5).requires_grad_()
    hist(y).backward()
    assert torch.isfinite(y.grad).all()
    assert float(y.grad.abs().sum()) > 0
