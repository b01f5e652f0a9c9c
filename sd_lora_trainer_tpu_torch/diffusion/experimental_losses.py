"""Experimental distribution losses (counterpart of sd_lora_trainer_tpu/diffusion/experimental_losses.py).

A Gaussian kernel density estimate and a Gaussian-smoothed histogram with
an NLL score, for embedding-distribution regularization experiments. As in
the JAX package they stay out of the training path.

`GaussianKDE.sample` draws from a `torch.Generator`, or takes the draws
explicitly (`idx`, `eps`), so a test can feed it the JAX package's.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


class GaussianKDE:
    """Kernel density estimate over points x [n, d] with bandwidth `bw`."""

    def __init__(self, x: torch.Tensor, bw: float = 0.1):
        self.x = x.float()
        self.bw = bw
        self.n, self.dims = x.shape

    def score_samples(self, y: torch.Tensor) -> torch.Tensor:
        """log density at each point of y [m, d]."""
        diff = (self.x[:, None, :] - y.float()[None, :, :]) / self.bw  # [n, m, d]
        log_k = -0.5 * (diff**2).sum(dim=-1) - 0.5 * self.dims * math.log(2 * math.pi)
        return torch.logsumexp(log_k, dim=0) - math.log(self.n) - self.dims * math.log(self.bw)

    def log_prob(self, y: torch.Tensor) -> torch.Tensor:
        """Total log probability of y under the KDE."""
        return self.score_samples(y).sum()

    def sample(self, num_samples: int, generator: Optional[torch.Generator] = None,
               idx: Optional[torch.Tensor] = None, eps: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
        """num_samples points: a random center each, plus bw * N(0, I)."""
        dev = self.x.device
        if idx is None:
            idx = torch.randint(0, self.n, (num_samples,), generator=generator, device=dev)
        centers = self.x[idx.to(dev).long()]
        if eps is None:
            eps = torch.randn(centers.shape, generator=generator, device=dev)
        return centers + self.bw * eps.to(dev).float()


class DifferentiableHistogram:
    """Soft (Gaussian-smoothed) histogram PDF of x with an NLL score."""

    def __init__(self, x: torch.Tensor, bins: int = 64, min_range: Optional[float] = None,
                 max_range: Optional[float] = None, bandwidth: float = 0.02):
        x = x.float().flatten()
        lo_x, hi_x = float(x.min()), float(x.max())
        self.bandwidth = bandwidth * (hi_x - lo_x + 1e-12)
        lo = lo_x if min_range is None else min_range
        hi = hi_x if max_range is None else max_range
        edges = torch.linspace(lo, hi, bins + 1, device=x.device)
        self.bin_centers = (edges[:-1] + edges[1:]) / 2.0
        hist = self._weights(x).sum(dim=0)
        self.pdf = hist / hist.sum()

    def _weights(self, y: torch.Tensor) -> torch.Tensor:
        dist = (y[:, None] - self.bin_centers[None, :]) / self.bandwidth
        return torch.exp(-0.5 * dist**2)

    def __call__(self, y: torch.Tensor) -> torch.Tensor:
        """Negative log likelihood of the sample y under the smoothed PDF."""
        likelihoods = (self.pdf[None, :] * self._weights(y.float().flatten())).sum(dim=1)
        return -torch.log(likelihoods + 1e-12).mean()
