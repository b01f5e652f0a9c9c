"""The DDPM training noise schedule (counterpart of diffusion/schedulers.py).

Scaled-linear betas as diffusers' DDPMScheduler(beta_start=0.00085,
beta_end=0.012, num_train_timesteps=1000) configures for SD1.5/SDXL
checkpoints. The Euler sampler of the JAX module belongs to the inference
slice.
"""

from __future__ import annotations

import dataclasses

import torch


def _broadcast_to_sample(coeffs: torch.Tensor, sample_ndim: int) -> torch.Tensor:
    return coeffs.reshape(coeffs.shape + (1,) * (sample_ndim - 1))


@dataclasses.dataclass(frozen=True)
class DDPMSchedule:
    alphas_cumprod: torch.Tensor  # [T] float32
    num_train_timesteps: int
    prediction_type: str

    @classmethod
    def create(cls, num_train_timesteps: int = 1000, beta_start: float = 0.00085,
               beta_end: float = 0.012, beta_schedule: str = "scaled_linear",
               prediction_type: str = "epsilon", device="cuda") -> "DDPMSchedule":
        if beta_schedule == "scaled_linear":
            betas = torch.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps,
                                   dtype=torch.float32) ** 2
        elif beta_schedule == "linear":
            betas = torch.linspace(beta_start, beta_end, num_train_timesteps, dtype=torch.float32)
        else:
            raise ValueError(f"Unknown beta_schedule: {beta_schedule}")
        alphas_cumprod = torch.cumprod(1.0 - betas, dim=0).to(device)
        return cls(alphas_cumprod, num_train_timesteps, prediction_type)

    def sqrt_alpha_sigma(self, timesteps: torch.Tensor):
        """(sqrt(abar_t), sqrt(1 - abar_t)) per batch element, float32."""
        ac = self.alphas_cumprod[timesteps.long()]
        return torch.sqrt(ac), torch.sqrt(1.0 - ac)

    def add_noise(self, sample, noise, timesteps):
        """x_t = sqrt(abar_t) x_0 + sqrt(1 - abar_t) eps."""
        sa, ss = self.sqrt_alpha_sigma(timesteps)
        sa = _broadcast_to_sample(sa, sample.ndim).to(sample.dtype)
        ss = _broadcast_to_sample(ss, sample.ndim).to(sample.dtype)
        return sa * sample + ss * noise

    def get_velocity(self, sample, noise, timesteps):
        """v_t = sqrt(abar_t) eps - sqrt(1 - abar_t) x_0."""
        sa, ss = self.sqrt_alpha_sigma(timesteps)
        sa = _broadcast_to_sample(sa, sample.ndim).to(sample.dtype)
        ss = _broadcast_to_sample(ss, sample.ndim).to(sample.dtype)
        return sa * noise - ss * sample

    def compute_snr(self, timesteps: torch.Tensor) -> torch.Tensor:
        """SNR(t) = abar_t / (1 - abar_t)."""
        ac = self.alphas_cumprod[timesteps.long()]
        return ac / (1.0 - ac)
