"""The DDPM noise schedule and the Euler sampler (counterpart of diffusion/schedulers.py).

Scaled-linear betas as diffusers' DDPMScheduler(beta_start=0.00085,
beta_end=0.012, num_train_timesteps=1000) configures for SD1.5/SDXL
checkpoints; `EulerDiscreteSampler` is the validation renders' sampler,
Euler-discrete with "trailing" timestep spacing.
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


@dataclasses.dataclass(frozen=True)
class EulerDiscreteSampler:
    """Euler-discrete sampling with "trailing" spacing (diffusers'
    EulerDiscreteScheduler(timestep_spacing="trailing"), deterministic)."""

    schedule: DDPMSchedule

    def sigmas_and_timesteps(self, num_inference_steps: int):
        """(sigmas [N + 1] float32 ending in 0, timesteps [N] descending):
        t_i = round(T - i·T/N) - 1."""
        T = self.schedule.num_train_timesteps
        ratio = T / num_inference_steps
        timesteps = torch.arange(T, 0, -ratio, dtype=torch.float32).round().long() - 1
        ac = self.schedule.alphas_cumprod[timesteps.to(self.schedule.alphas_cumprod.device)]
        sigmas = torch.sqrt((1.0 - ac) / ac)
        return torch.cat([sigmas, sigmas.new_zeros(1)]), timesteps

    def init_noise_sigma(self, num_inference_steps: int) -> torch.Tensor:
        sigmas, _ = self.sigmas_and_timesteps(num_inference_steps)
        return torch.sqrt(sigmas[0] ** 2 + 1.0)

    @staticmethod
    def scale_model_input(sample: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
        return sample / torch.sqrt(sigma**2 + 1.0).to(sample.dtype)

    def step(self, model_output: torch.Tensor, sigma: torch.Tensor, sigma_next: torch.Tensor,
             sample: torch.Tensor) -> torch.Tensor:
        """One Euler step x_{i+1} = x_i + (sigma_{i+1} - sigma_i) d."""
        if self.schedule.prediction_type == "epsilon":
            pred_original = sample - sigma.to(sample.dtype) * model_output
        elif self.schedule.prediction_type == "v_prediction":
            pred_original = sample / (sigma**2 + 1.0) - model_output * (
                sigma / torch.sqrt(sigma**2 + 1.0)).to(sample.dtype)
        else:
            raise ValueError(f"Unknown prediction type {self.schedule.prediction_type}")
        derivative = (sample - pred_original) / sigma.to(sample.dtype)
        return sample + (sigma_next - sigma).to(sample.dtype) * derivative
