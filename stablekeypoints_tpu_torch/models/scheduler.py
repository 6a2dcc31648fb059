"""DDIM noise schedule (scaled-linear betas, SD training schedule).

Constant tables built in numpy exactly as the JAX package builds them;
`add_noise` works on torch tensors on any device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["DDIMSchedule"]


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    alphas_cumprod: np.ndarray  # [num_train_timesteps] fp32
    timesteps: np.ndarray  # [num_inference_steps], descending
    num_train_timesteps: int = 1000

    @staticmethod
    def create(
        num_inference_steps: int = 50,
        beta_start: float = 0.00085,
        beta_end: float = 0.012,
        num_train_timesteps: int = 1000,
        steps_offset: int = 0,
    ) -> "DDIMSchedule":
        betas = (
            np.linspace(
                beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=np.float64
            )
            ** 2
        )
        alphas_cumprod = np.cumprod(1.0 - betas).astype(np.float32)
        step_ratio = num_train_timesteps // num_inference_steps
        timesteps = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1]
        timesteps = (timesteps + steps_offset).astype(np.int32)
        return DDIMSchedule(alphas_cumprod, timesteps, num_train_timesteps)

    def timestep_at(self, noise_level: int) -> int:
        """timesteps[noise_level]; the default -1 is the least noisy step."""
        return int(self.timesteps[noise_level])

    def add_noise(self, sample: torch.Tensor, noise: torch.Tensor, t: int) -> torch.Tensor:
        """sqrt(acp_t) * sample + sqrt(1 - acp_t) * noise, in sample's dtype."""
        acp = np.float32(self.alphas_cumprod[int(t)])
        sqrt_acp = torch.tensor(np.sqrt(acp), dtype=torch.float32).to(sample.dtype)
        sqrt_one_minus = torch.tensor(
            np.sqrt(np.float32(1.0) - acp), dtype=torch.float32
        ).to(sample.dtype)
        return sqrt_acp.to(sample.device) * sample + sqrt_one_minus.to(sample.device) * noise
