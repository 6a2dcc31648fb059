"""DDIM noise schedule (scaled-linear betas, SD training schedule).

Constant tables built in numpy exactly as the JAX package builds them;
`add_noise` and `ddim_step` work on torch tensors on any device, with the
table values taken as fp32 scalars.
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
        """sqrt(acp_t) * sample + sqrt(1 - acp_t) * noise, in sample's dtype.
        The factors stay 0-dim host tensors, which a CUDA op reads as
        scalars: no host-to-device copy (none may run inside a CUDA graph
        capture)."""
        acp = np.float32(self.alphas_cumprod[int(t)])
        sqrt_acp = torch.tensor(np.sqrt(acp), dtype=torch.float32).to(sample.dtype)
        sqrt_one_minus = torch.tensor(
            np.sqrt(np.float32(1.0) - acp), dtype=torch.float32
        ).to(sample.dtype)
        return sqrt_acp * sample + sqrt_one_minus * noise

    def ddim_step(self, eps: torch.Tensor, latents: torch.Tensor, step_index: int) -> torch.Tensor:
        """One deterministic DDIM update x_t -> x_{t-dt} (eta = 0) at
        `timesteps[step_index]`; the final step's previous alpha is
        alphas_cumprod[0] (diffusers' set_alpha_to_one=False)."""
        t = int(self.timesteps[step_index])
        prev_t = t - self.num_train_timesteps // len(self.timesteps)
        alpha_t = np.float32(self.alphas_cumprod[t])
        alpha_prev = np.float32(self.alphas_cumprod[max(prev_t, 0)])
        one = np.float32(1.0)
        x0 = (latents - float(np.sqrt(one - alpha_t)) * eps) / float(np.sqrt(alpha_t))
        return float(np.sqrt(alpha_prev)) * x0 + float(np.sqrt(one - alpha_prev)) * eps
