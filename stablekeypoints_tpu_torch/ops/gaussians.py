"""Gaussian bump targets for the sharpening loss.

An unnormalized Gaussian centred at a normalized (y, x) position, evaluated
on a grid of half-pixel centres; for several subjects the per-subject bumps
are averaged (the JAX package's `ops/gaussians.py`).
"""

from __future__ import annotations

import torch

__all__ = ["gaussian_circle", "gaussian_circles"]


def gaussian_circle(pos: torch.Tensor, size: int, sigma: float) -> torch.Tensor:
    """pos [..., 2] normalized (y, x) -> [..., size, size] of
    exp(-d^2 / (2 sigma^2)) at the half-pixel grid centres (peak 1)."""
    p = pos * size
    coords = torch.arange(size, dtype=torch.float32, device=pos.device) + 0.5
    dy = coords - p[..., 0:1]
    dx = coords - p[..., 1:2]
    dist_sq = dy[..., :, None] ** 2 + dx[..., None, :] ** 2
    return torch.exp(-dist_sq / (2.0 * sigma**2))


def gaussian_circles(pos: torch.Tensor, size: int, sigma: float) -> torch.Tensor:
    """pos [num_subjects, batch, 2] (the layout of `find_k_max_pixels`) ->
    [batch, size, size], the mean over subjects."""
    return gaussian_circle(pos, size, sigma).mean(dim=0)
