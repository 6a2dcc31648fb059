"""Keypoint extraction from attention heatmaps (argmax family).

Coordinates are (y, x) = (row, col) with half-pixel centering.
"""

from __future__ import annotations

import torch

__all__ = ["find_k_max_pixels", "find_max_pixel", "mask_radius", "pixel_from_weighted_avg"]


def find_max_pixel(maps: torch.Tensor) -> torch.Tensor:
    """[B, H, W] -> [B, 2] of (row + 0.5, col + 0.5); first maximum wins."""
    b, h, w = maps.shape
    flat_idx = torch.argmax(maps.reshape(b, -1), dim=-1)
    rows = torch.div(flat_idx, w, rounding_mode="floor")
    cols = flat_idx % w
    return torch.stack([rows, cols], dim=-1).to(torch.float32) + 0.5


def mask_radius(maps: torch.Tensor, coords: torch.Tensor, radius: float) -> torch.Tensor:
    """Zero the pixels within `radius` (squared distance <= radius^2) of
    coords [B, 2] (y, x, pixel units); maps [B, H, W]."""
    b, h, w = maps.shape
    ys = torch.arange(h, dtype=torch.float32, device=maps.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=maps.device)[None, None, :]
    dist_sq = (xs - coords[:, 1, None, None]) ** 2 + (ys - coords[:, 0, None, None]) ** 2
    return maps * (dist_sq > radius**2).to(maps.dtype)


def find_k_max_pixels(maps: torch.Tensor, num: int) -> torch.Tensor:
    """Iterative argmax: take the max, zero a disc of radius 0.05*H around
    it, repeat. [B, H, W] -> [num, B, 2]."""
    radius = 0.05 * maps.shape[1]
    points = []
    for _ in range(num):
        point = find_max_pixel(maps)
        points.append(point)
        maps = mask_radius(maps, point, radius)
    return torch.stack(points)


def pixel_from_weighted_avg(maps: torch.Tensor, distance: float = 5.0) -> torch.Tensor:
    """Soft-argmax within `distance` pixels of the floored hard argmax.
    [B, H, W] -> [B, 2] of (y, x) + 0.5; distance=-1 skips the masking."""
    b, m, n = maps.shape
    ys = torch.arange(m, dtype=torch.float32, device=maps.device)[None, :, None]
    xs = torch.arange(n, dtype=torch.float32, device=maps.device)[None, None, :]
    if distance != -1:
        max_px = torch.floor(find_max_pixel(maps))
        dist = torch.sqrt(
            (ys - max_px[:, 0, None, None]) ** 2 + (xs - max_px[:, 1, None, None]) ** 2
        )
        maps = torch.where(dist > distance, torch.zeros_like(maps), maps)
    total = torch.sum(maps, dim=(1, 2), keepdim=True)
    norm = maps / (total + 1e-6)
    y_avg = torch.sum(ys * norm, dim=(1, 2))
    x_avg = torch.sum(xs * norm, dim=(1, 2))
    return torch.stack([y_avg, x_avg], dim=-1) + 0.5
