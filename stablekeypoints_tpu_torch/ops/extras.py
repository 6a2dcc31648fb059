"""Alternative ops of the reference kept for completeness (the JAX
package's `ops/extras.py`): not on the default path, but useful
alternatives (a variance regularizer, a differentiable soft-argmax,
cross-image correspondence scoring)."""

from __future__ import annotations

import torch

from stablekeypoints_tpu_torch.ops.keypoints import find_max_pixel
from stablekeypoints_tpu_torch.ops.resize import resize_hw

__all__ = [
    "differentiable_argmax",
    "find_corresponding_points",
    "find_pos_from_index",
    "gaussian_kernel_2d",
    "gaussian_loss",
    "mask_attn",
    "variance_loss",
]


def gaussian_kernel_2d(size: int, sigma: float) -> torch.Tensor:
    """Normalized 2-D Gaussian kernel [size, size] (optimize.py:82-103)."""
    coords = torch.arange(size, dtype=torch.float32) - size // 2
    x, y = torch.meshgrid(coords, coords, indexing="xy")
    k = torch.exp(-(x**2 + y**2) / (2.0 * sigma**2))
    return k / k.sum()


def gaussian_loss(attn_map: torch.Tensor, kernel_size: int = 5, sigma: float = 1.0,
                  temperature: float = 1e-4) -> torch.Tensor:
    """MSE between the maps [T, H, W] and their own detached softmax(map / T):
    the reference's executed semantics (optimize.py:106-135; its blurred
    target is never used, so kernel_size and sigma change nothing)."""
    del kernel_size, sigma
    t, h, w = attn_map.shape
    p = torch.softmax(attn_map.reshape(t, -1) / temperature, dim=-1).reshape(t, h, w)
    return ((attn_map - p.detach()) ** 2).mean()


def _normalized_coords(heatmaps: torch.Tensor):
    _, m, n = heatmaps.shape
    p = heatmaps / (heatmaps.sum(dim=(1, 2), keepdim=True) + 1e-6)
    ys = torch.arange(m, dtype=torch.float32, device=heatmaps.device)[None, :, None]
    xs = torch.arange(n, dtype=torch.float32, device=heatmaps.device)[None, None, :]
    return p, ys, xs


def variance_loss(heatmaps: torch.Tensor) -> torch.Tensor:
    """Mean spatial standard deviation of the normalized heatmaps [B, M, N]
    (optimize.py:209-241)."""
    p, ys, xs = _normalized_coords(heatmaps)
    y_avg = (ys * p).sum(dim=(1, 2), keepdim=True)
    x_avg = (xs * p).sum(dim=(1, 2), keepdim=True)
    var = (p * ((ys - y_avg) ** 2 + (xs - x_avg) ** 2)).sum(dim=(1, 2))
    return torch.sqrt(var).mean()


def differentiable_argmax(heatmaps: torch.Tensor) -> torch.Tensor:
    """Soft-argmax [B, M, N] -> [B, 2] expected (y, x) (optimize.py:244-266)."""
    p, ys, xs = _normalized_coords(heatmaps)
    return torch.stack([(ys * p).sum(dim=(1, 2)), (xs * p).sum(dim=(1, 2))], dim=-1)


def find_corresponding_points(maps_a: torch.Tensor, maps_b: torch.Tensor, num_points: int = 10):
    """Tokens ranked by the product of their peak values in two images' maps
    [T, H, W]; -> (the best `num_points` tokens, their argmax pixels in
    a, in b) (eval.py:159-195's correspondence scoring)."""
    t = maps_a.shape[0]
    score = maps_a.reshape(t, -1).amax(dim=-1) * maps_b.reshape(t, -1).amax(dim=-1)
    order = torch.argsort(-score, stable=True)[:num_points]
    return order, find_max_pixel(maps_a[order]), find_max_pixel(maps_b[order])


def mask_attn(image: torch.Tensor, attn_map: torch.Tensor) -> torch.Tensor:
    """Zero the maps [C, h, w] where the image [H, W, 3], bilinearly resized
    to h x w and averaged over its channels, is zero (ptp_utils.py:275-286:
    background-masked datasets)."""
    _, h, w = attn_map.shape
    down = resize_hw(image.permute(2, 0, 1), h, w, "bilinear").mean(dim=0)
    return attn_map * (down != 0).to(attn_map.dtype)


def find_pos_from_index(attn_map: torch.Tensor) -> torch.Tensor:
    """Argmax of each map [T, H, W] as normalized (x, y) in [0, 1]
    (optimize.py:138-154: [col, row] over (dim - 1))."""
    t, h, w = attn_map.shape
    idx = torch.argmax(attn_map.reshape(t, -1), dim=-1)
    rows = torch.div(idx, w, rounding_mode="floor").to(torch.float32) / (h - 1)
    cols = (idx % w).to(torch.float32) / (w - 1)
    return torch.stack([cols, rows], dim=1)
