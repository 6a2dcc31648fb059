"""Training losses: sharpening and equivariance (the JAX package's
`ops/losses.py`).

- sharpening: each selected map should look like a Gaussian bump at its
  own (iteratively masked) argmax; the argmax positions carry no gradient.
- equivariance: the maps of the affine-transformed image, inverse-warped,
  should match the maps of the original image.
"""

from __future__ import annotations

import torch

from stablekeypoints_tpu_torch.ops.gaussians import gaussian_circles
from stablekeypoints_tpu_torch.ops.keypoints import find_k_max_pixels
from stablekeypoints_tpu_torch.ops.transforms import apply_inverse_affine

__all__ = ["equivariance_loss", "sharpening_loss"]


def sharpening_loss(maps: torch.Tensor, sigma: float = 1.0, num_subjects: int = 1) -> torch.Tensor:
    """MSE between maps [K, H, W] and Gaussians at their own argmaxes."""
    h = maps.shape[-1]
    pos = find_k_max_pixels(maps.detach(), num=num_subjects) / h
    target = gaussian_circles(pos, size=h, sigma=sigma)
    return torch.mean((maps - target) ** 2)


def equivariance_loss(maps: torch.Tensor, maps_transformed: torch.Tensor,
                      theta: torch.Tensor) -> torch.Tensor:
    """MSE(maps, inverse-warp(maps_transformed)); maps [K, H, W], theta
    [2, 3] the affine that produced the transformed image. The K maps ride
    the warp as the channels of one image."""
    warped = apply_inverse_affine(maps_transformed.permute(1, 2, 0)[None], theta[None])
    return torch.mean((maps - warped[0].permute(2, 0, 1)) ** 2)
