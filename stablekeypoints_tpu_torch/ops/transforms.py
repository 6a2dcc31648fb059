"""Invertible affine augmentation on NHWC tensors.

A random rotation/scale/translation per batch element, applied through an
affine sampling grid and a bilinear resample with zero padding
(align_corners=False), with the exact inverse warp from the same theta.
Thetas are plain tensors; `sample_thetas` draws them from a
`torch.Generator`, and callers may pass their own.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

__all__ = [
    "AffineParams",
    "make_theta",
    "sample_thetas",
    "invert_theta",
    "affine_grid",
    "grid_sample_bilinear",
    "apply_affine",
    "apply_affine_fill",
    "apply_inverse_affine",
]


class AffineParams(NamedTuple):
    """Ranges for random affine sampling."""

    degrees: float = 15.0
    scale: tuple[float, float] = (0.8, 1.0)
    translate: tuple[float, float] = (0.25, 0.25)


def make_theta(angle_deg, scale, tx, ty) -> torch.Tensor:
    """theta = [[c, s, tx], [-s, c, ty]] with c, s = scale*(cos, sin).
    Accepts [B]-tensors; returns [B, 2, 3] fp32."""
    angle = torch.deg2rad(torch.as_tensor(angle_deg, dtype=torch.float32))
    scale = torch.as_tensor(scale, dtype=torch.float32)
    c = torch.cos(angle) * scale
    s = torch.sin(angle) * scale
    tx = torch.as_tensor(tx, dtype=torch.float32) * torch.ones_like(c)
    ty = torch.as_tensor(ty, dtype=torch.float32) * torch.ones_like(c)
    row0 = torch.stack([c, s, tx], dim=-1)
    row1 = torch.stack([-s, c, ty], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def sample_thetas(
    generator: Optional[torch.Generator], batch: int, params: AffineParams
) -> torch.Tensor:
    """Draw [B, 2, 3] random thetas (uniform angle, scale, translation) on
    the generator's device."""

    device = generator.device if generator is not None else None

    def uniform(lo, hi):
        u = torch.rand(batch, generator=generator, dtype=torch.float32, device=device)
        return lo + (hi - lo) * u

    angle = uniform(-params.degrees, params.degrees)
    scale = uniform(params.scale[0], params.scale[1])
    tx = uniform(-params.translate[0], params.translate[0])
    ty = uniform(-params.translate[1], params.translate[1])
    return make_theta(angle, scale, tx, ty)


def invert_theta(theta: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of [..., 2, 3] affine matrices."""
    a, b, tx = theta[..., 0, 0], theta[..., 0, 1], theta[..., 0, 2]
    c, d, ty = theta[..., 1, 0], theta[..., 1, 1], theta[..., 1, 2]
    det = a * d - b * c
    ia, ib = d / det, -b / det
    ic, id_ = -c / det, a / det
    itx = -(ia * tx + ib * ty)
    ity = -(ic * tx + id_ * ty)
    row0 = torch.stack([ia, ib, itx], dim=-1)
    row1 = torch.stack([ic, id_, ity], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def affine_grid(theta: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[B, H, W, 2] (x, y) normalized source coordinates, half-pixel centers."""
    dev = theta.device
    xs = (2.0 * torch.arange(width, dtype=torch.float32, device=dev) + 1.0) / width - 1.0
    ys = (2.0 * torch.arange(height, dtype=torch.float32, device=dev) + 1.0) / height - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # [H, W, 3]
    return torch.einsum("hwk,bok->bhwo", base, theta.to(torch.float32))


# bits of fixed point below the largest contribution in scatter_add_fixed
FIXED_BITS = 40


def scatter_add_fixed(rows: torch.Tensor, values: torch.Tensor, n: int) -> torch.Tensor:
    """out[r] = sum of values[i] over rows[i] == r, values [P, C] -> [n, C]
    fp64, summed in fixed point (2^-FIXED_BITS of the largest |value|) by
    integer adds: bitwise the same whatever order the adds land in."""
    scale = 2.0**FIXED_BITS / values.abs().amax().double().clamp_min(1e-300)
    q = torch.round(values.double() * scale).long()
    acc = torch.zeros((n, values.shape[1]), dtype=torch.int64, device=values.device)
    return acc.index_add_(0, rows, q).double() / scale


class _GridSample(torch.autograd.Function):
    """F.grid_sample (bilinear, zero padding, align_corners=False) whose
    image gradient is the transpose of its taps and weights summed by
    scatter_add_fixed. F.grid_sample's CUDA backward adds the four taps of
    every output pixel with float atomics, in no fixed order, so two runs'
    gradients differ in their last bits (the JAX package's gather
    transposes to a deterministic scatter-add). No gradient flows to the
    grid (the port's thetas carry none)."""

    @staticmethod
    def forward(ctx, img, grid):  # img [B, C, H, W], grid [B, Ho, Wo, 2]
        ctx.save_for_backward(grid)
        ctx.img_shape, ctx.img_dtype = img.shape, img.dtype
        return F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=False)

    @staticmethod
    def backward(ctx, g):  # g [B, C, Ho, Wo]
        if ctx.needs_input_grad[1]:
            raise NotImplementedError("grid_sample_bilinear: no gradient with respect to the grid")
        (grid,) = ctx.saved_tensors
        b, c, h, w = ctx.img_shape
        x = ((grid[..., 0].float() + 1) * w - 1) / 2
        y = ((grid[..., 1].float() + 1) * h - 1) / 2
        x0, y0 = torch.floor(x), torch.floor(y)
        base = torch.arange(b, device=g.device).view(b, 1, 1) * (h * w)
        gn = g.float().permute(0, 2, 3, 1).reshape(-1, c)
        rows, vals = [], []
        for xi, wx in ((x0, x0 + 1 - x), (x0 + 1, x - x0)):
            for yi, wy in ((y0, y0 + 1 - y), (y0 + 1, y - y0)):
                ok = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
                rows.append((base + yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()).reshape(-1))
                vals.append(gn * (wx * wy * ok).reshape(-1, 1))
        grad = scatter_add_fixed(torch.cat(rows), torch.cat(vals), b * h * w)
        return grad.reshape(b, h, w, c).permute(0, 3, 1, 2).to(ctx.img_dtype), None


def grid_sample_bilinear(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling with zero padding, align_corners=False.

    img [B, H, W, C], grid [B, Ho, Wo, 2] -> [B, Ho, Wo, C]. The taps and
    weights are those of `F.grid_sample` (each out-of-frame corner reads 0);
    the image gradient is bitwise reproducible (`_GridSample`).
    """
    return _GridSample.apply(img.permute(0, 3, 1, 2), grid.to(img.dtype)).permute(0, 2, 3, 1)


def apply_affine(img: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Forward transform (the JAX package's `apply_affine`, whose `params`
    only select a TPU matmul form of the same warp)."""
    return grid_sample_bilinear(img, affine_grid(theta, img.shape[1], img.shape[2]))


def apply_inverse_affine(img: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Inverse transform: the warp by invert_theta(theta)."""
    return apply_affine(img, invert_theta(theta))



def apply_affine_fill(img: torch.Tensor, theta: torch.Tensor, fill) -> torch.Tensor:
    """Forward warp with a per-channel constant `fill` [C] outside the source
    frame: an all-ones coverage channel is warped with the image and
    fill * (1 - coverage) added, so fully outside pixels read `fill` and
    edge pixels blend linearly. The latent-space warp fills with the latent
    of a black image rather than 0."""
    b, h, w, c = img.shape
    mask = torch.ones((b, h, w, 1), dtype=img.dtype, device=img.device)
    out = apply_affine(torch.cat([img, mask], dim=-1), theta)
    fill = torch.as_tensor(fill, dtype=out.dtype, device=out.device).reshape(1, 1, 1, c)
    return out[..., :c] + (1.0 - out[..., c:]) * fill
