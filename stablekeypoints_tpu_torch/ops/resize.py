"""Image resizing as matrix multiplication.

Separable bilinear/bicubic resampling with torch `F.interpolate(...,
align_corners=False)` tap placement (bicubic a = -0.75, edge-clamped taps),
built as constant (out, in) weight matrices. The matrices, not
`F.interpolate`, define the resize: its bicubic border handling differs
from these clamped taps, and the capture kernel needs the matrix itself.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "resize_matrix",
    "resize_hw",
    "upsample_bicubic_headmajor",
]


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel; a=-0.75 matches torch bicubic."""
    t = np.abs(t)
    out = np.zeros_like(t)
    m1 = t <= 1.0
    m2 = (t > 1.0) & (t < 2.0)
    out[m1] = ((a + 2.0) * t[m1] - (a + 3.0)) * t[m1] * t[m1] + 1.0
    out[m2] = a * (t[m2] * (t[m2] * (t[m2] - 5.0) + 8.0) - 4.0)
    return out


@functools.lru_cache(maxsize=None)
def _resize_matrix_np(in_size: int, out_size: int, method: str) -> np.ndarray:
    """(out_size, in_size) resampling matrix, align_corners=False."""
    scale = in_size / out_size
    src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    t = src - i0

    w = np.zeros((out_size, in_size), dtype=np.float64)
    if method == "bilinear":
        taps = [(0, 1.0 - t), (1, t)]
    elif method == "bicubic":
        taps = [(k, _cubic_kernel(t - k)) for k in (-1, 0, 1, 2)]
    else:
        raise ValueError(f"unknown resize method: {method}")

    rows = np.arange(out_size)
    for offset, weight in taps:
        cols = np.clip(i0 + offset, 0, in_size - 1)  # edge replication
        np.add.at(w, (rows, cols), weight)
    w = w.astype(np.float32)
    w.setflags(write=False)
    return w


def resize_matrix(
    in_size: int, out_size: int, method: str, dtype=torch.float32, device=None
) -> torch.Tensor:
    return torch.from_numpy(_resize_matrix_np(in_size, out_size, method).copy()).to(
        device=device, dtype=dtype
    )


def resize_hw(x: torch.Tensor, out_h: int, out_w: int, method: str) -> torch.Tensor:
    """Resize [..., H, W] -> [..., out_h, out_w]."""
    h, w = x.shape[-2], x.shape[-1]
    wh = resize_matrix(h, out_h, method, x.dtype, x.device)
    ww = resize_matrix(w, out_w, method, x.dtype, x.device)
    x = torch.einsum("oh,...hw->...ow", wh, x)
    return torch.einsum("pw,...ow->...op", ww, x)


def upsample_bicubic_headmajor(x5: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """[b, y, x, k, d] -> [b, k, out_h*out_w, d] bicubic over (y, x):
    row pass, then column pass, emitted head-major."""
    b, h, w, k, d = x5.shape
    wh = resize_matrix(h, out_h, "bicubic", x5.dtype, x5.device)
    ww = resize_matrix(w, out_w, "bicubic", x5.dtype, x5.device)
    t = torch.einsum("Oy,byxkd->bkOxd", wh, x5)
    t = torch.einsum("Px,bkOxd->bkOPd", ww, t)
    return t.reshape(b, k, out_h * out_w, d)
