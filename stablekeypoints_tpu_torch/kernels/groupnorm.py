"""K6: GroupNorm(+SiLU) for the VAE encoder, forward.

Replaces stablekeypoints_tpu/kernels/groupnorm.py `gn_affine_coeffs` /
`fused_group_norm` (`_coeffs_impl`, stats pallas_call at :110). Input is
channels-last [B, H, W, C] (or [B, HW, C]).

  coefficients (CUDA, `csrc/groupnorm.cu`, one launch): blocks over (row
        chunk, batch element) sum x - ref and (x - ref)^2 per channel with
        16-byte loads, ref the per-channel mean of the batch element's
        first 8 rows (the same in every block, so the sums stay centred:
        mean 30 / std 0.5 stays exact to fp32 rounding); each block writes
        one partial row, the last block to finish of each group of 8
        chunks sums the group's rows, and the last of those per batch
        element sums the groups in order and writes the coefficients
        (m_q, a, b_comp) of `_coeffs_impl`: m_q is the group mean rounded
        to x's dtype, its rounding residue folded into b_comp. Bitwise
        reproducible.
  apply (Triton): (x - m_q) * a + b_comp (+ SiLU), centre-first, each
        step rounded to x's dtype as the JAX apply computes it.

Two launches per GroupNorm and no PyTorch ops between them. Bound on the
card: bytes (x read twice, y written once; a few FLOP per element). The
apply is an elementwise pass, where Triton serves. `gn_affine_coeffs`
alone (one launch, counted on its own) feeds K7, which applies the
coefficients inside its conv (`kernels/gn_conv.py`).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from stablekeypoints_tpu_torch.kernels import _build
from stablekeypoints_tpu_torch.kernels._common import (
    check_kernel_inputs,
    check_launch,
    ptr,
    stream_handle,
)

__all__ = [
    "fused_group_norm",
    "fused_group_norm_plain",
    "fused_group_norm_supported",
    "gn_affine_coeffs",
    "gn_affine_coeffs_plain",
    "gn_apply",
]

_BLOCK_ELEMS = 8192  # x elements per tile (rows x padded channels)


def fused_group_norm_supported(hw: int, c: int, groups: int) -> bool:
    """The JAX package's gate: whole groups, 8-aligned rows, 128-lane channels."""
    return c % groups == 0 and hw % 8 == 0 and c % 128 == 0


def gn_affine_coeffs_plain(x, scale, bias, groups: int, eps: float):
    """Two-pass fp32 statistics -> (m_q, a, b_comp), each [B, C] fp32."""
    b, c = x.shape[0], x.shape[-1]
    groups = math.gcd(groups, c)
    xg = x.reshape(b, -1, groups, c // groups).float()
    mean = xg.mean(dim=(1, 3))  # [B, G]
    var = ((xg - mean[:, None, :, None]) ** 2).mean(dim=(1, 3))
    cg = c // groups
    a = torch.rsqrt(var + eps).repeat_interleave(cg, dim=1) * scale.float()[None]
    mean_c = mean.repeat_interleave(cg, dim=1)
    m_q = mean_c.to(x.dtype).float()  # the value actually subtracted
    b_comp = bias.float()[None] + (m_q - mean_c) * a
    return m_q, a, b_comp


def gn_apply(x, m_q, a, b_comp, act: Optional[str]) -> torch.Tensor:
    """(x - m_q) * a + b_comp (+ SiLU) with every step in x's dtype."""
    dt = x.dtype
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
    y = (x - m_q.to(dt).reshape(shape)) * a.to(dt).reshape(shape) + b_comp.to(dt).reshape(shape)
    if act == "silu":
        y = y * torch.sigmoid(y)
    return y


def fused_group_norm_plain(x, scale, bias, groups=32, eps=1e-5, act=None):
    return gn_apply(x, *gn_affine_coeffs_plain(x, scale, bias, groups, eps), act)


def _check(name, x, scale, bias):
    check_kernel_inputs(name, x, scale, bias, dtype=None)
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"{name}: unsupported dtype {x.dtype}")


def _tiles(hw: int, c: int):
    import triton

    block_c = triton.next_power_of_2(c)
    block_r = max(_BLOCK_ELEMS // block_c, 1)
    return block_r, block_c


def _apply_kernel():
    """The Triton apply kernel, defined on first use (Triton is imported only
    where a kernel launches, so CPU hosts import this module freely)."""
    global _APPLY
    if _APPLY is not None:
        return _APPLY
    import triton
    import triton.language as tl

    @triton.jit
    def apply_kernel(x_ptr, y_ptr, m_ptr, a_ptr, bc_ptr, HW, C,
                     BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr, SILU: tl.constexpr):
        b = tl.program_id(0)
        pid = tl.program_id(1)
        cols = tl.arange(0, BLOCK_C)
        cmask = cols < C
        r = pid * BLOCK_R + tl.arange(0, BLOCK_R)
        mask = (r[:, None] < HW) & cmask[None, :]
        offs = b.to(tl.int64) * HW * C + r[:, None].to(tl.int64) * C + cols[None, :]
        x = tl.load(x_ptr + offs, mask=mask, other=0.0)
        dt = x.dtype
        mq = tl.load(m_ptr + b * C + cols, mask=cmask, other=0.0).to(dt).to(tl.float32)
        a = tl.load(a_ptr + b * C + cols, mask=cmask, other=0.0).to(dt).to(tl.float32)
        bc = tl.load(bc_ptr + b * C + cols, mask=cmask, other=0.0).to(dt).to(tl.float32)
        y = (x.to(tl.float32) - mq[None, :]).to(dt)
        y = (y.to(tl.float32) * a[None, :]).to(dt)
        y = (y.to(tl.float32) + bc[None, :]).to(dt)
        if SILU:
            yf = y.to(tl.float32)
            sig = (1.0 / (1.0 + tl.exp(-yf))).to(dt)
            y = (yf * sig.to(tl.float32)).to(dt)
        tl.store(y_ptr + offs, y, mask=mask)

    _APPLY = apply_kernel
    return _APPLY


_APPLY = None
# codes of the element types the coefficient kernel takes
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# per device: the coefficient kernel's ticket counter buffers, the largest
# last (the kernel leaves them at 0)
_COUNTERS: dict = {}


def _counters(device, b: int) -> torch.Tensor:
    """128 ints a batch element, zeroed once. A larger batch takes a new
    buffer and keeps the old ones: a CUDA graph captured before holds
    their address."""
    bufs = _COUNTERS.setdefault(device, [])
    if not bufs or bufs[-1].numel() < 128 * b:
        bufs.append(torch.zeros(128 * max(b, 16), dtype=torch.int32, device=device))
    return bufs[-1]


def _chunks(b: int, hw: int, c: int, esize: int, device) -> int:
    """Row chunks a batch element is cut into: four blocks an SM over the
    batch (one wave: the kernel's launch bounds fit four), each thread at
    least 8 rows."""
    rows_per_iter = max(256 // (c * esize // 16), 1)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(4 * sms // b, -(-hw // (8 * rows_per_iter))))


def gn_affine_coeffs(x, scale, bias, groups: int = 32, eps: float = 1e-5):
    """(m_q, a, b_comp), each [B, C] fp32; x is [B, H, W, C] or [B, HW, C]."""
    if x.device.type == "cpu":
        return gn_affine_coeffs_plain(x, scale, bias, groups, eps)
    name = "gn_affine_coeffs"
    _check(name, x, scale, bias)
    b, c = x.shape[0], x.shape[-1]
    hw = x.numel() // (b * c)
    groups = math.gcd(groups, c)
    if not fused_group_norm_supported(hw, c, groups) or c * x.element_size() > 4096:
        raise NotImplementedError(
            f"{name}: the kernel takes whole groups, rows % 8 and channels % 128 up to 4096 "
            f"bytes a row; got HW {hw}, C {c}, {groups} groups, {x.dtype}")
    if scale.shape != (c,) or bias.shape != (c,) or scale.dtype != bias.dtype:
        raise ValueError(f"{name}: scale and bias must be [C] of one dtype")
    if scale.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: unsupported parameter dtype {scale.dtype}")
    chunks = _chunks(b, hw, c, x.element_size(), x.device)
    part = torch.empty((b, chunks, 2, c), dtype=torch.float32, device=x.device)
    m_q, a, b_comp = (torch.empty((b, c), dtype=torch.float32, device=x.device)
                      for _ in range(3))
    fn = _build.load("groupnorm").skp_gn_coeffs
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    check_launch(name, fn(ptr(x), ptr(scale), ptr(bias), ptr(part), ptr(_counters(x.device, b)),
                          ptr(m_q), ptr(a), ptr(b_comp), _DTYPE_CODES[x.dtype],
                          _DTYPE_CODES[scale.dtype], b, hw, c, groups, chunks, eps,
                          stream_handle()))
    gn_affine_coeffs.launches += 1
    return m_q, a, b_comp


def fused_group_norm(x, scale, bias, groups: int = 32, eps: float = 1e-5,
                     act: Optional[str] = None) -> torch.Tensor:
    """GroupNorm(x)*scale+bias (+SiLU) in x's dtype; x channels-last."""
    if x.device.type == "cpu":
        return fused_group_norm_plain(x, scale, bias, groups, eps, act)
    m_q, a, b_comp = gn_affine_coeffs(x, scale, bias, groups, eps)
    apply_kernel = _apply_kernel()
    b, c = x.shape[0], x.shape[-1]
    hw = x.numel() // (b * c)
    block_r, block_c = _tiles(hw, c)
    y = torch.empty_like(x)
    apply_kernel[(b, -(-hw // block_r))](
        x, y, m_q, a, b_comp, hw, c, BLOCK_R=block_r, BLOCK_C=block_c,
        SILU=act == "silu", num_warps=8,
    )
    fused_group_norm.launches += 1
    return y


gn_affine_coeffs.launches = 0
fused_group_norm.launches = 0
