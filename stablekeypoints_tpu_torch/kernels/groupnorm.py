"""K6: GroupNorm(+SiLU) for the VAE encoder, forward (Triton).

Replaces stablekeypoints_tpu/kernels/groupnorm.py `gn_affine_coeffs` /
`fused_group_norm` (`_coeffs_impl`, stats pallas_call at :110). Input is
channels-last [B, H, W, C] (or [B, HW, C]).

  stats (Triton): blocks run in parallel over (batch, row chunk); each
        sums x - ref and (x - ref)^2 per channel, where ref is the
        per-channel mean of the batch element's first row tile (every
        block computes the same ref). Shifting by ref keeps the sums
        centred, so E[x^2] - E[x]^2 never cancels (mean 30 / std 0.5 stays
        exact to fp32 rounding). Partial sums share the shift, so they
        combine by a plain sum.
  coeffs (Triton, one program per (batch, group)): sums the blocks'
        partial sums in a fixed order, the group mean/var from them, and
        the coefficients (m_q, a, b_comp) of `_coeffs_impl`: m_q is the
        mean rounded to x's dtype, its rounding residue folded into b_comp.
  apply (Triton): (x - m_q) * a + b_comp (+ SiLU), centre-first, each
        step rounded to x's dtype as the JAX apply computes it.

Three launches per GroupNorm and no PyTorch ops between them. Bound on
the card: bytes (x read twice, y written once; a few FLOP per element).
Triton serves here: reductions and an elementwise pass. `gn_affine_coeffs`
alone (stats + coeffs, counted on its own) feeds K7, which applies the
coefficients inside its conv (`kernels/gn_conv.py`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from stablekeypoints_tpu_torch.kernels._common import check_kernel_inputs

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


def _triton_kernels():
    """The three Triton kernels, defined on first use (Triton is imported only
    where a kernel launches, so CPU hosts import this module freely)."""
    global _KERNELS
    if _KERNELS is not None:
        return _KERNELS
    import triton
    import triton.language as tl

    @triton.jit
    def stats_kernel(x_ptr, part_ptr, ref_ptr, HW, C, tiles_per_prog,
                     BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        b = tl.program_id(0)
        pid = tl.program_id(1)
        nprog = tl.num_programs(1)
        cols = tl.arange(0, BLOCK_C)
        cmask = cols < C
        rows = tl.arange(0, BLOCK_R)
        base = x_ptr + b.to(tl.int64) * HW * C
        m0 = (rows[:, None] < HW) & cmask[None, :]
        first = tl.load(base + rows[:, None] * C + cols[None, :], mask=m0, other=0.0)
        cnt = tl.minimum(HW, BLOCK_R).to(tl.float32)
        ref = tl.sum(first.to(tl.float32), axis=0) / cnt
        # elementwise partial sums; one reduction over rows after the loop
        s0 = tl.zeros([BLOCK_R, BLOCK_C], dtype=tl.float32)
        s1 = tl.zeros([BLOCK_R, BLOCK_C], dtype=tl.float32)
        for i in range(tiles_per_prog):
            r = (pid * tiles_per_prog + i) * BLOCK_R + rows
            m = (r[:, None] < HW) & cmask[None, :]
            xt = tl.load(base + r[:, None].to(tl.int64) * C + cols[None, :], mask=m, other=0.0)
            xc = tl.where(m, xt.to(tl.float32) - ref[None, :], 0.0)
            s0 += xc
            s1 += xc * xc
        out = part_ptr + (b * nprog + pid).to(tl.int64) * 2 * C
        tl.store(out + cols, tl.sum(s0, axis=0), mask=cmask)
        tl.store(out + C + cols, tl.sum(s1, axis=0), mask=cmask)
        if pid == 0:
            tl.store(ref_ptr + b * C + cols, ref, mask=cmask)

    @triton.jit
    def coeffs_kernel(part_ptr, ref_ptr, w_ptr, bias_ptr, x_ptr, m_ptr, a_ptr, bc_ptr,
                      NPROG, HW, C, CG, eps,
                      BLOCK_P: tl.constexpr, BLOCK_G: tl.constexpr):
        b = tl.program_id(0)
        g = tl.program_id(1)
        p = tl.arange(0, BLOCK_P)
        j = tl.arange(0, BLOCK_G)
        jm = j < CG
        cols = g * CG + j
        pm = (p[:, None] < NPROG) & jm[None, :]
        rows = part_ptr + (b * NPROG + p[:, None]).to(tl.int64) * 2 * C + cols[None, :]
        s0 = tl.sum(tl.load(rows, mask=pm, other=0.0), axis=0)  # [BLOCK_G]
        s1 = tl.sum(tl.load(rows + C, mask=pm, other=0.0), axis=0)
        ref = tl.load(ref_ptr + b * C + cols, mask=jm, other=0.0)
        hw = HW * 1.0
        n = hw * CG
        mean = (tl.sum(s0, axis=0) + hw * tl.sum(ref, axis=0)) / n
        # sum_c sum_s (x - mean)^2 = sum_c [s1 - 2 (mean - ref) s0 + hw (mean - ref)^2]
        dmu = mean - ref
        dev = tl.where(jm, s1 - 2.0 * dmu * s0 + hw * dmu * dmu, 0.0)
        var = tl.maximum(tl.sum(dev, axis=0) / n, 0.0)
        inv = 1.0 / tl.sqrt(var + eps)
        a = inv * tl.load(w_ptr + cols, mask=jm, other=0.0).to(tl.float32)
        m_q = mean.to(x_ptr.dtype.element_ty).to(tl.float32)  # the value subtracted
        b_comp = tl.load(bias_ptr + cols, mask=jm, other=0.0).to(tl.float32) + (m_q - mean) * a
        out = b * C + cols
        tl.store(m_ptr + out, tl.zeros([BLOCK_G], dtype=tl.float32) + m_q, mask=jm)
        tl.store(a_ptr + out, a, mask=jm)
        tl.store(bc_ptr + out, b_comp, mask=jm)

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

    _KERNELS = (stats_kernel, coeffs_kernel, apply_kernel)
    return _KERNELS


_KERNELS = None


def gn_affine_coeffs(x, scale, bias, groups: int = 32, eps: float = 1e-5):
    """(m_q, a, b_comp), each [B, C] fp32; x is [B, H, W, C] or [B, HW, C]."""
    if x.device.type == "cpu":
        return gn_affine_coeffs_plain(x, scale, bias, groups, eps)
    _check("gn_affine_coeffs", x, scale, bias)
    import triton

    stats_kernel, coeffs_kernel, _ = _triton_kernels()
    b, c = x.shape[0], x.shape[-1]
    hw = x.numel() // (b * c)
    groups = math.gcd(groups, c)
    cg = c // groups
    block_r, block_c = _tiles(hw, c)
    n_tiles = -(-hw // block_r)
    nprog = min(n_tiles, max(1, 1024 // b))  # ~1k programs across the batch
    tiles_per_prog = -(-n_tiles // nprog)
    nprog = -(-n_tiles // tiles_per_prog)
    part = torch.empty((b, nprog, 2, c), dtype=torch.float32, device=x.device)
    ref = torch.empty((b, c), dtype=torch.float32, device=x.device)
    stats_kernel[(b, nprog)](
        x, part, ref, hw, c, tiles_per_prog, BLOCK_R=block_r, BLOCK_C=block_c, num_warps=8
    )
    m_q, a, b_comp = (torch.empty((b, c), dtype=torch.float32, device=x.device)
                      for _ in range(3))
    coeffs_kernel[(b, groups)](
        part, ref, scale, bias, x, m_q, a, b_comp, nprog, hw, c, cg, eps,
        BLOCK_P=triton.next_power_of_2(nprog), BLOCK_G=triton.next_power_of_2(cg), num_warps=4,
    )
    gn_affine_coeffs.launches += 1
    return m_q, a, b_comp


def fused_group_norm(x, scale, bias, groups: int = 32, eps: float = 1e-5,
                     act: Optional[str] = None) -> torch.Tensor:
    """GroupNorm(x)*scale+bias (+SiLU) in x's dtype; x channels-last."""
    if x.device.type == "cpu":
        return fused_group_norm_plain(x, scale, bias, groups, eps, act)
    m_q, a, b_comp = gn_affine_coeffs(x, scale, bias, groups, eps)
    *_, apply_kernel = _triton_kernels()
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
