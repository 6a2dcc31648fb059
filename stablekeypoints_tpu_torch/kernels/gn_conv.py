"""K7: fused GroupNorm-affine + SiLU + 3x3 conv (+ bias, + residual), forward.

Replaces stablekeypoints_tpu/kernels/gn_conv.py `fused_gn_silu_conv3x3`
(`_impl`, pallas_call at :251). The GroupNorm statistics stay global: the
caller takes (m_q, a, b_comp) from K6's `gn_affine_coeffs` and the CUDA
kernel (`csrc/gn_conv.cu`) applies them, the SiLU, the zero pad ring, the
conv (an implicit GEMM on the tensor cores, fp32 accumulation), the bias
and the residual in one pass, so the normalized activation never reaches
device memory. Bound on the card: operations (see the source note).

Forward only, as on the TPU: the VAE encodes under no_grad, and the wrapper
rejects inputs that require grad.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from stablekeypoints_tpu_torch.kernels import _build
from stablekeypoints_tpu_torch.kernels._common import (
    check_kernel_inputs,
    check_launch,
    ptr,
    stream_handle,
)

__all__ = [
    "fused_gn_conv_supported",
    "fused_gn_silu_conv3x3",
    "fused_gn_silu_conv3x3_plain",
]


# The convs K7 runs slower than K6's apply + cuDNN's conv on an H100, as (H,
# W, Cin, Cout) of a conv without a residual: the 512 -> 512 convs at 64^2 -
# 256^2 (1.2-7% slower at batch 10 and batch 2, the same card and call;
# PERF.md §6). With the residual K7 wins at each of them, and at 96^2 it
# wins without.
_H100_UNFUSED = frozenset({(64, 64, 512, 512), (128, 128, 512, 512), (192, 192, 512, 512),
                           (256, 256, 512, 512)})


def fused_gn_conv_supported(h: int, w: int, cin: int, cout: int, stride: int = 1,
                            has_res: bool = True) -> bool:
    """The JAX package's geometric and alignment gate: stride-1 convs of at
    least 8x8 pixels, 128-aligned channels, 8-aligned rows. Its TPU tuning
    (the VMEM fit, the measured skip list, GNCONV_MIN_AREA) does not carry
    over; the port's own measured list (`_H100_UNFUSED`) routes the convs
    without a residual that the unfused path runs faster on the H100."""
    if not has_res and (h, w, cin, cout) in _H100_UNFUSED:
        return False
    return stride == 1 and h >= 8 and w >= 8 and cin % 128 == 0 and cout % 128 == 0 and w % 8 == 0


def fused_gn_silu_conv3x3_plain(x, m, a, b, kernel, conv_bias,
                                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The TPU kernel's arithmetic (`_jnp_reference`): x [B,H,W,Cin],
    m/a/b [B,Cin] fp32, kernel [3,3,Cin,Cout] (HWIO), conv_bias [Cout],
    residual [B,H,W,Cout] -> [B,H,W,Cout] in x's dtype.

    (x - m), * a and + b each rounded to x's dtype; the sigmoid in fp32,
    rounded, then the product; the conv of those values with fp32
    accumulation (fp32 operands holding the x-dtype values), rounded; + bias
    in x's dtype; residual + out."""
    dt = x.dtype
    c = (x.shape[0], 1, 1, x.shape[-1])
    t = (x - m.to(dt).reshape(c)) * a.to(dt).reshape(c) + b.to(dt).reshape(c)
    t = t * torch.sigmoid(t.float()).to(dt)
    y = F.conv2d(t.float().permute(0, 3, 1, 2), kernel.to(dt).float().permute(3, 2, 0, 1),
                 padding=1)
    y = y.permute(0, 2, 3, 1).to(dt) + conv_bias.to(dt)
    if residual is not None:
        y = residual + y
    return y


def fused_gn_silu_conv3x3(x, m, a, b, kernel, conv_bias,
                          residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """silu((x - m) * a + b) (*) kernel + conv_bias (+ residual), one pass.

    On CUDA every shape the gate admits, in bf16. The kernel reads the
    weights as [Cout, 3, 3, Cin] memory (the port's channels-last conv
    weight, whose HWIO view `weight.permute(2, 3, 1, 0)` callers pass);
    other layouts are copied into it."""
    if x.device.type == "cpu":
        return fused_gn_silu_conv3x3_plain(x, m, a, b, kernel, conv_bias, residual)
    name = "fused_gn_silu_conv3x3"
    bsz, h, w, cin = x.shape
    cout = kernel.shape[-1]
    if not fused_gn_conv_supported(h, w, cin, cout):
        raise NotImplementedError(
            f"{name}: the kernel takes stride-1 convs of >= 8x8 pixels with channels % 128 and "
            f"width % 8; got {h}x{w}, {cin} -> {cout}"
        )
    if (kernel.shape != (3, 3, cin, cout) or m.shape != (bsz, cin) or a.shape != (bsz, cin)
            or b.shape != (bsz, cin) or conv_bias.shape != (cout,)
            or (residual is not None and residual.shape != (bsz, h, w, cout))):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)} kernel {tuple(kernel.shape)}")
    w_ohwi = kernel.permute(3, 0, 1, 2).contiguous()
    check_kernel_inputs(name, x, w_ohwi, conv_bias, *(() if residual is None else (residual,)))
    check_kernel_inputs(name, m, a, b, dtype=torch.float32)
    out = torch.empty((bsz, h, w, cout), dtype=x.dtype, device=x.device)
    fn = _build.load("gn_conv").skp_gn_conv
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    check_launch(name, fn(ptr(x), ptr(m), ptr(a), ptr(b), ptr(w_ohwi), ptr(conv_bias),
                          None if residual is None else ptr(residual), ptr(out),
                          bsz, h, w, cin, cout, stream_handle()))
    fused_gn_silu_conv3x3.launches += 1
    return out


fused_gn_silu_conv3x3.launches = 0
