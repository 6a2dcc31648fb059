"""K4/K5: flash (online-softmax) attention, forward.

Replaces stablekeypoints_tpu/kernels/flash.py `flash_self_attention` (K4)
and `flash_cross_attention` (K5). Both run one hand-written CUDA kernel
(`csrc/flash.cu`); K5 is that kernel with a kv-length mask instead of
padded keys and segment ids. Bound on the card: operations (4*N*M*D FLOP;
see the source note). Layout at the public functions is the JAX
package's [B, N, heads, d].
"""

from __future__ import annotations

import ctypes

import torch

from stablekeypoints_tpu_torch.kernels import _build
from stablekeypoints_tpu_torch.kernels._common import (
    check_kernel_inputs,
    check_launch,
    ptr,
    stream_handle,
)

__all__ = [
    "attention_plain",
    "flash_self_attention",
    "flash_cross_attention",
    "flash_supported",
    "KERNEL_DIMS",
]

KERNEL_DIMS = (40, 80, 512)


def flash_supported(seq: int, kv_seq: int, dim_head: int) -> bool:
    """The JAX package's routing rule: long, 128-aligned sequences, head
    dims <= 128 or a multiple of 128. A head dim that passes here but is
    not in KERNEL_DIMS makes the wrapper raise on a CUDA tensor."""
    if seq % 128 != 0 or kv_seq % 128 != 0:
        return False
    if dim_head > 128 and dim_head % 128 != 0:
        return False
    return seq >= 1024


def attention_plain(q, k, v, scale: float) -> torch.Tensor:
    """The einsum path: fp32 logits and softmax, p cast to v's dtype, fp32
    accumulation, output in q's dtype. q [B,N,H,D], k/v [B,M,H,D]."""
    sim = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
    attn = torch.softmax(sim * scale, dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", attn.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _launch(name, q, k, v, scale):
    b, n, h, d = q.shape
    m = k.shape[1]
    if d not in KERNEL_DIMS:
        raise NotImplementedError(
            f"{name}: head dimension {d} is not compiled into the kernel {KERNEL_DIMS}"
        )
    if k.shape != (b, m, h, d) or v.shape != k.shape or m == 0:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    check_kernel_inputs(name, q, k, v)
    out = torch.empty_like(q)
    lib = _build.load("flash")
    fn = lib.skp_flash_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(ptr(q), ptr(k), ptr(v), ptr(out), b, n, m, h, d, scale, stream_handle())
    check_launch(name, err)
    return out


def flash_self_attention(q, k, v, scale: float) -> torch.Tensor:
    """K4: [B, N, heads, d] -> [B, N, heads, d] in q's dtype."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    out = _launch("flash_self_attention", q, k, v, scale)
    flash_self_attention.launches += 1
    return out


def flash_cross_attention(q, k, v, scale: float) -> torch.Tensor:
    """K5: attention over M learned tokens, M not a multiple of the key tile
    (the kernel masks the tail tile). [B, N, heads, d] -> [B, N, heads, d]."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    out = _launch("flash_cross_attention", q, k, v, scale)
    flash_cross_attention.launches += 1
    return out


flash_self_attention.launches = 0
flash_cross_attention.launches = 0
