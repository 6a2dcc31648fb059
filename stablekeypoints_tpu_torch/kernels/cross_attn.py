"""K3: KV-resident cross-attention over the learned tokens, forward.

Replaces stablekeypoints_tpu/kernels/cross_attn.py
`cross_attention_resident`. The CUDA kernel (`csrc/cross_attn.cu`) keeps
all <= 512 keys and values of one (batch, head) in shared memory and walks
query tiles; fp32 logits and softmax, p rounded to v's dtype before p.v.
Bound on the card: operations (see the source note).
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
from stablekeypoints_tpu_torch.kernels.flash import attention_plain

__all__ = ["cross_attention_plain", "cross_attention_resident", "cross_resident_supported"]

KERNEL_DIMS = (40, 80)


def cross_resident_supported(seq: int, kv_seq: int, dim_head: int) -> bool:
    """The JAX package's band: seq >= 2048, 128-aligned, kv <= 512, d <= 160.
    A head dim in the band but not in KERNEL_DIMS (those whose keys and
    values fit shared memory together) makes the wrapper raise on CUDA."""
    return seq % 128 == 0 and seq >= 2048 and kv_seq <= 512 and dim_head <= 160


# the plain version is the einsum path: q [B,N,H,D], k/v [B,T,H,D] -> [B,N,H,D]
cross_attention_plain = attention_plain


def cross_attention_resident(q, k, v, scale: float) -> torch.Tensor:
    if q.device.type == "cpu":
        return cross_attention_plain(q, k, v, scale)
    name = "cross_attention_resident"
    b, n, h, d = q.shape
    t = k.shape[1]
    if d not in KERNEL_DIMS:
        raise NotImplementedError(
            f"{name}: head dimension {d} is not compiled into the kernel {KERNEL_DIMS}"
        )
    if k.shape != (b, t, h, d) or v.shape != k.shape or not 0 < t <= 512:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    check_kernel_inputs(name, q, k, v)
    out = torch.empty_like(q)
    fn = _build.load("cross_attn").skp_cross_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    check_launch(name, fn(ptr(q), ptr(k), ptr(v), ptr(out), b, n, t, h, d, scale,
                          stream_handle()))
    cross_attention_resident.launches += 1
    return out


cross_attention_resident.launches = 0
