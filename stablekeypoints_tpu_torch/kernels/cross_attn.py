"""K3: cross-attention over the learned tokens, forward and backward.

Replaces stablekeypoints_tpu/kernels/cross_attn.py
`cross_attention_resident` (forward `_cross_fwd`, backward `_cross_bwd`).
fp32 logits and softmax, p normalised and rounded to v's dtype before p.v,
as the TPU kernel. The forward CUDA kernel (`csrc/cross_attn.cu`) keeps
all <= 512 keys and values of one (batch, head) in shared memory, as the
TPU kernel does, and computes each 64-row query tile's whole softmax at
once, so each score costs one exponential. It is persistent (one block an
SM walking a range of query tiles, k and v loaded once per (batch, head)
it meets, query tiles fed by a producer warp) with its key extent taken
from the token count: at <= 256 tokens each `wgmma` warpgroup scores its
own tiles over all keys; at 500 two warpgroups of 256 keys exchange row
maxima and sums. At d 160 (SD-1.5's 1280-channel levels at 1536^2 and
above) 500 tokens' keys and values do not fit beside a query tile, so the
forward splits them over a cluster of two blocks, each scoring its 256 keys
once (see the source note). The backward saves no residual, as the TPU
kernel, and is query-major as the TPU kernel, in the two passes it shares
with K4/K5 (`csrc/attn_bwd.cuh`): a rows pass recomputes each row's
log-sum-exp and di = sum_t p * dp and writes dq whole, and a keys pass
writes dk and dv. At d 64 the rows pass's statistics sweep (lse2, di) runs
alone, then one keys-major pass of five products (dq summed over a cluster
of key blocks in a fixed order): 7 products a score against the two
passes' 9. No reduce-adds, bitwise reproducible. Bound on the card: the
exponentials, then the products; see the source note.
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
from stablekeypoints_tpu_torch.kernels.flash import attention_plain, bwd_scratch

__all__ = [
    "cross_attention_bwd_plain",
    "cross_attention_plain",
    "cross_attention_resident",
    "cross_attention_resident_bwd",
    "cross_resident_supported",
]

KERNEL_DIMS = (40, 64, 80, 160)


def cross_resident_supported(seq: int, kv_seq: int, dim_head: int) -> bool:
    """The JAX package's band: seq >= 2048, 128-aligned, kv <= 512, d <= 160.
    A head dim in the band but not in KERNEL_DIMS (those compiled into the
    kernel) makes the wrapper raise on CUDA."""
    return seq % 128 == 0 and seq >= 2048 and kv_seq <= 512 and dim_head <= 160


# the plain version is the einsum path: q [B,N,H,D], k/v [B,T,H,D] -> [B,N,H,D]
cross_attention_plain = attention_plain


def cross_attention_bwd_plain(q, k, v, do, scale: float):
    """The TPU kernel's backward arithmetic: p recomputed in fp32,
    dp = do.v^T, di = sum_t p * dp, dsim = p * (dp - di) * scale rounded to
    k's dtype before dq = dsim.k and dk = dsim^T.q, dv = p^T.do with p
    rounded to v's dtype; fp32 sums. Returns (dq, dk, dv)."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = torch.softmax(torch.einsum("bnhd,bthd->bhnt", qf, kf) * scale, dim=-1)
    dp = torch.einsum("bnhd,bthd->bhnt", dof, vf)
    di = (p * dp).sum(-1, keepdim=True)
    dsim = ((p * (dp - di)) * scale).to(k.dtype).float()
    dq = torch.einsum("bhnt,bthd->bnhd", dsim, kf)
    dk = torch.einsum("bhnt,bnhd->bthd", dsim, qf)
    dv = torch.einsum("bhnt,bnhd->bthd", p.to(v.dtype).float(), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(name, q, k, v):
    b, n, h, d = q.shape
    t = k.shape[1]
    if d not in KERNEL_DIMS:
        raise NotImplementedError(
            f"{name}: head dimension {d} is not compiled into the kernel {KERNEL_DIMS}"
        )
    if k.shape != (b, t, h, d) or v.shape != k.shape or not 0 < t <= 512:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)}")


def cross_attention_resident(q, k, v, scale: float) -> torch.Tensor:
    if q.device.type == "cpu":
        return cross_attention_plain(q, k, v, scale)
    name = "cross_attention_resident"
    b, n, h, d = q.shape
    t = k.shape[1]
    _check(name, q, k, v)
    check_kernel_inputs(name, q, k, v, allow_grad=True)
    out = torch.empty_like(q)
    fn = _build.load("cross_attn").skp_cross_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    check_launch(name, fn(ptr(q), ptr(k), ptr(v), ptr(out), b, n, t, h, d, scale,
                          stream_handle()))
    cross_attention_resident.launches += 1
    return out


def cross_attention_resident_bwd(q, k, v, do, scale: float):
    """(q, k, v, do) -> (dq, dk, dv), each in its input's dtype and layout."""
    if q.device.type == "cpu":
        return cross_attention_bwd_plain(q, k, v, do, scale)
    name = "cross_attention_resident_bwd"
    b, n, h, d = q.shape
    t = k.shape[1]
    _check(name, q, k, v)
    if do.shape != q.shape:
        raise ValueError(f"{name}: do {tuple(do.shape)} must be like q {tuple(q.shape)}")
    check_kernel_inputs(name, q, k, v, do, allow_grad=True)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lse, di = (torch.empty((b, h, n), dtype=torch.float32, device=q.device) for _ in range(2))
    lib = _build.load("cross_attn")
    splits, dkv_part = bwd_scratch(lib, q, k)
    fn = lib.skp_cross_bwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    check_launch(name, fn(ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(di), ptr(dkv_part),
                          ptr(dq), ptr(dk), ptr(dv), b, n, t, h, d, splits, scale, stream_handle()))
    cross_attention_resident_bwd.launches += 1
    return dq, dk, dv


cross_attention_resident.launches = 0
cross_attention_resident_bwd.launches = 0
