"""K4/K5: flash (online-softmax) attention, forward and backward.

Replaces stablekeypoints_tpu/kernels/flash.py `flash_self_attention` (K4)
and `flash_cross_attention` (K5), which call JAX's stock Pallas TPU flash
kernels (forward, and their dq / dkv backward kernels). Both run one
hand-written CUDA kernel per direction (`csrc/flash.cu`); K5 is that kernel
with a kv-length mask instead of padded keys and segment ids. The forward
optionally writes each row's log-sum-exp (fp32, log2 domain) for the
backward, which is FlashAttention-2's: di = rowsum(dO * O), then one kernel
over key tiles (dk, dv in registers, looping over query tiles) and one over
query tiles (dq). Bound on the card: operations (forward 4*N*M*D FLOP,
backward 10*N*M*D; see the source note). Layout at the public functions is
the JAX package's [B, N, heads, d].
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
    "attention_bwd_plain",
    "flash_self_attention",
    "flash_self_attention_bwd",
    "flash_cross_attention",
    "flash_cross_attention_bwd",
    "flash_supported",
    "KERNEL_DIMS",
    "BWD_DIMS",
]

KERNEL_DIMS = (40, 80, 512)
BWD_DIMS = (40, 80)  # the VAE's d 512 attention is never differentiated


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


def attention_bwd_plain(q, k, v, o, do, scale: float):
    """The stock flash backward's arithmetic: p recomputed in fp32,
    di = rowsum(o * do) from the forward output, ds = (dp - di) * p * scale
    rounded to k's dtype before dq = ds.k and dk = ds^T.q, dv = p^T.do with
    p rounded to do's dtype; fp32 sums. Returns (dq, dk, dv)."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", qf, kf) * scale, dim=-1)
    dv = torch.einsum("bhnm,bnhd->bmhd", p.to(do.dtype).float(), dof)
    dp = torch.einsum("bnhd,bmhd->bhnm", dof, vf)
    di = torch.einsum("bnhd,bnhd->bhn", o.float(), dof)
    ds = ((dp - di[..., None]) * p * scale).to(k.dtype).float()
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, qf)
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, kf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_shapes(name, q, k, v, dims):
    b, n, h, d = q.shape
    m = k.shape[1]
    if d not in dims:
        raise NotImplementedError(
            f"{name}: head dimension {d} is not compiled into the kernel {dims}"
        )
    if k.shape != (b, m, h, d) or v.shape != k.shape or m == 0:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)}")


def _launch(name, q, k, v, scale, with_lse):
    b, n, h, d = q.shape
    m = k.shape[1]
    _check_shapes(name, q, k, v, BWD_DIMS if with_lse else KERNEL_DIMS)
    check_kernel_inputs(name, q, k, v, allow_grad=True)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device) if with_lse else None
    fn = _build.load("flash").skp_flash_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(ptr(q), ptr(k), ptr(v), ptr(out), ctypes.c_void_p(lse.data_ptr() if with_lse else None),
             b, n, m, h, d, scale, stream_handle())
    check_launch(name, err)
    return out, lse


def _launch_bwd(name, q, k, v, o, do, lse, scale):
    b, n, h, d = q.shape
    m = k.shape[1]
    _check_shapes(name, q, k, v, BWD_DIMS)
    if o.shape != q.shape or do.shape != q.shape or lse is None or lse.shape != (b, h, n):
        raise ValueError(f"{name}: o, do must be like q and lse [B, H, N] from the forward")
    check_kernel_inputs(name, q, k, v, o, do, allow_grad=True)
    check_kernel_inputs(name, lse, dtype=torch.float32)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    di = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    fn = _build.load("flash").skp_flash_bwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(ptr(q), ptr(k), ptr(v), ptr(o), ptr(do), ptr(lse), ptr(di), ptr(dq), ptr(dk),
             ptr(dv), b, n, m, h, d, scale, stream_handle())
    check_launch(name, err)
    return dq, dk, dv


def flash_self_attention(q, k, v, scale: float, with_lse: bool = False):
    """K4: [B, N, heads, d] -> [B, N, heads, d] in q's dtype. With
    `with_lse`, returns (out, lse) where lse [B, heads, N] fp32 is the
    residual the backward kernel reads (None on the CPU, whose plain
    backward recomputes the softmax)."""
    if q.device.type == "cpu":
        out, lse = attention_plain(q, k, v, scale), None
    else:
        out, lse = _launch("flash_self_attention", q, k, v, scale, with_lse)
        flash_self_attention.launches += 1
    return (out, lse) if with_lse else out


def flash_cross_attention(q, k, v, scale: float, with_lse: bool = False):
    """K5: attention over M learned tokens, M not a multiple of the key tile
    (the kernel masks the tail tile). [B, N, heads, d] -> [B, N, heads, d];
    `with_lse` as in `flash_self_attention`."""
    if q.device.type == "cpu":
        out, lse = attention_plain(q, k, v, scale), None
    else:
        out, lse = _launch("flash_cross_attention", q, k, v, scale, with_lse)
        flash_cross_attention.launches += 1
    return (out, lse) if with_lse else out


def flash_self_attention_bwd(q, k, v, o, do, lse, scale: float):
    """K4 backward: (q, k, v, the forward's output o and lse, do) ->
    (dq, dk, dv), each in its input's dtype and layout."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, o, do, scale)
    grads = _launch_bwd("flash_self_attention_bwd", q, k, v, o, do, lse, scale)
    flash_self_attention_bwd.launches += 1
    return grads


def flash_cross_attention_bwd(q, k, v, o, do, lse, scale: float):
    """K5 backward: K4's backward with the kv-length mask."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, o, do, scale)
    grads = _launch_bwd("flash_cross_attention_bwd", q, k, v, o, do, lse, scale)
    flash_cross_attention_bwd.launches += 1
    return grads


flash_self_attention.launches = 0
flash_cross_attention.launches = 0
flash_self_attention_bwd.launches = 0
flash_cross_attention_bwd.launches = 0
