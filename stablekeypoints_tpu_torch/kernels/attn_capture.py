"""K1: fused capture attention (column resize -> QK^T -> softmax -> head-mean).

Replaces stablekeypoints_tpu/kernels/attn_capture.py
`capture_attention_fused` (forward `_capture_fused_fwd`, backward
`_capture_fused_bwd`). The CUDA kernels (`csrc/attn_capture.cu`) build each
query tile from the row-resized queries and the column-resize matrix with
the tensor cores, so the upsampled [B, H, O*P, D] queries never exist in
device memory. The forward accumulates the head-mean in registers. The
backward is two kernels: one per output row (each head's row statistics,
the softmax VJP, dq and dt = ww^T.dq) and one per key tile (dk summed over
every query row in a fixed order). Bound on the card: operations (see the
source note).
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
    "capture_attention_fused",
    "capture_attention_fused_bwd",
    "capture_fused_bwd_plain",
    "capture_fused_plain",
    "fused_capture_ok",
]

KERNEL_DIMS = (80, 160)
MAX_SRC = 32  # rows of tt per head (the pre-upsample width) the kernel holds
MAX_TOKENS = 512  # the learned-token rows the kernel holds
MAX_COLS = 128  # output columns per row the backward's row block covers


def _block_n(n: int) -> int:
    for bn in (1024, 512, 256, 128, 8):
        if n % bn == 0:
            return bn
    return n


def fused_capture_ok(out_h: int, out_w: int) -> bool:
    """The JAX package's routing rule for the fused capture: its query tiles
    of _block_n rows cover whole output rows. The layer routes the other
    grids to the unfused capture kernel, which is not ported yet."""
    n = out_h * out_w
    return n >= out_w and _block_n(n) % out_w == 0


def capture_fused_plain(tt, ww, k, scale: float) -> torch.Tensor:
    """tt [B,H,O,X,D], ww [P,X], k [B,T,H,D] -> [B, O*P, T] fp32.

    q = tt's dtype( ww . tt ) with fp32 accumulation (the column resize),
    then the head-mean of softmax_t(q . k^T * scale) in fp32."""
    b, h, o, x, d = tt.shape
    q = torch.einsum("Px,bkOxd->bkOPd", ww.float(), tt.float()).to(tt.dtype)
    q = q.reshape(b, h, -1, d)
    sim = torch.einsum("bhnd,bthd->bhnt", q.float(), k.float())
    return torch.softmax(sim * scale, dim=-1).mean(dim=1)


def capture_attention_fused(tt, ww, k, scale: float) -> torch.Tensor:
    if tt.device.type == "cpu":
        return capture_fused_plain(tt, ww, k, scale)
    name = "capture_attention_fused"
    b, h, o, x, d = tt.shape
    p = ww.shape[0]
    t = k.shape[1]
    if d not in KERNEL_DIMS or not 0 < t <= MAX_TOKENS or x > MAX_SRC:
        raise NotImplementedError(
            f"{name}: the kernel takes head dims {KERNEL_DIMS}, <= {MAX_TOKENS} tokens and "
            f"<= {MAX_SRC} source columns; got d {d}, {t} tokens, {x} columns"
        )
    if ww.shape != (p, x) or k.shape != (b, t, h, d):
        raise ValueError(
            f"{name}: shapes tt {tuple(tt.shape)} ww {tuple(ww.shape)} k {tuple(k.shape)}"
        )
    check_kernel_inputs(name, tt, ww, k, allow_grad=True)
    out = torch.empty((b, o * p, t), dtype=torch.float32, device=tt.device)
    fn = _build.load("attn_capture").skp_capture_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    check_launch(name, fn(ptr(tt), ptr(ww), ptr(k), ptr(out), b, h, o, x, p, t, d, scale,
                          stream_handle()))
    capture_attention_fused.launches += 1
    return out


def capture_fused_bwd_plain(tt, ww, k, g, scale: float, precise: bool = False):
    """The TPU kernel's backward arithmetic -> (dt like tt, dk like k).

    Per head: p recomputed in fp32, g/H the head-mean's cotangent,
    dsim = (g/H * p - p * sum_t g/H * p) * scale, rounded to k's dtype
    unless `precise`; dq = dsim.k in fp32, rounded to ww's dtype for the
    column-resize VJP dt = ww^T.dq; dk = sum over rows of dsim^T.q (fp32).
    The gradient of ww is zero (a constant resize matrix)."""
    b, h, o, x, d = tt.shape
    p_cols = ww.shape[0]
    q = torch.einsum("Px,bkOxd->bkOPd", ww.float(), tt.float()).to(tt.dtype)
    qf, kf = q.reshape(b, h, -1, d).float(), k.float()
    p = torch.softmax(torch.einsum("bhnd,bthd->bhnt", qf, kf) * scale, dim=-1)
    t1 = g.float()[:, None] * (1.0 / h) * p
    dsim = (t1 - p * t1.sum(-1, keepdim=True)) * scale
    if not precise:
        dsim = dsim.to(k.dtype).float()
    dq = torch.einsum("bhnt,bthd->bhnd", dsim, kf)
    dq = dq.to(ww.dtype).float().reshape(b, h, o, p_cols, d)
    dt = torch.einsum("Px,bhOPd->bhOxd", ww.float(), dq).to(tt.dtype)
    dk = torch.einsum("bhnt,bhnd->bthd", dsim, qf).to(k.dtype)
    return dt, dk


def capture_attention_fused_bwd(tt, ww, k, g, scale: float, precise: bool = False):
    """(tt, ww, k, g [B, O*P, T] the cotangent of the maps) -> (dt, dk).
    On CUDA `precise` (fp32 dsim through the contractions) raises: the
    kernel's products are bf16 mma.sync, which takes no fp32 operands."""
    if tt.device.type == "cpu":
        return capture_fused_bwd_plain(tt, ww, k, g, scale, precise)
    name = "capture_attention_fused_bwd"
    if precise:
        raise NotImplementedError(
            f"{name}: capture_fp32_bwd is not ported to the CUDA kernel; run it off"
        )
    b, h, o, x, d = tt.shape
    p = ww.shape[0]
    t = k.shape[1]
    if d not in KERNEL_DIMS or not 0 < t <= MAX_TOKENS or x > MAX_SRC or p > MAX_COLS:
        raise NotImplementedError(
            f"{name}: the kernel takes head dims {KERNEL_DIMS}, <= {MAX_TOKENS} tokens, "
            f"<= {MAX_SRC} source columns and <= {MAX_COLS} output columns; got d {d}, "
            f"{t} tokens, {x} columns, {p} output columns"
        )
    if ww.shape != (p, x) or k.shape != (b, t, h, d) or g.shape != (b, o * p, t):
        raise ValueError(
            f"{name}: shapes tt {tuple(tt.shape)} ww {tuple(ww.shape)} k {tuple(k.shape)} "
            f"g {tuple(g.shape)}"
        )
    check_kernel_inputs(name, tt, ww, k, allow_grad=True)
    check_kernel_inputs(name, g, dtype=torch.float32)
    dt, dk = torch.empty_like(tt), torch.empty_like(k)
    lse, c = (torch.empty((b, h, o * p), dtype=torch.float32, device=tt.device)
              for _ in range(2))
    fn = _build.load("attn_capture").skp_capture_bwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    check_launch(name, fn(ptr(tt), ptr(ww), ptr(k), ptr(g), ptr(lse), ptr(c), ptr(dt), ptr(dk),
                          b, h, o, x, p, t, d, scale, stream_handle()))
    capture_attention_fused_bwd.launches += 1
    return dt, dk


capture_attention_fused.launches = 0
capture_attention_fused_bwd.launches = 0
