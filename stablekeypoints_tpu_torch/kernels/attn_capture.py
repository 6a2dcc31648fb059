"""K1 and K2: capture attention (QK^T -> softmax -> head-mean), forward and
backward.

K1 replaces stablekeypoints_tpu/kernels/attn_capture.py
`capture_attention_fused` (forward `_capture_fused_fwd`, backward
`_capture_fused_bwd`), with the column resize inside. The CUDA forward
(`csrc/attn_capture.cu`) is one pass over the heads per 64 query rows: it
builds each head's query tile from the row-resized queries and the
column-resize matrix with the tensor cores, so the upsampled [B, H, O*P, D]
queries never exist in device memory, holds a block's row of <= 512 scores
across two warpgroups, and sums the normalised softmaxes in head order in
shared memory (bitwise reproducible). Past 512 tokens (up to 4096,
`MAX_TOKENS`) a cluster of up to 8 blocks shares the rows, each holding an
even share of the keys, their row maxima and sums merged through
distributed shared memory in rank order. The backward is a rows pass and a
keys pass with no additions into device memory, at every head dim: per
64-row query tile the g rows stay in shared memory while two warpgroups
take the heads in turn, each sweeping the keys twice (statistics, then dsim
and the whole dq, written as bf16 or, for K1, folded into dt of its
columns); per 256 keys (128 at d 160) warpgroups of 64 keys form dk over a
share of the query tiles, the shares summed in a fixed order where the
grid leaves SMs idle. Past 512 tokens the rows pass runs on a cluster of
blocks too, the row statistics and the partial dq summed over it in rank
order; K1's rows of more than 128 columns (256^2 and 512^2 captures, up to
512: `MAX_COLS`) leave fp32 dt partials, one a 64-column tile, summed in
order. dq, dt and dk are bitwise reproducible; the scratch `dq_acc` holds
their dk and dt partials. At d 160, past 448 tokens a block,
K1's rows pass reads more than 16 source columns of tt from device memory, as
shared memory holds no buffers for them beside the g rows (SD-1.5's up_1
layers from 576^2 up). Bound on the card: operations
(see the source note). With `precise` (the JAX package's capture_fp32_bwd)
the backward keeps dsim in fp32 through both products as two bf16 halves,
hi = bf16(dsim) and lo = bf16(dsim - hi), each multiplied in (twice the
products); its launches are counted apart, in `launches_precise`.

K2 replaces `capture_attention` (`_capture_core`, pallas_calls at :252 and
:284): the same math on already-upsampled head-major queries, for capture
grids whose rows the fused kernel's query blocks do not tile
(`fused_capture_ok` false, e.g. 96^2). The same CUDA kernels run it,
templated on where a query tile comes from; the backward writes dq
[B, H, N, D] in q's layout.

Every function takes `total_heads` (default: the H heads given), the JAX
`_capture_core`'s argument: the maps are the sum over the given heads of
their softmaxes divided by total_heads, and the backward reads the maps'
cotangent as g / total_heads. Under tensor parallelism a rank holds H of
the layer's total_heads heads and its partial sums are completed by one
all-reduce over the model ranks (`parallel/tensor.py`); the kernels divide
by total_heads in place of H, so no pass rescales a finished mean.
total_heads < H raises.
"""

from __future__ import annotations

import ctypes

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
    "capture_attention",
    "capture_attention_bwd",
    "capture_attention_fused",
    "capture_attention_fused_bwd",
    "capture_bwd_plain",
    "capture_fused_bwd_plain",
    "capture_fused_plain",
    "capture_plain",
    "fused_capture_ok",
]

KERNEL_DIMS = (64, 80, 160)
MAX_SRC = 32  # rows of tt per head (the pre-upsample width) the kernel holds
MAX_TOKENS = 4096  # learned tokens: 512 a block, clusters of up to 8 blocks above 512
MAX_COLS = 512  # output columns a row in the backward (8 tiles of 64, dt summed in order)


def g_rows(g: torch.Tensor) -> tuple[torch.Tensor, int]:
    """The cotangent g [B, N, T] fp32 as the backward kernels read it (by TMA,
    whose rows must be 16-byte aligned): (g, T) when T % 4 == 0, else a copy
    with each row zero-padded to a multiple of 4 and that row length."""
    t = g.shape[-1]
    if t % 4 == 0:
        return g, t
    ldg = (t + 3) // 4 * 4
    return F.pad(g, (0, ldg - t)), ldg


def _block_n(n: int) -> int:
    for bn in (1024, 512, 256, 128, 8):
        if n % bn == 0:
            return bn
    return n


def _total(h: int, total_heads) -> int:
    """total_heads, default h; fewer than the heads given raises."""
    if total_heads is None:
        return h
    if total_heads < h:
        raise ValueError(f"total_heads {total_heads} < the {h} heads given")
    return int(total_heads)


def _head_mean(p: torch.Tensor, total: int) -> torch.Tensor:
    """[B, H, N, T] softmaxes -> their sum over H / total (the mean at H)."""
    return p.mean(dim=1) if total == p.shape[1] else p.sum(dim=1) / total


def fused_capture_ok(out_h: int, out_w: int) -> bool:
    """The JAX package's routing rule for the fused capture: its query tiles
    of _block_n rows cover whole output rows. The layer routes the other
    grids to the unfused capture kernel (K2)."""
    n = out_h * out_w
    return n >= out_w and _block_n(n) % out_w == 0


def capture_fused_plain(tt, ww, k, scale: float, total_heads=None) -> torch.Tensor:
    """tt [B,H,O,X,D], ww [P,X], k [B,T,H,D] -> [B, O*P, T] fp32.

    q = tt's dtype( ww . tt ) with fp32 accumulation (the column resize),
    then the sum over heads of softmax_t(q . k^T * scale) / total_heads in
    fp32 (the head-mean at total_heads = H)."""
    b, h, o, x, d = tt.shape
    total = _total(h, total_heads)
    q = torch.einsum("Px,bkOxd->bkOPd", ww.float(), tt.float()).to(tt.dtype)
    q = q.reshape(b, h, -1, d)
    sim = torch.einsum("bhnd,bthd->bhnt", q.float(), k.float())
    return _head_mean(torch.softmax(sim * scale, dim=-1), total)


def capture_attention_fused(tt, ww, k, scale: float, total_heads=None) -> torch.Tensor:
    if tt.device.type == "cpu":
        return capture_fused_plain(tt, ww, k, scale, total_heads)
    name = "capture_attention_fused"
    b, h, o, x, d = tt.shape
    total = _total(h, total_heads)
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
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int])
    fn.restype = ctypes.c_int
    check_launch(name, fn(ptr(tt), ptr(ww), ptr(k), ptr(out), b, h, o, x, p, t, d, scale,
                          stream_handle(), total))
    capture_attention_fused.launches += 1
    return out


def capture_fused_bwd_plain(tt, ww, k, g, scale: float, precise: bool = False,
                            total_heads=None):
    """The TPU kernel's backward arithmetic -> (dt like tt, dk like k).

    Per head: p recomputed in fp32, g/H the head-mean's cotangent (H:
    total_heads),
    dsim = (g/H * p - p * sum_t g/H * p) * scale, rounded to k's dtype
    unless `precise`; dq = dsim.k in fp32, rounded to ww's dtype for the
    column-resize VJP dt = ww^T.dq; dk = sum over rows of dsim^T.q (fp32).
    The gradient of ww is zero (a constant resize matrix)."""
    b, h, o, x, d = tt.shape
    total = _total(h, total_heads)
    p_cols = ww.shape[0]
    q = torch.einsum("Px,bkOxd->bkOPd", ww.float(), tt.float()).to(tt.dtype)
    qf, kf = q.reshape(b, h, -1, d).float(), k.float()
    p = torch.softmax(torch.einsum("bhnd,bthd->bhnt", qf, kf) * scale, dim=-1)
    t1 = g.float()[:, None] * (1.0 / total) * p
    dsim = (t1 - p * t1.sum(-1, keepdim=True)) * scale
    if not precise:
        dsim = dsim.to(k.dtype).float()
    dq = torch.einsum("bhnt,bthd->bhnd", dsim, kf)
    dq = dq.to(ww.dtype).float().reshape(b, h, o, p_cols, d)
    dt = torch.einsum("Px,bhOPd->bhOxd", ww.float(), dq).to(tt.dtype)
    dk = torch.einsum("bhnt,bhnd->bthd", dsim, qf).to(k.dtype)
    return dt, dk


def _count(wrapper, precise: bool) -> None:
    if precise:
        wrapper.launches_precise += 1
    else:
        wrapper.launches += 1


def capture_attention_fused_bwd(tt, ww, k, g, scale: float, precise: bool = False,
                                total_heads=None):
    """(tt, ww, k, g [B, O*P, T] the cotangent of the maps) -> (dt, dk).
    `precise` keeps dsim in fp32 through the contractions (the kernel's
    hi + lo form on CUDA)."""
    if tt.device.type == "cpu":
        return capture_fused_bwd_plain(tt, ww, k, g, scale, precise, total_heads)
    name = "capture_attention_fused_bwd"
    b, h, o, x, d = tt.shape
    total = _total(h, total_heads)
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
    g, ldg = g_rows(g)
    n = o * p
    q = torch.empty((b, h, n, d), dtype=tt.dtype, device=tt.device)  # upsampled queries
    lse, c = (torch.empty((b, h, n), dtype=torch.float32, device=tt.device) for _ in range(2))
    dq_acc = torch.empty((b, h, n, d), dtype=torch.float32, device=tt.device)
    lib = _build.load("attn_capture")
    fn = lib.skp_capture_bwd_precise if precise else lib.skp_capture_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int])
    fn.restype = ctypes.c_int
    check_launch(name, fn(ptr(tt), ptr(ww), ptr(k), ptr(g), ptr(q), ptr(lse), ptr(c),
                          ptr(dq_acc), ptr(dt), ptr(dk), b, h, o, x, p, t, ldg, d, scale,
                          stream_handle(), total))
    _count(capture_attention_fused_bwd, precise)
    return dt, dk


def capture_plain(q, k, scale: float, total_heads=None) -> torch.Tensor:
    """q [B,H,N,D] (head-major), k [B,T,H,D] -> [B, N, T] fp32: the head-mean
    of softmax_t(q . k^T * scale) (the sum over heads / total_heads), logits
    and softmax in fp32."""
    total = _total(q.shape[1], total_heads)
    sim = torch.einsum("bhnd,bthd->bhnt", q.float(), k.float())
    return _head_mean(torch.softmax(sim * scale, dim=-1), total)


def _check_q_shapes(name, q, k, g=None):
    b, h, n, d = q.shape
    t = k.shape[1]
    if d not in KERNEL_DIMS or not 0 < t <= MAX_TOKENS:
        raise NotImplementedError(
            f"{name}: the kernel takes head dims {KERNEL_DIMS} and <= {MAX_TOKENS} tokens; "
            f"got d {d}, {t} tokens"
        )
    if k.shape != (b, t, h, d) or (g is not None and g.shape != (b, n, t)):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    return b, h, n, t, d


def capture_attention(q, k, scale: float, total_heads=None) -> torch.Tensor:
    """K2: q [B,H,N,D] head-major, k [B,T,H,D] -> [B, N, T] fp32."""
    if q.device.type == "cpu":
        return capture_plain(q, k, scale, total_heads)
    name = "capture_attention"
    b, h, n, t, d = _check_q_shapes(name, q, k)
    total = _total(h, total_heads)
    check_kernel_inputs(name, q, k, allow_grad=True)
    out = torch.empty((b, n, t), dtype=torch.float32, device=q.device)
    fn = _build.load("attn_capture").skp_capture_q_fwd
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int])
    fn.restype = ctypes.c_int
    check_launch(name, fn(ptr(q), ptr(k), ptr(out), b, h, n, t, d, scale, stream_handle(),
                          total))
    capture_attention.launches += 1
    return out


def capture_bwd_plain(q, k, g, scale: float, precise: bool = False, total_heads=None):
    """The TPU kernel's backward arithmetic (`_bwd_kernel`) -> (dq like q,
    dk like k): p recomputed in fp32, dsim = (g/H * p - p * sum_t g/H * p)
    * scale (H: total_heads), rounded to k's dtype unless `precise`;
    dq = dsim . k and dk = sum over rows of dsim^T . q, both in fp32, then
    cast."""
    total = _total(q.shape[1], total_heads)
    qf, kf = q.float(), k.float()
    p = torch.softmax(torch.einsum("bhnd,bthd->bhnt", qf, kf) * scale, dim=-1)
    t1 = g.float()[:, None] * (1.0 / total) * p
    dsim = (t1 - p * t1.sum(-1, keepdim=True)) * scale
    if not precise:
        dsim = dsim.to(k.dtype).float()
    dq = torch.einsum("bhnt,bthd->bhnd", dsim, kf).to(q.dtype)
    dk = torch.einsum("bhnt,bhnd->bthd", dsim, qf).to(k.dtype)
    return dq, dk


def capture_attention_bwd(q, k, g, scale: float, precise: bool = False, total_heads=None):
    """K2 backward: (q, k, g [B, N, T] the cotangent of the maps) -> (dq, dk);
    `precise` as for K1."""
    if q.device.type == "cpu":
        return capture_bwd_plain(q, k, g, scale, precise, total_heads)
    name = "capture_attention_bwd"
    b, h, n, t, d = _check_q_shapes(name, q, k, g)
    total = _total(h, total_heads)
    check_kernel_inputs(name, q, k, allow_grad=True)
    check_kernel_inputs(name, g, dtype=torch.float32)
    dq, dk = torch.empty_like(q), torch.empty_like(k)
    g, ldg = g_rows(g)
    lse, c = (torch.empty((b, h, n), dtype=torch.float32, device=q.device) for _ in range(2))
    dq_acc = torch.empty((b, h, n, d), dtype=torch.float32, device=q.device)
    lib = _build.load("attn_capture")
    fn = lib.skp_capture_q_bwd_precise if precise else lib.skp_capture_q_bwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int])
    fn.restype = ctypes.c_int
    check_launch(name, fn(ptr(q), ptr(k), ptr(g), ptr(lse), ptr(c), ptr(dq_acc), ptr(dq),
                          ptr(dk), b, h, n, t, ldg, d, scale, stream_handle(), total))
    _count(capture_attention_bwd, precise)
    return dq, dk


capture_attention_fused.launches = 0
capture_attention_fused_bwd.launches = 0
capture_attention_fused_bwd.launches_precise = 0
capture_attention.launches = 0
capture_attention_bwd.launches = 0
capture_attention_bwd.launches_precise = 0
