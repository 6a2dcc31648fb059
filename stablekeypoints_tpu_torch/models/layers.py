"""Building blocks of the SD UNet and VAE, PyTorch, channels-last.

Activations are NHWC tensors ([B, H, W, C]; [B, N, C] inside
transformers), as in the JAX package, so the port and the reference compare
like with like and the kernels read rows of channels directly. Convolutions
run on the NCHW view of the same memory (`channels_last` strides), which
cuDNN takes without a copy. Parameter names follow the JAX package's
parameter tree (`models/weights.py:from_jax_params` maps one onto the
other). Norm parameters stay fp32; matmul and conv weights are in the
compute dtype; norms, softmax and attention logits compute in fp32.

The routing to the hand-written kernels mirrors the JAX layers: long
self-attention to flash (K4), long cross-attention over the learned tokens
to the resident kernel (K3) or masked flash (K5), the capture to the fused
capture kernel (K1) or, on grids whose rows its query blocks do not tile,
to the unfused one (K2), the VAE's GroupNorms to K6, and the VAE resnets'
GroupNorm + SiLU + 3x3 conv (+ residual) to K7 with K6's coefficients.
Matmuls, the other convs, the short (16^2/8^2) attentions and the UNet's
GroupNorms stay PyTorch ops, as the JAX package leaves them to XLA.

Where a gradient is taken (the training step differentiates the context),
K1, K2, K3, K4 and K5 run as `torch.autograd.Function`s (`AttentionFn`,
`CaptureFn`, `CaptureUnfusedFn`) whose backward is the kernel's backward
wrapper: a backward kernel for CUDA tensors, the plain backward for CPU
tensors. Without a gradient the layers call the forward wrappers directly.
K6 and K7 are never differentiated (the VAE encodes under no_grad, as JAX
stops its gradient).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from stablekeypoints_tpu_torch.kernels import attn_capture as k_capture
from stablekeypoints_tpu_torch.kernels import cross_attn as k_cross
from stablekeypoints_tpu_torch.kernels import flash as k_flash
from stablekeypoints_tpu_torch.kernels import gn_conv as k_gn_conv
from stablekeypoints_tpu_torch.kernels import groupnorm as k_gn
from stablekeypoints_tpu_torch.ops.resize import resize_matrix, upsample_bicubic_headmajor

__all__ = [
    "timestep_embedding",
    "TimestepEmbedder",
    "GroupNorm",
    "Conv2d",
    "ResnetBlock",
    "Downsample",
    "Upsample",
    "CrossAttention",
    "FeedForward",
    "LayerNorm32",
    "BasicTransformerBlock",
    "Transformer2D",
    "AttentionFn",
    "CaptureFn",
    "CaptureUnfusedFn",
    "attention",
    "capture_fn",
    "capture_unfused_fn",
]


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, [cos, sin] order: [B] -> [B, dim] fp32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return layer(x.to(layer.weight.dtype))


class TimestepEmbedder(nn.Module):
    def __init__(self, model_dim: int, emb_dim: int):
        super().__init__()
        self.model_dim = model_dim
        self.linear_1 = nn.Linear(model_dim, emb_dim)
        self.linear_2 = nn.Linear(emb_dim, emb_dim)

    def forward(self, t):
        x = _linear(self.linear_1, timestep_embedding(t, self.model_dim))
        return self.linear_2(F.silu(x))


def group_norm(x, weight, bias, groups: int = 32, eps: float = 1e-5, act=None):
    """GroupNorm (fp32 statistics, two-pass variance) over channels-last x,
    folded into per-(batch, channel) affine coefficients, optional SiLU,
    one rounding to x's dtype at the end."""
    dtype = x.dtype
    b, c = x.shape[0], x.shape[-1]
    groups = math.gcd(groups, c)
    xg = x.reshape(b, -1, groups, c // groups).float()
    mean = xg.mean(dim=(1, 3))
    var = ((xg - mean[:, None, :, None]) ** 2).mean(dim=(1, 3))
    inv = torch.rsqrt(var + eps)
    a = inv.repeat_interleave(c // groups, dim=1) * weight.float()[None]
    b_coef = bias.float()[None] - mean.repeat_interleave(c // groups, dim=1) * a
    shape = (b,) + (1,) * (x.dim() - 2) + (c,)
    y = x.float() * a.reshape(shape) + b_coef.reshape(shape)
    if act == "silu":
        y = y * torch.sigmoid(y)
    return y.to(dtype)


class GroupNorm(nn.Module):
    """GroupNorm(+SiLU); `fused=True` routes to the K6 kernel where its gate
    holds (the VAE; the UNet keeps the PyTorch formulation)."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-5,
                 act: Optional[str] = None, fused: bool = False):
        super().__init__()
        self.groups, self.eps, self.act, self.fused = groups, eps, act, fused
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def _kernel_ok(self, x) -> bool:
        c = x.shape[-1]
        return self.fused and k_gn.fused_group_norm_supported(
            x.numel() // (x.shape[0] * c), c, math.gcd(self.groups, c))

    def forward(self, x):
        if self._kernel_ok(x):
            return k_gn.fused_group_norm(
                x.contiguous(), self.weight, self.bias, math.gcd(self.groups, x.shape[-1]),
                self.eps, self.act,
            )
        return group_norm(x, self.weight, self.bias, self.groups, self.eps, self.act)

    def coeffs(self, x):
        """The norm as per-(batch, channel) coefficients (m_q, a, b_comp),
        each [B, C] fp32, for a consumer that applies them (K7): K6's
        coefficient kernels where its gate holds, else the plain version."""
        if self._kernel_ok(x):
            return k_gn.gn_affine_coeffs(x.contiguous(), self.weight, self.bias,
                                         math.gcd(self.groups, x.shape[-1]), self.eps)
        return k_gn.gn_affine_coeffs_plain(x, self.weight, self.bias, self.groups, self.eps)


class Conv2d(nn.Conv2d):
    """Conv on NHWC tensors (runs on their channels-last NCHW view).
    `asymmetric_pad` pads (0, 1) on both spatial axes (the VAE downsample)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 asymmetric_pad: bool = False):
        padding = 0 if asymmetric_pad else kernel // 2
        super().__init__(cin, cout, kernel, stride=stride, padding=padding)
        self.asymmetric_pad = asymmetric_pad

    def forward(self, x):
        y = x.to(self.weight.dtype).permute(0, 3, 1, 2)
        if self.asymmetric_pad:
            y = F.pad(y, (0, 1, 0, 1))
        return super().forward(y).permute(0, 2, 3, 1)


def _gn_conv(norm: GroupNorm, conv: Conv2d, x, residual=None):
    """K7: norm's coefficients of x, then GN apply + SiLU + conv (+ residual)
    in one pass; the HWIO view of the channels-last conv weight is no copy."""
    return k_gn_conv.fused_gn_silu_conv3x3(x, *norm.coeffs(x), conv.weight.permute(2, 3, 1, 0),
                                           conv.bias, residual)


class ResnetBlock(nn.Module):
    """GN -> SiLU -> conv -> (+time) -> GN -> SiLU -> conv, residual add.

    `fused_gn_conv` (blocks without a time embedding: the VAE) runs each
    GN + SiLU + conv whose shape K7's gate admits as one K7 call, conv1 and
    conv2 gated independently, and fuses the residual into conv2 when conv2
    is fused, as the JAX ResnetBlock does."""

    def __init__(self, cin: int, cout: int, temb_dim: Optional[int] = None,
                 eps: float = 1e-5, fused_norm: bool = False, fused_gn_conv: bool = False):
        super().__init__()
        self.fused_gn_conv = fused_gn_conv and not temb_dim
        self.norm1 = GroupNorm(cin, eps=eps, act="silu", fused=fused_norm)
        self.conv1 = Conv2d(cin, cout, 3)
        self.time_emb_proj = nn.Linear(temb_dim, cout) if temb_dim else None
        self.norm2 = GroupNorm(cout, eps=eps, act="silu", fused=fused_norm)
        self.conv2 = Conv2d(cout, cout, 3)
        self.conv_shortcut = Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb=None):
        if self.fused_gn_conv:
            _, hh, ww, cin = x.shape
            cout = self.conv1.out_channels
            sup1 = k_gn_conv.fused_gn_conv_supported(hh, ww, cin, cout, 1, has_res=False)
            sup2 = k_gn_conv.fused_gn_conv_supported(hh, ww, cout, cout, 1, has_res=True)
            if sup1 or sup2:
                # coefficients of the activation cast to the compute dtype,
                # the dtype K7 applies them in
                dtype = self.conv1.weight.dtype
                xc = x.to(dtype)
                residual = x if self.conv_shortcut is None else self.conv_shortcut(x)
                residual = residual.to(dtype)
                h = _gn_conv(self.norm1, self.conv1, xc) if sup1 else self.conv1(self.norm1(xc))
                if sup2:
                    return _gn_conv(self.norm2, self.conv2, h, residual)
                return residual + self.conv2(self.norm2(h))
        h = self.conv1(self.norm1(x))
        if self.time_emb_proj is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        h = self.conv2(self.norm2(h))
        residual = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return residual + h


class Downsample(nn.Module):
    def __init__(self, channels: int, asymmetric_pad: bool = False):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, asymmetric_pad=asymmetric_pad)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    """Nearest-neighbour 2x, then a 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3)

    def forward(self, x):
        return self.conv(x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2))


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


_ATTENTION = {  # kind -> (forward wrapper, backward wrapper, backward takes o and lse)
    "flash_self": (k_flash.flash_self_attention, k_flash.flash_self_attention_bwd, True),
    "flash_cross": (k_flash.flash_cross_attention, k_flash.flash_cross_attention_bwd, True),
    "cross": (k_cross.cross_attention_resident, k_cross.cross_attention_resident_bwd, False),
}


class AttentionFn(torch.autograd.Function):
    """K3/K4/K5 with their backward kernels: q [B,N,H,D], k/v [B,M,H,D]."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, kind: str):
        fwd, _, flash = _ATTENTION[kind]
        if flash:
            out, lse = fwd(q, k, v, scale, with_lse=True)
        else:
            out, lse = fwd(q, k, v, scale), None
        ctx.scale, ctx.kind = scale, kind
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        _, bwd, flash = _ATTENTION[ctx.kind]
        do = do.contiguous()
        if flash:
            dq, dk, dv = bwd(q, k, v, out, do, lse, ctx.scale)
        else:
            dq, dk, dv = bwd(q, k, v, do, ctx.scale)
        return dq, dk, dv, None, None


def attention(kind: str, q, k, v, scale: float) -> torch.Tensor:
    """Route to kernel `kind`, through `AttentionFn` when a gradient is taken."""
    if _needs_grad(q, k, v):
        return AttentionFn.apply(q, k, v, scale, kind)
    return _ATTENTION[kind][0](q, k, v, scale)


class CaptureFn(torch.autograd.Function):
    """K1 with its backward kernel: tt [B,H,O,X,D], ww [P,X], k [B,T,H,D]
    -> [B, O*P, T] fp32; ww (a resize matrix) gets no gradient."""

    @staticmethod
    def forward(ctx, tt, ww, k, scale: float, precise: bool):
        ctx.scale, ctx.precise = scale, precise
        ctx.save_for_backward(tt, ww, k)
        return k_capture.capture_attention_fused(tt, ww, k, scale)

    @staticmethod
    def backward(ctx, g):
        tt, ww, k = ctx.saved_tensors
        # g arrives as a strided view (collect_maps stacks, means, transposes)
        g = g.float().contiguous()
        dt, dk = k_capture.capture_attention_fused_bwd(tt, ww, k, g, ctx.scale, ctx.precise)
        return dt, None, dk, None, None


def capture_fn(tt, ww, k, scale: float, precise: bool = False) -> torch.Tensor:
    """K1, through `CaptureFn` when a gradient is taken. `precise` keeps
    dsim in fp32 through the backward's products (the JAX package's
    capture_fp32_bwd; plain version only)."""
    if _needs_grad(tt, k):
        return CaptureFn.apply(tt, ww, k, scale, precise)
    return k_capture.capture_attention_fused(tt, ww, k, scale)


class CaptureUnfusedFn(torch.autograd.Function):
    """K2 with its backward kernel: q [B,H,N,D] (upsampled, head-major),
    k [B,T,H,D] -> [B, N, T] fp32."""

    @staticmethod
    def forward(ctx, q, k, scale: float, precise: bool):
        ctx.scale, ctx.precise = scale, precise
        ctx.save_for_backward(q, k)
        return k_capture.capture_attention(q, k, scale)

    @staticmethod
    def backward(ctx, g):
        q, k = ctx.saved_tensors
        # g arrives as a strided view (collect_maps stacks, means, transposes)
        g = g.float().contiguous()
        dq, dk = k_capture.capture_attention_bwd(q, k, g, ctx.scale, ctx.precise)
        return dq, dk, None, None


def capture_unfused_fn(q, k, scale: float, precise: bool = False) -> torch.Tensor:
    """K2, through `CaptureUnfusedFn` when a gradient is taken."""
    if _needs_grad(q, k):
        return CaptureUnfusedFn.apply(q, k, scale, precise)
    return k_capture.capture_attention(q, k, scale)


class CrossAttention(nn.Module):
    """Multi-head attention; self-attention when no context is given.

    Called with `capture_res`, also returns the head-averaged token attention
    of the bicubically upsampled queries, [B, res^2, T]. Upsampling commutes
    with the linear to_q projection, so the layer's own q is upsampled
    instead of re-projecting upsampled hidden states.
    """

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: Optional[int] = None,
                 pallas_capture: bool = False, capture_bf16: bool = False,
                 flash: bool = False, capture_fp32_bwd: bool = False):
        super().__init__()
        inner = heads * dim_head
        kv_dim = context_dim if context_dim is not None else dim
        self.heads, self.dim_head = heads, dim_head
        self.pallas_capture, self.capture_bf16, self.flash = pallas_capture, capture_bf16, flash
        self.capture_fp32_bwd = capture_fp32_bwd
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(kv_dim, inner, bias=False)
        self.to_v = nn.Linear(kv_dim, inner, bias=False)
        self.to_out = nn.Linear(inner, dim)

    def forward(self, x, context=None, capture_res: Optional[int] = None):
        b, n, _ = x.shape
        h, d = self.heads, self.dim_head
        inner = h * d
        scale = 1.0 / math.sqrt(d)
        ctx = x if context is None else context
        m = ctx.shape[1]
        q = _linear(self.to_q, x).reshape(b, n, h, d)
        k = _linear(self.to_k, ctx).reshape(b, m, h, d)
        v = _linear(self.to_v, ctx).reshape(b, m, h, d)

        if self.flash and context is None and k_flash.flash_supported(n, m, d):
            out = attention("flash_self", q, k, v, scale)
        elif self.flash and context is not None and k_cross.cross_resident_supported(n, m, d):
            out = attention("cross", q, k, v, scale)
        elif self.flash and context is not None and k_flash.flash_supported(n, n, d):
            out = attention("flash_cross", q, k, v, scale)
        else:
            out = k_flash.attention_plain(q, k, v, scale)
        out = self.to_out(out.reshape(b, n, inner).to(x.dtype))

        capture = None
        if capture_res is not None:
            res = capture_res
            s = int(round(math.sqrt(n)))
            q5 = q.reshape(b, s, s, h, d)
            cap_dtype = torch.bfloat16 if self.capture_bf16 else torch.float32
            if self.pallas_capture and k_capture.fused_capture_ok(res, res):
                # row resize here; the column resize runs inside the kernel
                ww = resize_matrix(s, res, "bicubic", q.dtype, q.device)
                tt = torch.einsum("Oy,byxkd->bkOxd", ww, q5).contiguous()
                capture = capture_fn(tt, ww, k, scale, self.capture_fp32_bwd)
            elif self.pallas_capture:
                q_up = upsample_bicubic_headmajor(q5, res, res).contiguous()
                capture = capture_unfused_fn(q_up, k, scale, self.capture_fp32_bwd)
            else:
                q_up = upsample_bicubic_headmajor(q5, res, res)
                sim = torch.einsum("bhnd,bmhd->bhnm", q_up.float(), k.float())
                capture = torch.softmax(sim * scale, dim=-1).mean(dim=1)
            capture = capture.to(cap_dtype)
        return out, capture


class FeedForward(nn.Module):
    """GEGLU feed-forward (project to 2*4*dim, gate with exact GELU in fp32)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.proj_in = nn.Linear(dim, dim * mult * 2)
        self.proj_out = nn.Linear(dim * mult, dim)

    def forward(self, x):
        a, g = self.proj_in(x).chunk(2, dim=-1)
        return self.proj_out(a * F.gelu(g.float()).to(a.dtype))


class LayerNorm32(nn.Module):
    """LayerNorm computed in fp32, cast back."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(), self.bias.float(), self.eps)
        return y.to(x.dtype)


class BasicTransformerBlock(nn.Module):
    """self-attn -> cross-attn -> GEGLU FF, pre-LN, residual."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int,
                 pallas_capture: bool = False, capture_bf16: bool = False,
                 flash: bool = False, capture_fp32_bwd: bool = False):
        super().__init__()
        self.norm1 = LayerNorm32(dim)
        self.attn1 = CrossAttention(dim, heads, dim_head, flash=flash)
        self.norm2 = LayerNorm32(dim)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim,
                                    pallas_capture, capture_bf16, flash, capture_fp32_bwd)
        self.norm3 = LayerNorm32(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context, capture_res: Optional[int] = None):
        x = x + self.attn1(self.norm1(x))[0]
        h, capture = self.attn2(self.norm2(x), context, capture_res)
        x = x + h
        return x + self.ff(self.norm3(x)), capture


class Transformer2D(nn.Module):
    """GN -> 1x1 proj_in -> transformer blocks -> 1x1 proj_out, residual.
    Only the first block of a stack captures."""

    def __init__(self, channels: int, heads: int, dim_head: int, context_dim: int,
                 depth: int = 1, pallas_capture: bool = False,
                 capture_bf16: bool = False, flash: bool = False,
                 capture_fp32_bwd: bool = False):
        super().__init__()
        inner = heads * dim_head
        self.depth = depth
        self.norm = GroupNorm(channels, eps=1e-6)
        self.proj_in = Conv2d(channels, inner, 1)
        for i in range(depth):
            self.add_module(f"blocks_{i}", BasicTransformerBlock(
                inner, heads, dim_head, context_dim, pallas_capture, capture_bf16, flash,
                capture_fp32_bwd,
            ))
        self.proj_out = Conv2d(inner, channels, 1)

    def forward(self, x, context, capture_res: Optional[int] = None):
        b, hh, ww, _ = x.shape
        residual = x
        x = self.proj_in(self.norm(x))
        inner = x.shape[-1]
        x = x.reshape(b, hh * ww, inner)
        capture = None
        for i in range(self.depth):
            block = getattr(self, f"blocks_{i}")
            x, cap = block(x, context, capture_res if i == 0 else None)
            capture = cap if i == 0 else capture
        x = self.proj_out(x.reshape(b, hh, ww, inner))
        return x + residual, capture
