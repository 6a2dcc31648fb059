#!/usr/bin/env python3
"""Run the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits non-zero; nothing is skipped):
  1. build    every CUDA kernel from the checkout's sources (one nvcc per
              source, in parallel); Triton kernels compile at first launch.
  2. kernels  each forward kernel at the shapes one SD-1.5 512^2 detect
              forward gives it (10 augmented views; K2 at a 96^2 capture
              grid), and each backward kernel at the shapes one training
              step gives it (batch 4, merged batch 8), bf16, against its
              plain PyTorch version on the same inputs, with a stated
              tolerance; device times (CUDA events around calls queued
              behind a device-side spin, so no host time is counted) of the
              kernel, the plain version and, where one exists, a single
              PyTorch library call of the same function (for K7, which no
              single call computes, the unfused path it replaces: K6 apply
              + cuDNN conv + add); the bound and, for attention, the
              exponential floor (one ex2 per score at 16 per clock per SM).
  3. detect   a full-width SD-1.5 runtime from the seed (random weights),
              KeypointModel.detect_batch on 1 and 4 images of 512^2 with a
              random [1, 500, 768] context and indices 0..9; launch counts
              of every kernel against the expected count per forward pass;
              the same calls with K7 off (fused_gn_conv="off"); a
              torch.profiler trace of one M=1 call (device time by kernel);
              the ensembled maps against the same runtime with every kernel
              switched off (plain PyTorch layers).
  4. train    stage 1 on the same runtime: optimize_embedding on
              SyntheticBlobs (8 images of 512^2), batch 4, an epoch of fill
              steps then one of cached steps; s/step, peak memory, losses,
              launch counts per step against the prediction; a profile of
              one cached step; the context gradient of a fixed loss through
              the kernels against the same through the plain layers.
  5. vote     stage 2 on the same runtime: find_best_indices over 8 images
              with the learned context (launches per vote batch, s/image,
              distinct indices in range); then learn_keypoints (2 steps,
              4 voted images) and one detect, the whole user flow.
  6. capture96  the same weights at a 96^2 capture grid, where the layers
              route the capture to K2 (no K1): 2 fill + 2 cached training
              steps, a profile of one cached step, the fixed-loss context
              gradient against the plain layers, and one M=1 detect whose
              maps are held to the plain layers'.
Prints a `kernels` JSON line, the card's name and power limit, and last
{"ok": true, "device": {...}}. Needs a CUDA device; imports no JAX.
`--phases` runs a subset (for iterating on one part) and then prints no
result line.

float32 matmuls and convolutions run in full fp32 (TF32 off for both), so
the plain versions used as references are not rounded to TF32; the main
path computes in bf16 and is not affected.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (dense): bf16 tensor cores, fp32 FMA units, HBM3
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
HBM_BYTES_PER_S = 3.35e12
# set from the card in main(): the SM count and max SM clock (exponential
# floor), and cycles per second for the timing spin (an overestimate of the
# clock makes the spin longer, never shorter)
SM_COUNT = 132
SM_CLOCK_HZ = 1.98e9
SPIN_CYCLES_PER_S = 2.0e9

# expected launches per SD-1.5 512^2 detect forward pass: the VAE encoder's
# 20 resnet convs run K7 on K6's coefficients (22 coefficient launches: 20
# for K7, 2 inside the K6 applies of the mid attention norm and
# conv_norm_out)
PER_PASS = {"capture": 4, "cross": 2, "flash_self": 6, "flash_cross": 3, "groupnorm": 2,
            "gn_coeffs": 22, "gn_conv": 20, "capture_unfused": 0,
            "capture_bwd": 0, "cross_bwd": 0, "flash_self_bwd": 0, "flash_cross_bwd": 0,
            "capture_unfused_bwd": 0}
# expected launches per training step (batch 4, merged batch 8, one VAE encode
# call per step: of both image sets on fill steps, of the warped ones on cached
# steps). Forward as detect; backward: the first self-attention of down_0 runs
# before any layer reads the context, so it gets no gradient (K4 5 - 1), and
# up_2's cross-attention output reaches no loss (truncation, K5 3 - 1).
PER_STEP = dict(PER_PASS, capture_bwd=4, cross_bwd=2, flash_self_bwd=4, flash_cross_bwd=2)
# at a 96^2 capture grid the four captures run K2 instead of K1
PER_STEP_96 = dict(PER_STEP, capture=0, capture_bwd=0, capture_unfused=4, capture_unfused_bwd=4)
PER_PASS_96 = dict(PER_PASS, capture=0, capture_unfused=4)
# K7 per SD-1.5 512^2 VAE encode: (level, Cin, Cout, residual, launches)
GN_CONV_SHAPES = ((512, 128, 128, False, 2), (512, 128, 128, True, 2), (256, 128, 256, False, 1),
                  (256, 256, 256, False, 1), (256, 256, 256, True, 2), (128, 256, 512, False, 1),
                  (128, 512, 512, False, 1), (128, 512, 512, True, 2), (64, 512, 512, False, 4),
                  (64, 512, 512, True, 4))


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return float(r.stdout.strip().splitlines()[0]) * 1e6


def cuda_ms(fn, reps: int) -> float:
    """Device ms per call of `fn`: CUDA events around `reps` back-to-back
    calls queued behind a device-side spin (`torch.cuda._sleep`) that lasts
    longer than the host takes to enqueue them, so the events see the
    device's work and not the wrapper's host cost."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0  # enqueue time of one call (device mostly idle)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * reps * host_s + 1e-3) * SPIN_CYCLES_PER_S))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def exp_floor_ms(exps: float) -> float:
    """`exps` exponentials on the SFU at 16 per clock per SM, max SM clock."""
    return exps / (16 * SM_COUNT * SM_CLOCK_HZ) * 1e3


def bound_ms(nbytes: float, flops: float, peak: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_cases(torch, gen):
    """(kernel name, shape label, count per pass, run kernel, run plain,
    run library or None, bytes, flops, peak, tolerance) per distinct shape."""
    import torch.nn.functional as F

    from stablekeypoints_tpu_torch.kernels import attn_capture, cross_attn, flash, groupnorm
    from stablekeypoints_tpu_torch.ops.resize import resize_matrix

    bf = torch.bfloat16
    dev = "cuda"
    B, T = 10, 500

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    cases = []
    # K1 capture: up_1 (16^2 -> 128^2, d 160) x3, up_2 (32^2 -> 128^2, d 80) x1
    for x, d, count in ((16, 160, 3), (32, 80, 1)):
        tt, k = randn(B, 8, 128, x, d), randn(B, T, 8, d)
        ww = resize_matrix(x, 128, "bicubic", bf, dev)
        scale = d ** -0.5
        q_up = torch.einsum("Px,bkOxd->bkOPd", ww, tt).reshape(B, 8, -1, d)
        kh = k.permute(0, 2, 1, 3)
        n = 128 * 128
        cases.append(dict(
            name="capture", shape=f"tt[{B},8,128,{x},{d}] k[{B},{T},8,{d}]", count=count,
            kernel=lambda tt=tt, ww=ww, k=k, s=scale: attn_capture.capture_attention_fused(tt, ww, k, s),
            plain=lambda tt=tt, ww=ww, k=k, s=scale: attn_capture.capture_fused_plain(tt, ww, k, s),
            library=lambda q=q_up, kh=kh, s=scale: torch.softmax(
                torch.matmul(q, kh.transpose(-1, -2)).float() * s, dim=-1).mean(1),
            nbytes=2 * (tt.numel() + ww.numel() + k.numel()) + 4 * B * n * T,
            flops=2 * B * 8 * n * T * d + 2 * B * 8 * n * x * d, peak=PEAK_BF16, tol=1e-4,
            exps=B * 8 * n * T, deterministic=True,  # one ex2 a score; heads summed in order
        ))

    def sdpa(q, k, v, s):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=s
        ).transpose(1, 2)

    def attention(name, fn, plain, n, m, h, d, count):
        q, k, v = randn(B, n, h, d), randn(B, m, h, d), randn(B, m, h, d)
        s = d ** -0.5
        return dict(
            name=name, shape=f"q[{B},{n},{h},{d}] kv[{B},{m},{h},{d}]", count=count,
            kernel=lambda: fn(q, k, v, s), plain=lambda: plain(q, k, v, s),
            library=lambda: sdpa(q, k, v, s),
            nbytes=2 * (2 * q.numel() + 2 * k.numel()), flops=4 * B * h * n * m * d,
            peak=PEAK_BF16, tol=2.0**-7, relative=True,  # 2 bf16 ulps at the top binade
            exps=B * h * n * m,
        )

    # K3 resident cross-attention: the two 64^2 cross layers of down_0
    cases.append(attention("cross", cross_attn.cross_attention_resident,
                           cross_attn.cross_attention_plain, 4096, T, 8, 40, 2))
    # K4 flash self-attention: down_0 x2, down_1 x2 + up_2 x1, VAE mid x1
    for n, h, d, count in ((4096, 8, 40, 2), (1024, 8, 80, 3), (4096, 1, 512, 1)):
        cases.append(attention("flash_self", flash.flash_self_attention,
                               flash.attention_plain, n, n, h, d, count))
    # K5 masked flash cross-attention: down_1 x2, up_2 x1
    cases.append(attention("flash_cross", flash.flash_cross_attention,
                           flash.attention_plain, 1024, T, 8, 80, 3))
    cases += backward_cases(torch, gen)
    cases += gn_conv_cases(torch, gen)

    # K2 unfused capture at a 96^2 grid: up_1 (d 160) x3, up_2 (d 80) x1
    for d, count in ((160, 3), (80, 1)):
        n = 96 * 96
        q, k = randn(B, 8, n, d), randn(B, T, 8, d)
        kh = k.permute(0, 2, 1, 3)
        scale = d ** -0.5
        cases.append(dict(
            name="capture_unfused", shape=f"q[{B},8,{n},{d}] k[{B},{T},8,{d}]", count=count,
            kernel=lambda q=q, k=k, s=scale: attn_capture.capture_attention(q, k, s),
            plain=lambda q=q, k=k, s=scale: attn_capture.capture_plain(q, k, s),
            library=lambda q=q, kh=kh, s=scale: torch.softmax(
                torch.matmul(q, kh.transpose(-1, -2)).float() * s, dim=-1).mean(1),
            nbytes=2 * (q.numel() + k.numel()) + 4 * B * n * T,
            flops=2 * B * 8 * n * T * d, peak=PEAK_BF16, tol=1e-4,
            exps=B * 8 * n * T, deterministic=True,
        ))

    # K6 GroupNorm(+SiLU) in the VAE encoder at 512^2 (eps 1e-6, 32 groups):
    # the applies of the mid attention norm and conv_norm_out; every other
    # VAE GroupNorm is K7's coefficients (the gn_coeffs cases)
    for hw, c, act, count in ((64, 512, "silu", 1), (64, 512, None, 1)):
        x = (torch.randn((B, hw, hw, c), generator=gen, device=dev) * 1.5 + 0.3).to(bf)
        w = torch.randn(c, generator=gen, device=dev) * 0.2 + 1.0
        b = torch.randn(c, generator=gen, device=dev) * 0.2

        def lib(x=x, w=w, b=b, act=act):
            y = F.group_norm(x.permute(0, 3, 1, 2), 32, w.to(bf), b.to(bf), 1e-6)
            return F.silu(y) if act else y

        cases.append(dict(
            name="groupnorm", shape=f"x[{B},{hw},{hw},{c}] {act or 'none'}", count=count,
            kernel=lambda x=x, w=w, b=b, act=act: groupnorm.fused_group_norm(x, w, b, 32, 1e-6, act),
            plain=lambda x=x, w=w, b=b, act=act: groupnorm.fused_group_norm_plain(x, w, b, 32, 1e-6, act),
            library=lib, nbytes=2 * 2 * x.numel(), flops=10 * x.numel(), peak=PEAK_FP32,
            tol=2.0**-6, relative=True,  # 4 bf16 ulps: the apply rounds 4 times in bf16
        ))
    # K6 statistics where the naive E[x^2] - E[x]^2 cancels (mean 30, std 0.5;
    # its block-parallel form errs ~2e-4 in the scale a there, the shifted
    # sums ~3e-6) and with per-channel means in [-100, 100). Checks only
    # (count 0): a is held to the two-pass plain version within 2e-5.
    hw, c = 64, 512
    for label, mean in (("mean 30 std 0.5", torch.full((c,), 30.0, device=dev)),
                        ("channel means +-100", torch.rand(c, generator=gen, device=dev) * 200 - 100)):
        x = (torch.randn((B, hw, hw, c), generator=gen, device=dev) * 0.5 + mean).to(bf)
        w = torch.randn(c, generator=gen, device=dev) * 0.2 + 1.0
        b = torch.randn(c, generator=gen, device=dev) * 0.2
        cases.append(dict(
            name="groupnorm", shape=f"x[{B},{hw},{hw},{c}] {label}", count=0,
            kernel=lambda x=x, w=w, b=b: groupnorm.fused_group_norm(x, w, b, 32, 1e-6, "silu"),
            plain=lambda x=x, w=w, b=b: groupnorm.fused_group_norm_plain(x, w, b, 32, 1e-6, "silu"),
            library=lambda x=x, w=w, b=b: F.silu(
                F.group_norm(x.permute(0, 3, 1, 2), 32, w.to(bf), b.to(bf), 1e-6)),
            nbytes=2 * 2 * x.numel(), flops=10 * x.numel(), peak=PEAK_FP32,
            tol=2.0**-6, relative=True,
            scale_a=lambda x=x, w=w, b=b: (groupnorm.gn_affine_coeffs(x, w, b, 32, 1e-6)[1],
                                           groupnorm.gn_affine_coeffs_plain(x, w, b, 32, 1e-6)[1]),
            scale_a_tol=2e-5,
        ))
    return cases


def gn_conv_cases(torch, gen):
    """K7 at the 20 resnet convs of one SD-1.5 512^2 VAE encode (10 views),
    and the K6 coefficient kernel that feeds it. K7's tolerance: 2^-6 of the
    output's largest magnitude, one bf16 ulp for the elementwise roundings
    and one for a conv sum of 1152-4608 products taken in another order
    than cuDNN's fp32 one (it can land across a rounding boundary, and the
    ulp carries through the bias and residual adds). Its yardstick is the
    unfused path it replaces (K6 apply + cuDNN conv with bias + residual
    add), with the coefficient kernels' time at that shape subtracted, as
    K7 takes the coefficients as inputs."""
    import torch.nn.functional as F

    from stablekeypoints_tpu_torch.kernels import gn_conv, groupnorm

    bf = torch.bfloat16
    dev = "cuda"
    B = 10
    cases = []
    for hw, cin, cout, with_res, count in GN_CONV_SHAPES:
        x = (torch.randn((B, hw, hw, cin), generator=gen, device=dev) * 1.5 + 0.3).to(bf)
        w = torch.randn(cin, generator=gen, device=dev) * 0.2 + 1.0
        b = torch.randn(cin, generator=gen, device=dev) * 0.2
        m, a, bc = groupnorm.gn_affine_coeffs(x, w, b, 32, 1e-6)
        # the conv weight as the port holds it: OIHW in channels-last memory
        weight = (torch.randn((cout, cin, 3, 3), generator=gen, device=dev)
                  * (9 * cin) ** -0.5).to(bf).contiguous(memory_format=torch.channels_last)
        hwio = weight.permute(2, 3, 1, 0)
        bias = (torch.randn(cout, generator=gen, device=dev) * 0.1).to(bf)
        res = torch.randn((B, hw, hw, cout), generator=gen, device=dev).to(bf) if with_res else None

        def unfused(x=x, w=w, b=b, weight=weight, bias=bias, res=res):
            y = groupnorm.fused_group_norm(x, w, b, 32, 1e-6, "silu").permute(0, 3, 1, 2)
            y = F.conv2d(y, weight, bias, padding=1).permute(0, 2, 3, 1)
            return y if res is None else res + y

        def unfused_minus_coeffs(unfused=unfused, x=x, w=w, b=b, reps=3):
            coeffs = cuda_ms(lambda: groupnorm.gn_affine_coeffs(x, w, b, 32, 1e-6), reps)
            return max(cuda_ms(unfused, reps) - coeffs, 0.0)

        label = f"x[{B},{hw},{hw},{cin}]->{cout}{' +res' if with_res else ''}"
        cases.append(dict(
            name="gn_conv", shape=label, count=count,
            kernel=lambda x=x, m=m, a=a, bc=bc, k=hwio, bias=bias, res=res:
                gn_conv.fused_gn_silu_conv3x3(x, m, a, bc, k, bias, res),
            plain=lambda x=x, m=m, a=a, bc=bc, k=hwio, bias=bias, res=res:
                gn_conv.fused_gn_silu_conv3x3_plain(x, m, a, bc, k, bias, res),
            unfused_time=unfused_minus_coeffs,
            # read x, the weights, the coefficients (and the residual); write out
            nbytes=2 * (x.numel() + weight.numel() + B * hw * hw * cout * (2 if with_res else 1))
            + 4 * 3 * B * cin,
            flops=2 * B * hw * hw * cout * 9 * cin, peak=PEAK_BF16, tol=2.0**-6, relative=True,
        ))
        # K6's coefficient kernel (statistics and coefficients, one launch) on the same input
        cases.append(dict(
            name="gn_coeffs", shape=f"x[{B},{hw},{hw},{cin}]", count=count,
            kernel=lambda x=x, w=w, b=b: groupnorm.gn_affine_coeffs(x, w, b, 32, 1e-6),
            plain=lambda x=x, w=w, b=b: groupnorm.gn_affine_coeffs_plain(x, w, b, 32, 1e-6),
            library=lambda x=x: torch.var_mean(x.reshape(B, -1, 32, cin // 32).float(), dim=(1, 3)),
            nbytes=2 * x.numel() + 4 * 3 * B * cin, flops=3 * x.numel(), peak=PEAK_FP32,
            # m_q is bf16-valued (1 ulp: 2^-8 relative), a and b_comp fp32
            # from fp32 sums in another order; the partial sums merge in a
            # fixed order, so a second launch is bitwise equal
            tol=2.0**-7, relative=True, deterministic=True,
        ))
    return cases


def backward_cases(torch, gen):
    """The backward kernels at the shapes one SD-1.5 512^2 training step
    gives them (batch 4, merged batch [originals; warped] of 8), bf16, with
    the launches per step that the layer routing predicts. The library time
    is one PyTorch call's backward: SDPA fwd+bwd minus its fwd for K3/K4/K5,
    autograd through matmul + softmax + head-mean minus its forward for K1."""
    import torch.nn.functional as F

    from stablekeypoints_tpu_torch.kernels import attn_capture, cross_attn, flash
    from stablekeypoints_tpu_torch.ops.resize import resize_matrix

    bf = torch.bfloat16
    dev = "cuda"
    B, T = 8, 500

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def minus_forward(full, fwd):
        return lambda reps=3: max(cuda_ms(full, reps) - cuda_ms(fwd, reps), 0.0)

    cases = []
    for x, d, count in ((16, 160, 3), (32, 80, 1)):
        tt, k = randn(B, 8, 128, x, d), randn(B, T, 8, d)
        ww = resize_matrix(x, 128, "bicubic", bf, dev)
        g = randn(B, 128 * 128, T, scale=1e-3, dtype=torch.float32)
        scale = d ** -0.5
        q_up = torch.einsum("Px,bkOxd->bkOPd", ww, tt).reshape(B, 8, -1, d).requires_grad_()
        kh = k.permute(0, 2, 1, 3).detach().requires_grad_()

        def lib_fwd(q=q_up, kh=kh, s=scale):
            return torch.softmax(torch.matmul(q, kh.transpose(-1, -2)).float() * s, dim=-1).mean(1)

        n = 128 * 128
        cases.append(dict(
            name="capture_bwd", shape=f"tt[{B},8,128,{x},{d}] g[{B},{n},{T}]", count=count,
            kernel=lambda tt=tt, ww=ww, k=k, g=g, s=scale:
                attn_capture.capture_attention_fused_bwd(tt, ww, k, g, s),
            plain=lambda tt=tt, ww=ww, k=k, g=g, s=scale:
                attn_capture.capture_fused_bwd_plain(tt, ww, k, g, s),
            library_time=minus_forward(
                lambda f=lib_fwd, g=g, q=q_up, kh=kh: torch.autograd.grad(f(), (q, kh), g),
                lib_fwd),
            nbytes=2 * 2 * (tt.numel() + k.numel()) + 2 * ww.numel() + 4 * g.numel(),
            flops=2 * B * 8 * n * (3 * T * d + 2 * x * d), peak=PEAK_BF16,
            tol=2.0**-6, relative=True,
            exps=2 * B * 8 * n * T,  # one ex2 a score in the statistics, one in the backward
        ))

    def attention_bwd(name, fwd, bwd, n, m, h, d, count, with_o):
        q, k, v, do = randn(B, n, h, d), randn(B, m, h, d), randn(B, m, h, d), randn(B, n, h, d)
        s = d ** -0.5
        if with_o:
            o, lse = fwd(q, k, v, s, with_lse=True)
            kernel = lambda: bwd(q, k, v, o, do, lse, s)  # noqa: E731
            plain = lambda: flash.attention_bwd_plain(q, k, v, o, do, s)  # noqa: E731
        else:
            kernel = lambda: bwd(q, k, v, do, s)  # noqa: E731
            plain = lambda: cross_attn.cross_attention_bwd_plain(q, k, v, do, s)  # noqa: E731
        qg, kg, vg = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        dog = do.transpose(1, 2)

        def lib_fwd():
            return F.scaled_dot_product_attention(qg, kg, vg, scale=s)

        return dict(
            name=name, shape=f"q[{B},{n},{h},{d}] kv[{B},{m},{h},{d}]", count=count,
            kernel=kernel, plain=plain,
            library_time=minus_forward(
                lambda: torch.autograd.grad(lib_fwd(), (qg, kg, vg), dog), lib_fwd),
            # read q, k, v, do (and o, lse); write dq, dk, dv
            nbytes=2 * ((4 if with_o else 3) * q.numel() + 4 * k.numel())
            + (4 * B * h * n if with_o else 0),
            flops=10 * B * h * n * m * d, peak=PEAK_BF16, tol=2.0**-6, relative=True,
            exps=B * h * n * m,
        )

    # K3 backward: the two 64^2 cross layers of down_0
    cases.append(attention_bwd("cross_bwd", None, cross_attn.cross_attention_resident_bwd,
                               4096, T, 8, 40, 2, with_o=False))
    # K4 backward: down_0's second block (its first runs before any layer reads
    # the context), down_1 x2 and up_2's first block; no backward in the VAE
    for n, d, count in ((4096, 40, 1), (1024, 80, 3)):
        cases.append(attention_bwd("flash_self_bwd", flash.flash_self_attention,
                                   flash.flash_self_attention_bwd, n, n, 8, d, count, True))
    # K5 backward: down_1 x2 (up_2's cross output reaches no loss: truncation)
    cases.append(attention_bwd("flash_cross_bwd", flash.flash_cross_attention,
                               flash.flash_cross_attention_bwd, 1024, T, 8, 80, 2, True))

    # K2 backward at a 96^2 capture grid: up_1 (d 160) x3, up_2 (d 80) x1
    for d, count in ((160, 3), (80, 1)):
        n = 96 * 96
        q, k = randn(B, 8, n, d), randn(B, T, 8, d)
        g = randn(B, n, T, scale=1e-3, dtype=torch.float32)
        scale = d ** -0.5
        qg = q.detach().requires_grad_()
        kh = k.permute(0, 2, 1, 3).detach().requires_grad_()

        def lib_fwd(q=qg, kh=kh, s=scale):
            return torch.softmax(torch.matmul(q, kh.transpose(-1, -2)).float() * s, dim=-1).mean(1)

        cases.append(dict(
            name="capture_unfused_bwd", shape=f"q[{B},8,{n},{d}] g[{B},{n},{T}]", count=count,
            kernel=lambda q=q, k=k, g=g, s=scale: attn_capture.capture_attention_bwd(q, k, g, s),
            plain=lambda q=q, k=k, g=g, s=scale: attn_capture.capture_bwd_plain(q, k, g, s),
            library_time=minus_forward(
                lambda f=lib_fwd, g=g, q=qg, kh=kh: torch.autograd.grad(f(), (q, kh), g), lib_fwd),
            nbytes=2 * 2 * (q.numel() + k.numel()) + 4 * g.numel(),
            flops=2 * B * 8 * n * 3 * T * d, peak=PEAK_BF16, tol=2.0**-6, relative=True,
            exps=2 * B * 8 * n * T,  # one ex2 a score in the statistics, one in the backward
        ))
    return cases


KERNELS = {
    "capture": dict(route="cuda", source="stablekeypoints_tpu_torch/kernels/csrc/attn_capture.cu",
                    replaces="stablekeypoints_tpu/kernels/attn_capture.py:341"),
    "cross": dict(route="cuda", source="stablekeypoints_tpu_torch/kernels/csrc/cross_attn.cu",
                  replaces="stablekeypoints_tpu/kernels/cross_attn.py:152"),
    "flash_self": dict(route="cuda", source="stablekeypoints_tpu_torch/kernels/csrc/flash.cu",
                       replaces="stablekeypoints_tpu/kernels/flash.py:126"),
    "flash_cross": dict(route="cuda", source="stablekeypoints_tpu_torch/kernels/csrc/flash.cu",
                        replaces="stablekeypoints_tpu/kernels/flash.py:187"),
    # K6: the statistics (the TPU kernel at :110) in CUDA; the apply, jnp on
    # the TPU, is a Triton pass in the port
    "groupnorm": dict(route="cuda", source="stablekeypoints_tpu_torch/kernels/csrc/groupnorm.cu",
                      replaces="stablekeypoints_tpu/kernels/groupnorm.py:110"),
    "capture_bwd": dict(route="cuda", source="stablekeypoints_tpu_torch/kernels/csrc/attn_capture.cu",
                        replaces="stablekeypoints_tpu/kernels/attn_capture.py:367"),
    "cross_bwd": dict(route="cuda", source="stablekeypoints_tpu_torch/kernels/csrc/cross_attn.cu",
                      replaces="stablekeypoints_tpu/kernels/cross_attn.py:174"),
    "flash_self_bwd": dict(route="cuda", source="stablekeypoints_tpu_torch/kernels/csrc/attn_bwd.cuh",
                           replaces="stablekeypoints_tpu/kernels/flash.py:126"),
    "flash_cross_bwd": dict(route="cuda", source="stablekeypoints_tpu_torch/kernels/csrc/attn_bwd.cuh",
                            replaces="stablekeypoints_tpu/kernels/flash.py:187"),
    "gn_conv": dict(route="cuda", source="stablekeypoints_tpu_torch/kernels/csrc/gn_conv.cu",
                    replaces="stablekeypoints_tpu/kernels/gn_conv.py:251"),
    "gn_coeffs": dict(route="cuda", source="stablekeypoints_tpu_torch/kernels/csrc/groupnorm.cu",
                      replaces="stablekeypoints_tpu/kernels/groupnorm.py:110"),
    "capture_unfused": dict(route="cuda",
                            source="stablekeypoints_tpu_torch/kernels/csrc/attn_capture.cu",
                            replaces="stablekeypoints_tpu/kernels/attn_capture.py:252"),
    "capture_unfused_bwd": dict(route="cuda",
                                source="stablekeypoints_tpu_torch/kernels/csrc/attn_capture.cu",
                                replaces="stablekeypoints_tpu/kernels/attn_capture.py:284"),
}
# the run whose launch counts each kernel's row reports (its main path):
# backward kernels the training step, K2 the 96^2 capture phase, the rest
# the detect forward
LAUNCHES_FROM = {"capture_unfused": "capture96", "capture_unfused_bwd": "capture96",
                 **{n: "train" for n in ("capture_bwd", "cross_bwd", "flash_self_bwd",
                                         "flash_cross_bwd")}}


def counters():
    from stablekeypoints_tpu_torch.kernels import attn_capture, cross_attn, flash, gn_conv, groupnorm

    return {
        "capture": attn_capture.capture_attention_fused,
        "cross": cross_attn.cross_attention_resident,
        "flash_self": flash.flash_self_attention,
        "flash_cross": flash.flash_cross_attention,
        "groupnorm": groupnorm.fused_group_norm,
        "gn_coeffs": groupnorm.gn_affine_coeffs,
        "gn_conv": gn_conv.fused_gn_silu_conv3x3,
        "capture_unfused": attn_capture.capture_attention,
        "capture_bwd": attn_capture.capture_attention_fused_bwd,
        "cross_bwd": cross_attn.cross_attention_resident_bwd,
        "flash_self_bwd": flash.flash_self_attention_bwd,
        "flash_cross_bwd": flash.flash_cross_attention_bwd,
        "capture_unfused_bwd": attn_capture.capture_attention_bwd,
    }


def reset_counts():
    count = counters()
    for fn in count.values():
        fn.launches = 0
    return count


def check_counts(tag, count, per, units, unit_name):
    """Every kernel's launches since reset_counts() against per[name] x units."""
    launches = {n: fn.launches for n, fn in count.items()}
    for name, n in launches.items():
        want = per[name] * units
        print(f"[{tag}] launches {name:<19} {n} = {n / units:g} per {unit_name} "
              f"(expected {per[name]})")
        assert n == want, f"{tag} {name}: {n} launches, expected {want}"
    return launches


def phase_kernels(torch, out_dir, only=None):
    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = {n: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=None, unfused_ms=None,
                       bound_ms=0.0, ops_ms=0.0, bytes_ms=0.0, shapes=[]) for n in KERNELS}
    failures = []

    def add(total, value):
        return None if value is None else (total or 0.0) + value

    for case in kernel_cases(torch, gen):
        if only and case["name"] not in only:
            continue
        got = case["kernel"]()
        want = case["plain"]()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        # each output against its own largest magnitude
        errs = [((a.float() - w.float()).abs().max().item(),
                 case["tol"] * (w.float().abs().max().item() if case.get("relative") else 1.0))
                for a, w in zip(got, want)]
        finite = all(bool(torch.isfinite(a.float()).all().item()) for a in got)
        err, tol = max(errs, key=lambda e: e[0] / e[1])
        same = True
        if case.get("deterministic"):  # a second launch on the same inputs, bit for bit
            again = case["kernel"]()
            again = again if isinstance(again, tuple) else (again,)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            print(f"[kernel] {case['name']:<11} {case['shape']:<36} two launches bitwise equal: "
                  f"{same}", flush=True)
            del again
        del got, want
        ms = cuda_ms(case["kernel"], 5)
        plain_ms = cuda_ms(case["plain"], 2)
        if "library_time" in case:
            lib_ms = case["library_time"]()
        else:
            lib_ms = cuda_ms(case["library"], 5) if "library" in case else None
        unf_ms = case["unfused_time"]() if "unfused_time" in case else None
        b_ms, b_by = bound_ms(case["nbytes"], case["flops"], case["peak"])
        e_ms = exp_floor_ms(case["exps"]) if "exps" in case else None
        ok = finite and same and all(e <= t for e, t in errs)
        if "scale_a" in case:
            got, want = case["scale_a"]()
            a_err = ((got - want).abs() / want.abs()).max().item()
            ok = ok and a_err <= case["scale_a_tol"]
            print(f"[kernel] {case['name']:<11} {case['shape']:<36} scale a: max rel err "
                  f"{a_err:.3e} (tol {case['scale_a_tol']:.0e}) vs the two-pass plain version")
        other = (f"library {lib_ms:.3f} ms" if lib_ms is not None
                 else f"unfused path {unf_ms:.3f} ms" if unf_ms is not None else "no library call")
        print(f"[kernel] {case['name']:<11} {case['shape']:<36} x{case['count']} "
              f"max_abs_err {err:.3e} (tol {tol:.3e}) {'OK' if ok else 'FAIL'} | "
              f"kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  {other}  "
              f"bound {b_ms:.3f} ms ({b_by})"
              + (f"  exp floor {e_ms:.3f} ms" if e_ms is not None else ""), flush=True)
        if not ok:
            failures.append(f"{case['name']} {case['shape']}: err {err} finite {finite} "
                            f"deterministic {same}")
        s = summary[case["name"]]
        c = case["count"]
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s["ms"] += c * ms
        s["plain_ms"] += c * plain_ms
        s["library_ms"] = add(s["library_ms"], None if lib_ms is None else c * lib_ms)
        s["unfused_ms"] = add(s["unfused_ms"], None if unf_ms is None else c * unf_ms)
        s["ops_ms"] += c * case["flops"] / case["peak"] * 1e3
        s["bytes_ms"] += c * case["nbytes"] / HBM_BYTES_PER_S * 1e3
        s["bound_ms"] = max(s["ops_ms"], s["bytes_ms"])
        s["shapes"].append(dict(shape=case["shape"], count=c, ms=ms, plain_ms=plain_ms,
                                library_ms=lib_ms, unfused_ms=unf_ms, bound_ms=b_ms, bound_by=b_by,
                                exp_floor_ms=e_ms, max_abs_err=err))
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, "kernels.json"), "w") as f:
        json.dump(summary, f, indent=1)
    if failures:
        raise AssertionError("kernel checks failed: " + "; ".join(failures))
    return summary


def detect_seconds(torch, model, images, m):
    t0 = time.time()
    pts = model.detect_batch(images[:m])
    torch.cuda.synchronize()
    return time.time() - t0, pts


def maps_vs_plain(torch, rt, ctx, image, tag, card):
    """The ensembled maps of `rt` against a runtime of the same weights with
    every kernel switched off (plain PyTorch layers), same random views."""
    import numpy as np

    from stablekeypoints_tpu_torch.pipeline.runtime import Runtime

    cfg = rt.cfg
    rt_plain = Runtime.create(dataclasses.replace(cfg, pallas_capture="off", flash_attention="off",
                                                  fused_groupnorm="off", fused_gn_conv="off"))
    maps = {}
    for name, r in (("kernels", rt), ("plain", rt_plain)):
        gen = torch.Generator(device="cuda").manual_seed(3)
        maps[name] = r.augmented_maps(ctx, image, np.arange(cfg.top_k), generator=gen)
    ref = maps["plain"]
    rel = ((maps["kernels"] - ref).abs().max() / ref.abs().max()).item()
    kp = torch.stack([maps[k].flatten(1).argmax(1) for k in maps])
    agree = (kp[0] == kp[1]).float().mean().item()
    print(f"[{tag}] ensembled maps, kernels vs plain layers: max abs err / max {rel:.3e} "
          f"(tol 5e-2); argmax agreement {agree:.2f} | {card}", flush=True)
    assert rel <= 5e-2, rel
    del rt_plain, maps, ref
    torch.cuda.empty_cache()
    return rel, agree


def phase_detect(torch, card, out_dir):
    import numpy as np

    from stablekeypoints_tpu_torch.api import KeypointModel
    from stablekeypoints_tpu_torch.config import Config
    from stablekeypoints_tpu_torch.pipeline.runtime import Runtime

    t0 = time.time()
    cfg = Config()  # SD-1.5, 512^2, 500 tokens, top_k 10, 10 views, bf16, every kernel on
    rt = Runtime.create(cfg)
    torch.cuda.synchronize()
    print(f"[detect] SD-1.5 runtime from seed {cfg.seed}: {time.time() - t0:.1f} s "
          f"({sum(p.numel() for p in rt.unet.parameters()) / 1e6:.0f}M UNet params)", flush=True)
    ctx = torch.randn((1, cfg.num_tokens, 768), generator=torch.Generator().manual_seed(1))
    model = KeypointModel(rt, ctx.numpy(), np.arange(cfg.top_k))
    # the same weights with K7 off: the VAE resnets run K6 apply + cuDNN conv + add
    model_off = KeypointModel(Runtime.create(dataclasses.replace(cfg, fused_gn_conv="off")),
                              ctx.numpy(), np.arange(cfg.top_k))
    rng = np.random.default_rng(2)
    images = rng.uniform(0, 1, (4, cfg.image_size, cfg.image_size, 3)).astype(np.float32)

    t0 = time.time()
    for mdl in (model, model_off):  # warm-up: Triton compiles, cuDNN picks algorithms
        mdl.detect_batch(images[:1])
    torch.cuda.synchronize()
    print(f"[detect] warm-up M=1, K7 on and off: {time.time() - t0:.2f} s", flush=True)

    count = reset_counts()
    torch.cuda.reset_peak_memory_stats()
    results, secs = {}, {}
    for m in (1, 4):
        secs[m], results[m] = detect_seconds(torch, model, images, m)
    passes = sum(-(-m * cfg.augmentation_iterations // rt.views_per_pass(m * cfg.augmentation_iterations))
                 for m in (1, 4))
    launches = check_counts("detect", count, PER_PASS, passes, "pass")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for m, pts in results.items():
        assert pts.shape == (m, cfg.top_k, 2), pts.shape
        assert np.isfinite(pts).all() and (pts >= 0).all() and (pts <= 1).all(), pts
    # K7 off, then both once more, in turns
    secs_off = {m: detect_seconds(torch, model_off, images, m)[0] for m in (1, 4)}
    again = {m: detect_seconds(torch, model, images, m)[0] for m in (1, 4)}
    again_off = {m: detect_seconds(torch, model_off, images, m)[0] for m in (1, 4)}
    for m in (1, 4):
        print(f"[detect] M={m}: K7 on {secs[m]:.3f} s = {secs[m] / m:.4f} s/image, then "
              f"{again[m] / m:.4f}; K7 off {secs_off[m] / m:.4f} s/image, then "
              f"{again_off[m] / m:.4f} | {card}")
    print(f"[detect] peak device memory {peak_gib:.2f} GiB | {card}")
    print(f"[detect] keypoints image 0: {np.round(results[1][0], 4).tolist()}", flush=True)

    profile = profile_call(torch, lambda: model.detect_batch(images[:1]), "one M=1 detect",
                           out_dir, "profile.txt", card, secs[1] * 1e3)
    del model_off
    torch.cuda.empty_cache()
    rel, agree = maps_vs_plain(torch, rt, ctx, images[0], "detect", card)
    return rt, dict(launches=launches, s_per_image={m: secs[m] / m for m in secs},
                    s_per_image_again={m: again[m] / m for m in again},
                    s_per_image_k7_off={m: secs_off[m] / m for m in secs_off},
                    s_per_image_k7_off_again={m: again_off[m] / m for m in again_off},
                    peak_gib=peak_gib, maps_rel_err=rel, argmax_agree=agree, profile=profile)


def run_stage1(torch, rt, data, ctx0, gen, steps, log_dir):
    """optimize_embedding for `steps` steps with each step timed (host clock
    around a synchronised step). Returns (learned context, {fill: [s],
    cached: [s]}, the counters, the logged losses)."""
    from stablekeypoints_tpu_torch.pipeline.optimize import optimize_embedding
    from stablekeypoints_tpu_torch.utils.logging import MetricsLogger

    secs = {"fill": [], "cached": []}
    for kind in secs:
        step_fn = getattr(rt, f"train_step_{kind}")

        def timed(*a, _fn=step_fn, _kind=kind, **k):
            torch.cuda.synchronize()
            start = time.time()
            out = _fn(*a, **k)
            torch.cuda.synchronize()
            secs[_kind].append(time.time() - start)
            return out

        setattr(rt, f"train_step_{kind}", timed)
    if os.path.exists(os.path.join(log_dir, "metrics.jsonl")):  # the logger appends
        os.remove(os.path.join(log_dir, "metrics.jsonl"))
    logger = MetricsLogger(log_dir)
    cfg = rt.cfg
    count = reset_counts()
    rt.cfg = dataclasses.replace(cfg, num_steps=steps, log_every=1)
    try:
        learned = optimize_embedding(rt, data, logger, context=ctx0, generator=gen)
    finally:
        rt.cfg = cfg
        logger.close()
        for kind in secs:
            del rt.__dict__[f"train_step_{kind}"]
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        losses = [json.loads(line)["loss"] for line in f if '"loss"' in line]
    return learned, secs, count, losses


def phase_train(torch, rt, card, out_dir, tag="train", per_step=PER_STEP):
    """Stage 1 on an SD-1.5 runtime: optimize_embedding on SyntheticBlobs(8
    images, 512^2), batch 4, 4 timed steps (an epoch of fill steps, then one
    of cached steps) after one untimed fill and one untimed cached step;
    launch counts per step; a profile of one cached step;
    the gradient of a fixed loss through the kernels vs the plain layers."""
    import numpy as np

    from stablekeypoints_tpu_torch.data.synthetic import SyntheticBlobs

    cfg = rt.cfg
    data = SyntheticBlobs(length=8, image_size=cfg.image_size)
    images = np.stack([data[i]["img"] for i in range(cfg.batch_size)])
    gen = torch.Generator(device=rt.device).manual_seed(5)
    ctx0 = rt.init_context()

    t0 = time.time()
    context = rt.train_context(ctx0)
    opt = rt.optimizer(context)
    lat = rt.train_step_fill(context, opt, images, generator=gen)[3]
    rt.train_step_cached(context, opt, lat, images, generator=gen)
    torch.cuda.synchronize()
    print(f"[{tag}] warm-up (one fill, one cached step): {time.time() - t0:.2f} s", flush=True)

    torch.cuda.reset_peak_memory_stats()
    steps = 4
    learned, secs, count, losses = run_stage1(torch, rt, data, ctx0, gen, steps,
                                              os.path.join(out_dir, tag))
    launches = check_counts(tag, count, per_step, steps, "step")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    moved = (learned - ctx0).abs().max().item()
    print(f"[{tag}] losses per step: {[round(x, 6) for x in losses]}; context moved by up to "
          f"{moved:.3e}", flush=True)
    assert len(losses) == steps and all(np.isfinite(losses)), losses
    assert len(secs["fill"]) == 2 and len(secs["cached"]) == 2, secs
    assert moved > 0 and torch.isfinite(learned).all()
    s_fill, s_cached = (sum(secs[k]) / len(secs[k]) for k in ("fill", "cached"))
    print(f"[{tag}] SD-1.5 512^2 batch 4, {cfg.feature_upsample_res}^2 capture: fill "
          f"{s_fill:.4f} s/step {secs['fill']}, cached {s_cached:.4f} s/step {secs['cached']} "
          f"| {card}")
    print(f"[{tag}] peak device memory {peak_gib:.2f} GiB | {card}", flush=True)

    label = ("one cached training step" if tag == "train"
             else f"one cached training step at a {cfg.feature_upsample_res}^2 capture")
    profile = profile_call(torch, lambda: rt.train_step_cached(context, opt, lat, images,
                                                               generator=gen),
                           label, out_dir, f"profile_{tag}.txt", card, s_cached * 1e3)
    del context, opt, lat
    torch.cuda.empty_cache()
    grad = gradient_check(torch, rt, data, card, tag)
    return learned, dict(s_per_step_fill=s_fill, s_per_step_cached=s_cached, secs=secs,
                         launches=launches, peak_gib=peak_gib, losses=losses, profile=profile,
                         grad_check=grad)


def phase_vote(torch, rt, context, card):
    """Stage 2 on the runtime: find_best_indices over 8 SyntheticBlobs
    images (batch 4) with the learned context, after one untimed vote batch;
    then learn_keypoints (2 steps, 4 voted images) and one detect."""
    import numpy as np

    from stablekeypoints_tpu_torch.api import learn_keypoints
    from stablekeypoints_tpu_torch.data.synthetic import SyntheticBlobs
    from stablekeypoints_tpu_torch.pipeline.indices import find_best_indices
    from stablekeypoints_tpu_torch.pipeline.runtime import Runtime

    cfg = dataclasses.replace(rt.cfg, num_indices=8)
    vote_rt = Runtime(cfg, rt.unet, rt.vae, rt.schedule, rt.device)
    data = SyntheticBlobs(length=8, image_size=cfg.image_size)
    gen = torch.Generator(device="cuda").manual_seed(7)
    vote_rt.select_indices(context, np.stack([data[i]["img"] for i in range(4)]), generator=gen)
    torch.cuda.synchronize()

    count = reset_counts()
    t0 = time.time()
    indices = find_best_indices(vote_rt, data, context, generator=gen)
    torch.cuda.synchronize()
    secs = time.time() - t0
    batches = -(-cfg.num_indices // cfg.batch_size)
    launches = check_counts("vote", count, PER_PASS, batches, "vote batch")
    print(f"[vote] top-{cfg.top_k} indices over {cfg.num_indices} images: {indices.tolist()}")
    assert indices.shape == (cfg.top_k,) and len(set(indices.tolist())) == cfg.top_k
    assert ((indices >= 0) & (indices < cfg.num_tokens)).all(), indices
    print(f"[vote] {secs:.3f} s = {secs / cfg.num_indices:.4f} s/image (batch {cfg.batch_size}) "
          f"| {card}", flush=True)

    lk_rt = Runtime(dataclasses.replace(rt.cfg, num_steps=2, num_indices=4), rt.unet, rt.vae,
                    rt.schedule, rt.device)
    t0 = time.time()
    model = learn_keypoints(data, runtime=lk_rt)
    pts = model.detect(data[0]["img"])
    torch.cuda.synchronize()
    lk_secs = time.time() - t0
    print(f"[vote] learn_keypoints (2 steps, 4 voted images) -> indices {model.indices.tolist()} "
          f"-> detect {np.round(pts[:3], 4).tolist()}...: {lk_secs:.2f} s | {card}", flush=True)
    assert pts.shape == (cfg.top_k, 2) and np.isfinite(pts).all()
    assert (pts >= 0).all() and (pts <= 1).all()
    assert len(set(model.indices.tolist())) == cfg.top_k
    return dict(launches=launches, indices=indices.tolist(), seconds=secs,
                s_per_image=secs / cfg.num_indices, learn_keypoints_seconds=lk_secs)


def phase_capture96(torch, rt, card, out_dir):
    """The same weights at a 96^2 capture grid: the layers route every
    capture to K2 (96^2 rows are not tiled by K1's query blocks)."""
    import numpy as np

    from stablekeypoints_tpu_torch.api import KeypointModel
    from stablekeypoints_tpu_torch.pipeline.runtime import Runtime

    rt96 = Runtime(dataclasses.replace(rt.cfg, feature_upsample_res=96), rt.unet, rt.vae,
                   rt.schedule, rt.device)
    _, train = phase_train(torch, rt96, card, out_dir, tag="capture96", per_step=PER_STEP_96)

    cfg = rt96.cfg
    ctx = torch.randn((1, cfg.num_tokens, 768), generator=torch.Generator().manual_seed(1))
    model = KeypointModel(rt96, ctx.numpy(), np.arange(cfg.top_k))
    image = np.random.default_rng(2).uniform(0, 1, (1, cfg.image_size, cfg.image_size, 3))
    image = image.astype(np.float32)
    model.detect_batch(image)  # warm-up at the new capture grid
    count = reset_counts()
    secs, pts = detect_seconds(torch, model, image, 1)
    passes = -(-cfg.augmentation_iterations // rt96.views_per_pass(cfg.augmentation_iterations))
    detect_launches = check_counts("capture96", count, PER_PASS_96, passes, "pass")
    assert np.isfinite(pts).all() and (pts >= 0).all() and (pts <= 1).all(), pts
    print(f"[capture96] detect M=1: {secs:.4f} s/image | {card}", flush=True)
    rel, agree = maps_vs_plain(torch, rt96, ctx, image[0], "capture96", card)
    # "launches" stays the training run's (4 steps): K2 forward and backward
    return dict(train, detect_launches=detect_launches, detect_s_per_image=secs,
                maps_rel_err=rel, argmax_agree=agree)


def gradient_check(torch, rt, data, card, tag="train", batch=2):
    """The context gradient of a fixed loss through the kernels against the
    same through the plain layers (every kernel off), both on the card, bf16.
    Token indices and Gaussian targets are chosen once from the plain path's
    maps (in bf16 the two paths could select differently), so both paths
    differentiate one function: sharpening (MSE to fixed targets) +
    equivariance on those tokens, weighted as the training loss."""
    import numpy as np

    from stablekeypoints_tpu_torch.ops.gaussians import gaussian_circles
    from stablekeypoints_tpu_torch.ops.keypoints import find_k_max_pixels
    from stablekeypoints_tpu_torch.ops.losses import equivariance_loss
    from stablekeypoints_tpu_torch.ops.selection import furthest_point_sampling, select_candidates
    from stablekeypoints_tpu_torch.ops.transforms import apply_affine, sample_thetas
    from stablekeypoints_tpu_torch.pipeline.runtime import Runtime

    cfg = rt.cfg
    rt_plain = Runtime.create(dataclasses.replace(cfg, pallas_capture="off", flash_attention="off",
                                                  fused_groupnorm="off", fused_gn_conv="off"))
    gen = torch.Generator(device=rt.device).manual_seed(6)
    images = torch.from_numpy(np.stack([data[i]["img"] for i in range(batch)])).to(rt.device)
    thetas = sample_thetas(gen, batch, rt.aff)
    both = torch.cat([images, apply_affine(images, thetas)])
    noise = torch.randn(rt.latent_shape(2 * batch, cfg.image_size), generator=gen, device=rt.device)
    ctx0 = rt.init_context()

    def maps_of(r, context):
        return r._attn_maps(both, context, noise, -1, None, True, latents=r._encode(both))

    with torch.no_grad():
        ref = maps_of(rt_plain, ctx0)
    chosen = []
    for i in range(batch):
        cands = select_candidates(ref[i], cfg.top_k_strategy, cfg.furthest_point_num_samples,
                                  sigma=cfg.sigma, num_subjects=cfg.num_subjects)
        idx = furthest_point_sampling(ref[batch + i], cfg.top_k, cands)
        pos = find_k_max_pixels(ref[i][idx], num=cfg.num_subjects) / ref.shape[-1]
        chosen.append((idx, gaussian_circles(pos, ref.shape[-1], cfg.sigma)))

    def grad_of(r):
        context = r.train_context(ctx0)
        maps = maps_of(r, context)
        sl = torch.stack([((maps[i][idx] - target) ** 2).mean()
                          for i, (idx, target) in enumerate(chosen)]).mean()
        el = torch.stack([equivariance_loss(maps[i][idx], maps[batch + i][idx], thetas[i])
                          for i, (idx, _) in enumerate(chosen)]).mean()
        loss = sl * cfg.sharpening_loss_weight + el * cfg.equivariance_attn_loss_weight
        (g,) = torch.autograd.grad(loss, context)
        return g, loss.item()

    g_plain, loss_plain = grad_of(rt_plain)
    del rt_plain
    torch.cuda.empty_cache()
    g_kernel, loss_kernel = grad_of(rt)
    rel = ((g_kernel - g_plain).abs().max() / g_plain.abs().max()).item()
    cos = torch.nn.functional.cosine_similarity(g_kernel.flatten(), g_plain.flatten(), dim=0).item()
    print(f"[{tag}] fixed-loss context gradient, kernels vs plain layers (batch {batch}): "
          f"max abs err / max {rel:.3e} (tol 5e-2), cosine {cos:.5f} (tol >= 0.99); "
          f"loss {loss_kernel:.6f} vs {loss_plain:.6f} | {card}", flush=True)
    assert np.isfinite(rel) and rel <= 5e-2 and cos >= 0.99, (rel, cos)
    return dict(rel_err=rel, cosine=cos, loss_kernel=loss_kernel, loss_plain=loss_plain)


def profile_call(torch, fn, label, out_dir, filename, card, wall_ms):
    """Device time by kernel over one warm call of `fn` (torch.profiler,
    CUPTI), grouped by layer. The busy share is that device time over
    `wall_ms`, the unprofiled host-clock time of the same call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows, host_rows, ranges = [], [], {}
    for e in prof.key_averages():
        if e.key.startswith("train_step."):  # the step's named ranges, host side only
            if e.device_type == torch.autograd.DeviceType.CPU:
                ranges[e.key] = e.cpu_time_total / 1e3
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        # host ops carry the time of the kernels they launch: count kernels only
        kernel = e.device_type == torch.autograd.DeviceType.CUDA
        (rows if kernel else host_rows).append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    groups = {}
    for ms, _, key in rows:
        group = next((g for g, marks in PROFILE_GROUPS if any(m in key for m in marks)), "other")
        groups[group] = groups.get(group, 0.0) + ms
    busy_ms = sum(r[0] for r in rows)
    with open(os.path.join(out_dir, filename), "w") as f:
        f.write(f"{card}\nunprofiled wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms\n")
        for ms, n, key in rows:
            f.write(f"{ms:10.3f} ms {n:6d}  {key}\n")
        f.write("host ops (device time of the kernels they launch):\n")
        for ms, n, key in sorted(host_rows, reverse=True):
            f.write(f"{ms:10.3f} ms {n:6d}  {key}\n")
    if not rows:
        print("[profile] no device time in the trace: not measured", flush=True)
        return None
    print(f"[profile] {label}: device busy {busy_ms:.1f} ms of "
          f"{wall_ms:.1f} ms wall ({busy_ms / wall_ms:.0%}) | {card}")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {g:<24} {ms:9.3f} ms  {ms / busy_ms:6.1%}")
    for ms, n, key in rows[:12]:
        print(f"[profile] {ms:9.3f} ms {n:5d}x  {key[:90]}")
    launches = sum(n for _, n, _ in rows)
    print(f"[profile] {launches} device kernels and copies; host time of the named ranges "
          f"(profiled, so inflated): " + ", ".join(f"{k} {v:.1f} ms" for k, v in ranges.items()))
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, groups=groups, launches=launches,
                host_ranges_ms=ranges, top=[list(r) for r in rows[:25]])


# kernel-name marks of each layer in a device trace, first match wins
# (attn_fwd_kernel<D, mode>: mode 0 K4/K5, 1 K3's backward statistics)
PROFILE_GROUPS = (
    ("K1/K2 capture bwd", ("capture_stats_kernel", "capture_bwd_kernel", "capture_dt_kernel",
                           "capture_dq_kernel")),
    ("K3/K4/K5 attention bwd", ("attn_bwd_kernel", "dq_convert_kernel", "flash_di_kernel",
                                "attn_fwd_kernel<40, 1>", "attn_fwd_kernel<80, 1>")),
    ("K1/K2 capture", ("capture_fwd_kernel",)),
    ("K7 gn_conv", ("gn_conv_kernel",)),
    ("K3 cross", ("cross_fwd_kernel",)),
    ("K4/K5 flash", ("attn_fwd_kernel", "flash_wide_kernel")),
    ("K6 groupnorm", ("gn_coeffs_kernel", "apply_kernel")),
    ("convolution (cuDNN)", ("fprop", "conv", "Conv", "nchw", "nhwc")),
    ("matmul (cuBLAS)", ("gemm", "nvjet", "Kernel2")),
)


PHASES = ("kernels", "detect", "train", "vote", "capture96")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of " + ",".join(PHASES))
    parser.add_argument("--kernels", default="",
                        help="comma-separated kernel names: check only these in the kernels phase")
    args = parser.parse_args()
    phases = args.phases.split(",")
    if set(phases) - set(PHASES):
        parser.error(f"unknown phases {sorted(set(phases) - set(PHASES))}")
    full = set(phases) == set(PHASES) and not args.kernels

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from stablekeypoints_tpu_torch.kernels import _build  # fails outside a checkout

    start = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    card = card_line()
    global SM_COUNT, SM_CLOCK_HZ, SPIN_CYCLES_PER_S
    SM_COUNT = torch.cuda.get_device_properties(0).multi_processor_count
    SM_CLOCK_HZ = max_sm_clock_hz()
    SPIN_CYCLES_PER_S = SM_CLOCK_HZ * 1.1
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {torch.cuda.get_device_name(0)} | {card} | {SM_COUNT} SMs, max SM clock "
          f"{SM_CLOCK_HZ / 1e6:.0f} MHz | TF32 off: matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN {torch.backends.cudnn.allow_tf32}",
          flush=True)

    t0 = time.time()
    logs = _build.build_all()
    print(f"[build] nvcc sm_90a, {len(_build.SOURCES)} sources in parallel: "
          f"{time.time() - t0:.1f} s", flush=True)
    with open(os.path.join(out_dir, "ptxas.log"), "w") as f:
        for name, log in logs.items():
            f.write(f"== {name}\n{log}\n")
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[build] {name}: {line.strip()}")

    results = {}
    summary = None
    if "kernels" in phases:
        summary = phase_kernels(torch, out_dir, set(filter(None, args.kernels.split(","))))
    rt = None
    if "detect" in phases:
        rt, results["detect"] = phase_detect(torch, card, out_dir)
    if rt is None and set(phases) & {"train", "vote", "capture96"}:
        from stablekeypoints_tpu_torch.config import Config
        from stablekeypoints_tpu_torch.pipeline.runtime import Runtime

        rt = Runtime.create(Config())
    context = None
    if "train" in phases:
        context, results["train"] = phase_train(torch, rt, card, out_dir)
    if "vote" in phases:
        results["vote"] = phase_vote(torch, rt, rt.init_context() if context is None else context,
                                     card)
    if "capture96" in phases:
        results["capture96"] = phase_capture96(torch, rt, card, out_dir)
    for name, res in results.items():
        with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
            json.dump(dict(res, card=card), f, indent=1)
    print(f"[total] {time.time() - start:.1f} s", flush=True)
    if not full:
        print(f"chip_smoke: partial run ({','.join(phases)}): no result line")
        return 0

    rows = []
    for name, meta in KERNELS.items():
        s = summary[name]
        src = LAUNCHES_FROM.get(name, "detect")
        rows.append(dict(
            name=name, **meta, launches=results[src]["launches"][name],
            max_abs_err=s["max_abs_err"], ms=s["ms"], plain_ms=s["plain_ms"],
            bound_ms=s["bound_ms"],
            bound_by="operations" if s["ops_ms"] >= s["bytes_ms"] else "bytes",
            library_ms=s["library_ms"], unfused_ms=s["unfused_ms"],
            # the run whose shapes the times above are for
            per={"train": "one training step",
                 "capture96": "one training step at a 96^2 capture grid (forward shapes: "
                              "a detect pass, 10 views)"}.get(src, "one detect forward pass"),
            launches_by_phase={p: results[p]["launches"][name] for p in results},
        ))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
