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
  7. cli      the five-stage CLI, `stablekeypoints_tpu_torch.main.main`, at
              full width on a synthetic CelebA layout of 16 images of 512^2
              (examples/make_synthetic_celeba.py: 12 train/regression, 4
              test): 4 stage-1 steps (checkpoint every 2), the vote over 8
              images, stage 3 on 12 images and stage 5 on 4 in chunks of 4;
              launch counts per step, vote batch and stage-3/5 chunk;
              s/step and s/image per stage; the artifact set; a --resume
              rerun that reuses the artifacts; a mid-stage resume of
              optimize_embedding from the step-2 checkpoint; learn_keypoints
              on the image folder and one detect.
  8. weights  a full-width SD-1.5 diffusers directory written by the port's
              fabricate_checkpoint (UNet fp16 safetensors, VAE fp32 .bin
              under diffusers-0.8 names), Runtime.create(model_path=...) on
              the card: load time, peak memory, every parameter bitwise the
              file's cast; one M=1 detect's maps against the plain layers.
  9. generate generate_images on the loaded runtime (2 images, 50 DDIM
              steps) at guidance 1.0 and 7.5 (with the final-step capture):
              s/image, launches per call, per UNet forward and per decode; a
              profile of one guided step and of one decode; the guided eps
              against the plain layers, a decode against the fp32 plain
              layers (within twice the bf16 plain layers' own error).
 10. visualize  visualize_attn_maps and create_vid on 4 synthetic CelebA
              images (plots where matplotlib imports); latent_warp: an M=1
              detect (one encode of the image) against the plain layers, a
              fill and a cached step, the fixed-loss context gradient.
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
import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
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
# K7 per SD-1.5 VAE decode of 64^2 latents: the mid block and up_0 at 64^2, up_1 at
# 128^2, up_2 (512 -> 256 first) at 256^2, up_3 (256 -> 128 first) at 512^2; 14
# resnets, 28 launches
DECODE_GN_CONV_SHAPES = ((64, 512, 512, False, 5), (64, 512, 512, True, 5),
                         (128, 512, 512, False, 3), (128, 512, 512, True, 3),
                         (256, 512, 256, False, 1), (256, 256, 256, False, 2),
                         (256, 256, 256, True, 3), (512, 256, 128, False, 1),
                         (512, 128, 128, False, 2), (512, 128, 128, True, 3))
GEN_BATCH = 2  # images a generate call (and the decode's batch)
# launches per full (untruncated) SD-1.5 UNet forward at 512^2 with a learned
# context or the 77-token unconditional one: self-attention K4 at 64^2 (d40) and
# 32^2 (d80) x5 each, cross-attention K3 at 64^2 x5 and K5 at 32^2 x5; 16^2 and
# 8^2 take the plain route. A DDIM step with guidance runs two.
ZERO = {n: 0 for n in PER_PASS}
PER_UNET_FORWARD = dict(ZERO, cross=5, flash_self=10, flash_cross=5)
# per VAE decode: 28 K7, the d-512 mid attention, the K6 applies of the mid
# attention's norm and conv_norm_out, and 30 K6 coefficient launches (28 for K7)
PER_DECODE = dict(ZERO, gn_conv=28, gn_coeffs=30, groupnorm=2, flash_self=1)
# the final-step capture: one truncated UNet forward (the detect pass without its encode)
PER_CAPTURE_FORWARD = dict(ZERO, capture=4, cross=2, flash_self=5, flash_cross=3)
# a latent-warp cached training step encodes nothing
PER_STEP_WARP_CACHED = dict(PER_STEP, gn_conv=0, gn_coeffs=0, groupnorm=0, flash_self=5)

# SD-2.x at 768^2 and SDXL at 1024^2 (64-dim heads): launches per detect pass
# (one VAE encode, one UNet forward). Neither forward is truncated: only three
# stacks are under the 32^2 capture cap (SD-2.1's up_1 at 24^2, SDXL's up_0
# at 32^2), so 3 maps. The VAE encoder's 20 resnet convs pass K7's gate at
# every level, and its d-512 attention runs at seq 96^2 / 128^2.
# SD-2.1: K4 and K3 at 96^2 (5 heads) x5 and 48^2 (10 heads) x5 each; the
# 24^2 and 12^2 attentions are under the flash band and stay plain.
PER_PASS_SD21 = dict(ZERO, capture=3, cross=10, flash_self=11, groupnorm=2, gn_coeffs=22,
                     gn_conv=20)
# SDXL: 64^2 (10 heads; down_1, up_1, depth 2) K4 x10, K3 x10; 32^2 (20 heads;
# down_2, mid, up_0, depth 10) K4 x60, K5 x60
PER_PASS_SDXL = dict(ZERO, capture=3, cross=10, flash_self=71, flash_cross=60, groupnorm=2,
                     gn_coeffs=22, gn_conv=20)
# backward per training step: a layer after the last capture reaches no loss,
# and the first self-attention (it reads no context yet) gets no gradient.
# SD-2.1: K4 down_0 x1 + down_1 x2, K3 down_0 x2 + down_1 x2, K1 x3
PER_STEP_SD21 = dict(PER_PASS_SD21, capture_bwd=3, cross_bwd=4, flash_self_bwd=3)
# SDXL: K4 down_1 x3, down_2 x20, mid x10, up_0 x21 (two whole stacks and the
# third's first block, which captures); K3 down_1 x4; K5 down_2 x20, mid x10,
# up_0 x20; K1 x3
PER_STEP_SDXL = dict(PER_PASS_SDXL, capture_bwd=3, cross_bwd=4, flash_self_bwd=54,
                     flash_cross_bwd=50)
# SD-2.1 at a 96^2 capture grid: the three captures run K2 (d 64) instead of K1
PER_STEP_SD21_96 = dict(PER_STEP_SD21, capture=0, capture_bwd=0, capture_unfused=3,
                        capture_unfused_bwd=3)
# one full SDXL UNet forward (a generation step runs two with guidance), and
# the final-step capture forward (the same forward: nothing truncates it)
PER_UNET_FORWARD_SDXL = dict(ZERO, cross=10, flash_self=70, flash_cross=60)
PER_CAPTURE_FORWARD_SDXL = dict(PER_UNET_FORWARD_SDXL, capture=3)
# the two backbones' main paths: --model_type, resolution, training batch
# (the JAX package's bench.py: sd21 768^2 batch 2, sdxl 1024^2 batch 1)
BACKBONES = {
    "sd21": dict(model_type="stabilityai/stable-diffusion-2-1", image_size=768, batch_size=2,
                 per_pass=PER_PASS_SD21, per_step=PER_STEP_SD21, label="SD-2.1 768^2"),
    "sdxl": dict(model_type="stabilityai/stable-diffusion-xl-base-1.0", image_size=1024,
                 batch_size=1, per_pass=PER_PASS_SDXL, per_step=PER_STEP_SDXL,
                 label="SDXL 1024^2"),
}
# K7 per VAE encode at 768^2 and 1024^2: GN_CONV_SHAPES' levels scaled
GN_CONV_SHAPES_AT = {size: tuple((hw * size // 512, *rest) for hw, *rest in GN_CONV_SHAPES)
                     for size in (768, 1024)}


def scaled(per, n):
    return {k: v * n for k, v in per.items()}


def added(*pers):
    return {k: sum(p[k] for p in pers) for k in pers[0]}


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


def _randn(torch, gen, *shape, scale=1.0, dtype=None):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype or torch.bfloat16)


def _minus_forward(full, fwd):
    """The library time of a backward: one autograd call of the forward and
    its backward, less the forward."""
    return lambda reps=3: max(cuda_ms(full, reps) - cuda_ms(fwd, reps), 0.0)


def _headmean(q, kh, s):
    """One PyTorch expression of the capture: matmul, softmax, head-mean."""
    import torch

    return torch.softmax(torch.matmul(q, kh.transpose(-1, -2)).float() * s, dim=-1).mean(1)


def attention_case(torch, gen, name, b, n, m, h, d, count, path=None, row=None):
    """K3 (`cross`), K4 (`flash_self`) or K5 (`flash_cross`) forward on
    q [b, n, h, d] and k, v [b, m, h, d], held to the einsum path within 2
    bf16 ulps of the top binade, timed beside SDPA."""
    import torch.nn.functional as F

    from stablekeypoints_tpu_torch.kernels import cross_attn, flash

    fn = {"cross": cross_attn.cross_attention_resident, "flash_self": flash.flash_self_attention,
          "flash_cross": flash.flash_cross_attention}[name]
    q, k, v = (_randn(torch, gen, b, r, h, d) for r in (n, m, m))
    s = d ** -0.5
    return dict(
        name=name, row=row or name, shape=f"q[{b},{n},{h},{d}] kv[{b},{m},{h},{d}]", count=count,
        path=path, kernel=lambda: fn(q, k, v, s), plain=lambda: flash.attention_plain(q, k, v, s),
        library=lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=s).transpose(1, 2),
        nbytes=2 * (2 * q.numel() + 2 * k.numel()), flops=4 * b * h * n * m * d,
        peak=PEAK_BF16, tol=2.0**-7, relative=True, exps=b * h * n * m)


def attention_bwd_case(torch, gen, name, b, n, m, h, d, count, row=None):
    """The backward of K3 (`cross_bwd`, no residual), K4 or K5 (with the
    forward's output and lse), held to its plain version within 2^-6 of each
    gradient's largest magnitude; the library time is SDPA's backward."""
    import torch.nn.functional as F

    from stablekeypoints_tpu_torch.kernels import cross_attn, flash

    q, k, v, do = (_randn(torch, gen, b, r, h, d) for r in (n, m, m, n))
    s = d ** -0.5
    with_o = name != "cross_bwd"
    if with_o:
        fwd, bwd = {"flash_self_bwd": (flash.flash_self_attention, flash.flash_self_attention_bwd),
                    "flash_cross_bwd": (flash.flash_cross_attention,
                                        flash.flash_cross_attention_bwd)}[name]
        o, lse = fwd(q, k, v, s, with_lse=True)
        kernel = lambda: bwd(q, k, v, o, do, lse, s)  # noqa: E731
        plain = lambda: flash.attention_bwd_plain(q, k, v, o, do, s)  # noqa: E731
    else:
        kernel = lambda: cross_attn.cross_attention_resident_bwd(q, k, v, do, s)  # noqa: E731
        plain = lambda: cross_attn.cross_attention_bwd_plain(q, k, v, do, s)  # noqa: E731
    qg, kg, vg = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    dog = do.transpose(1, 2)

    def lib_fwd():
        return F.scaled_dot_product_attention(qg, kg, vg, scale=s)

    return dict(
        name=name, row=row or name, shape=f"q[{b},{n},{h},{d}] kv[{b},{m},{h},{d}]", count=count,
        kernel=kernel, plain=plain,
        library_time=_minus_forward(lambda: torch.autograd.grad(lib_fwd(), (qg, kg, vg), dog),
                                    lib_fwd),
        # read q, k, v, do (and o, lse); write dq, dk, dv
        nbytes=2 * ((4 if with_o else 3) * q.numel() + 4 * k.numel())
        + (4 * b * h * n if with_o else 0),
        flops=10 * b * h * n * m * d, peak=PEAK_BF16, tol=2.0**-6, relative=True,
        exps=b * h * n * m)


def capture_case(torch, gen, b, h, x, d, count, backward=False, row=None, t=500):
    """K1 (forward, or with `backward` its backward against a random map
    cotangent) from tt [b, h, 128, x, d] (an x^2 grid's row-resized queries)
    to the 128^2 capture; the library call is matmul + softmax + head-mean on
    the upsampled queries (and its autograd). Forward maps within 1e-4,
    gradients within 2^-6 of their largest magnitude."""
    from stablekeypoints_tpu_torch.kernels import attn_capture
    from stablekeypoints_tpu_torch.ops.resize import resize_matrix

    tt, k = _randn(torch, gen, b, h, 128, x, d), _randn(torch, gen, b, t, h, d)
    ww = resize_matrix(x, 128, "bicubic", torch.bfloat16, "cuda")
    s, n = d ** -0.5, 128 * 128
    q_up = torch.einsum("Px,bkOxd->bkOPd", ww, tt).reshape(b, h, -1, d)
    kh = k.permute(0, 2, 1, 3)
    if not backward:
        return dict(
            name="capture", row=row or "capture", count=count,
            shape=f"tt[{b},{h},128,{x},{d}] k[{b},{t},{h},{d}]",
            kernel=lambda: attn_capture.capture_attention_fused(tt, ww, k, s),
            plain=lambda: attn_capture.capture_fused_plain(tt, ww, k, s),
            library=lambda: _headmean(q_up, kh, s),
            nbytes=2 * (tt.numel() + ww.numel() + k.numel()) + 4 * b * n * t,
            flops=2 * b * h * n * t * d + 2 * b * h * n * x * d, peak=PEAK_BF16, tol=1e-4,
            exps=b * h * n * t, deterministic=True)  # one ex2 a score; heads summed in order
    g = _randn(torch, gen, b, n, t, scale=1e-3, dtype=torch.float32)
    qg, khg = q_up.requires_grad_(), kh.detach().requires_grad_()
    return dict(
        name="capture_bwd", row=row or "capture_bwd", count=count,
        shape=f"tt[{b},{h},128,{x},{d}] g[{b},{n},{t}]",
        kernel=lambda: attn_capture.capture_attention_fused_bwd(tt, ww, k, g, s),
        plain=lambda: attn_capture.capture_fused_bwd_plain(tt, ww, k, g, s),
        library_time=_minus_forward(
            lambda: torch.autograd.grad(_headmean(qg, khg, s), (qg, khg), g),
            lambda: _headmean(qg, khg, s)),
        nbytes=2 * 2 * (tt.numel() + k.numel()) + 2 * ww.numel() + 4 * g.numel(),
        flops=2 * b * h * n * (3 * t * d + 2 * x * d), peak=PEAK_BF16, tol=2.0**-6, relative=True,
        exps=2 * b * h * n * t)  # one ex2 a score in the statistics, one in the backward


def capture_unfused_case(torch, gen, b, h, d, count, backward=False, row=None, t=500):
    """K2 (or its backward) at a 96^2 capture grid: q [b, h, 9216, d] given,
    head-major; as `capture_case` otherwise."""
    from stablekeypoints_tpu_torch.kernels import attn_capture

    n = 96 * 96
    q, k = _randn(torch, gen, b, h, n, d), _randn(torch, gen, b, t, h, d)
    s = d ** -0.5
    kh = k.permute(0, 2, 1, 3)
    if not backward:
        return dict(
            name="capture_unfused", row=row or "capture_unfused",
            shape=f"q[{b},{h},{n},{d}] k[{b},{t},{h},{d}]", count=count,
            kernel=lambda: attn_capture.capture_attention(q, k, s),
            plain=lambda: attn_capture.capture_plain(q, k, s),
            library=lambda: _headmean(q, kh, s),
            nbytes=2 * (q.numel() + k.numel()) + 4 * b * n * t,
            flops=2 * b * h * n * t * d, peak=PEAK_BF16, tol=1e-4, exps=b * h * n * t,
            deterministic=True)
    g = _randn(torch, gen, b, n, t, scale=1e-3, dtype=torch.float32)
    qg, khg = q.detach().requires_grad_(), kh.detach().requires_grad_()
    return dict(
        name="capture_unfused_bwd", row=row or "capture_unfused_bwd",
        shape=f"q[{b},{h},{n},{d}] g[{b},{n},{t}]", count=count,
        kernel=lambda: attn_capture.capture_attention_bwd(q, k, g, s),
        plain=lambda: attn_capture.capture_bwd_plain(q, k, g, s),
        library_time=_minus_forward(
            lambda: torch.autograd.grad(_headmean(qg, khg, s), (qg, khg), g),
            lambda: _headmean(qg, khg, s)),
        nbytes=2 * 2 * (q.numel() + k.numel()) + 4 * g.numel(),
        flops=2 * b * h * n * 3 * t * d, peak=PEAK_BF16, tol=2.0**-6, relative=True,
        exps=2 * b * h * n * t)


def groupnorm_case(torch, gen, b, hw, c, act, count, path=None, row=None):
    """K6, coefficients and apply (+ SiLU), on x [b, hw, hw, c] against its
    plain version (4 bf16 ulps: the apply rounds 4 times in bf16), timed
    beside F.group_norm (+ SiLU)."""
    import torch.nn.functional as F

    from stablekeypoints_tpu_torch.kernels import groupnorm

    bf = torch.bfloat16
    x = (torch.randn((b, hw, hw, c), generator=gen, device="cuda") * 1.5 + 0.3).to(bf)
    w = torch.randn(c, generator=gen, device="cuda") * 0.2 + 1.0
    bb = torch.randn(c, generator=gen, device="cuda") * 0.2

    def lib():
        y = F.group_norm(x.permute(0, 3, 1, 2), 32, w.to(bf), bb.to(bf), 1e-6)
        return F.silu(y) if act else y

    return dict(
        name="groupnorm", row=row or "groupnorm", shape=f"x[{b},{hw},{hw},{c}] {act or 'none'}",
        count=count, path=path,
        kernel=lambda: groupnorm.fused_group_norm(x, w, bb, 32, 1e-6, act),
        plain=lambda: groupnorm.fused_group_norm_plain(x, w, bb, 32, 1e-6, act),
        library=lib, nbytes=2 * 2 * x.numel(), flops=10 * x.numel(), peak=PEAK_FP32,
        tol=2.0**-6, relative=True)


def kernel_cases(torch, gen):
    """(kernel name, shape label, count per pass, run kernel, run plain,
    run library or None, bytes, flops, peak, tolerance) per distinct shape
    of the SD-1.5 512^2 paths: a detect pass (10 views), a training step
    (batch 4, merged 8: `backward_cases`), a guided DDIM step and a decode
    of 2 images (count 0, summed by path)."""
    import torch.nn.functional as F

    from stablekeypoints_tpu_torch.kernels import groupnorm

    B, G = 10, GEN_BATCH
    # K1 capture: up_1 (16^2 -> 128^2, d 160) x3, up_2 (32^2 -> 128^2, d 80) x1
    cases = [capture_case(torch, gen, B, 8, x, d, count)
             for x, d, count in ((16, 160, 3), (32, 80, 1))]
    # K3 resident cross-attention: the two 64^2 cross layers of down_0
    cases.append(attention_case(torch, gen, "cross", B, 4096, 500, 8, 40, 2))
    # K4 flash self-attention: down_0 x2, down_1 x2 + up_2 x1, VAE mid x1
    for n, h, d, count in ((4096, 8, 40, 2), (1024, 8, 80, 3), (4096, 1, 512, 1)):
        cases.append(attention_case(torch, gen, "flash_self", B, n, n, h, d, count))
    # K5 masked flash cross-attention: down_1 x2, up_2 x1
    cases.append(attention_case(torch, gen, "flash_cross", B, 1024, 500, 8, 80, 3))
    # generation (count 0: not in a detect pass): one guided DDIM step of 2
    # images, two full UNet forwards: the cross-attentions x5 with the learned
    # context (500 tokens) and x5 with the unconditional one (77, a ragged
    # last key tile), the self-attentions x10; the decode's d-512 attention
    for m in (500, 77):
        cases.append(attention_case(torch, gen, "cross", G, 4096, m, 8, 40, 0, ("guided step", 5)))
        cases.append(attention_case(torch, gen, "flash_cross", G, 1024, m, 8, 80, 0,
                                    ("guided step", 5)))
    for n, h, d in ((4096, 8, 40), (1024, 8, 80)):
        cases.append(attention_case(torch, gen, "flash_self", G, n, n, h, d, 0, ("guided step", 10)))
    cases.append(attention_case(torch, gen, "flash_self", G, 4096, 4096, 1, 512, 0, ("decode", 1)))
    cases += backward_cases(torch, gen)
    cases += gn_conv_cases(torch, gen)
    cases += gn_conv_cases(torch, gen, DECODE_GN_CONV_SHAPES, G, "decode")
    # K2 unfused capture at a 96^2 grid: up_1 (d 160) x3, up_2 (d 80) x1
    cases += [capture_unfused_case(torch, gen, B, 8, d, count) for d, count in ((160, 3), (80, 1))]
    # K6 GroupNorm(+SiLU) in the VAE encoder at 512^2 (eps 1e-6, 32 groups):
    # the applies of the mid attention norm and conv_norm_out; every other
    # VAE GroupNorm is K7's coefficients (the gn_coeffs cases); and of the
    # decoder's (the mid attention's norm at 64^2, conv_norm_out at 512^2)
    for bb, hw, c, act, count, path in ((B, 64, 512, "silu", 1, None), (B, 64, 512, None, 1, None),
                                        (G, 64, 512, None, 0, ("decode", 1)),
                                        (G, 512, 128, "silu", 0, ("decode", 1))):
        cases.append(groupnorm_case(torch, gen, bb, hw, c, act, count, path))
    # K6 statistics where the naive E[x^2] - E[x]^2 cancels (mean 30, std 0.5;
    # its block-parallel form errs ~2e-4 in the scale a there, the shifted
    # sums ~3e-6) and with per-channel means in [-100, 100). Checks only
    # (count 0): a is held to the two-pass plain version within 2e-5.
    bf, dev = torch.bfloat16, "cuda"
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


def gn_conv_cases(torch, gen, shapes=GN_CONV_SHAPES, B=10, path=None, row_suffix=""):
    """K7 at the 20 resnet convs of one SD-1.5 512^2 VAE encode (10 views),
    or with `path` at the 28 of a decode (`shapes`, batch B, count 0 in a
    detect pass), and the K6 coefficient kernel that feeds it. K7's tolerance: 2^-6 of the
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
    for hw, cin, cout, with_res, n in shapes:
        count, where = (n, None) if path is None else (0, (path, n))
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
        yield dict(
            name="gn_conv", row="gn_conv" + row_suffix, shape=label, count=count, path=where,
            kernel=lambda x=x, m=m, a=a, bc=bc, k=hwio, bias=bias, res=res:
                gn_conv.fused_gn_silu_conv3x3(x, m, a, bc, k, bias, res),
            plain=lambda x=x, m=m, a=a, bc=bc, k=hwio, bias=bias, res=res:
                gn_conv.fused_gn_silu_conv3x3_plain(x, m, a, bc, k, bias, res),
            unfused_time=unfused_minus_coeffs,
            # read x, the weights, the coefficients (and the residual); write out
            nbytes=2 * (x.numel() + weight.numel() + B * hw * hw * cout * (2 if with_res else 1))
            + 4 * 3 * B * cin,
            flops=2 * B * hw * hw * cout * 9 * cin, peak=PEAK_BF16, tol=2.0**-6, relative=True,
        )
        # K6's coefficient kernel (statistics and coefficients, one launch) on the same input
        yield dict(
            name="gn_coeffs", row="gn_coeffs" + row_suffix, shape=f"x[{B},{hw},{hw},{cin}]",
            count=count, path=where,
            kernel=lambda x=x, w=w, b=b: groupnorm.gn_affine_coeffs(x, w, b, 32, 1e-6),
            plain=lambda x=x, w=w, b=b: groupnorm.gn_affine_coeffs_plain(x, w, b, 32, 1e-6),
            library=lambda x=x: torch.var_mean(x.reshape(B, -1, 32, cin // 32).float(), dim=(1, 3)),
            nbytes=2 * x.numel() + 4 * 3 * B * cin, flops=3 * x.numel(), peak=PEAK_FP32,
            # m_q is bf16-valued (1 ulp: 2^-8 relative), a and b_comp fp32
            # from fp32 sums in another order; the partial sums merge in a
            # fixed order, so a second launch is bitwise equal
            tol=2.0**-7, relative=True, deterministic=True,
        )


def backward_cases(torch, gen):
    """The backward kernels at the shapes one SD-1.5 512^2 training step
    gives them (batch 4, merged batch [originals; warped] of 8), bf16, with
    the launches per step that the layer routing predicts."""
    B = 8
    cases = [capture_case(torch, gen, B, 8, x, d, count, backward=True)
             for x, d, count in ((16, 160, 3), (32, 80, 1))]
    # K3 backward: the two 64^2 cross layers of down_0
    cases.append(attention_bwd_case(torch, gen, "cross_bwd", B, 4096, 500, 8, 40, 2))
    # K4 backward: down_0's second block (its first runs before any layer reads
    # the context), down_1 x2 and up_2's first block; no backward in the VAE
    for n, d, count in ((4096, 40, 1), (1024, 80, 3)):
        cases.append(attention_bwd_case(torch, gen, "flash_self_bwd", B, n, n, 8, d, count))
    # K5 backward: down_1 x2 (up_2's cross output reaches no loss: truncation)
    cases.append(attention_bwd_case(torch, gen, "flash_cross_bwd", B, 1024, 500, 8, 80, 2))
    # K2 backward at a 96^2 capture grid: up_1 (d 160) x3, up_2 (d 80) x1
    cases += [capture_unfused_case(torch, gen, B, 8, d, count, backward=True)
              for d, count in ((160, 3), (80, 1))]
    return cases


def backbone_cases(torch, gen):
    """The d-64 instances of K1-K5 and K6/K7 at the larger VAE shapes, at the
    SD-2.1 768^2 and SDXL 1024^2 paths' shapes, each a row of its own
    ("<kernel>@<backbone>"): forward kernels at one detect pass (10 views),
    backward kernels at one training step (SD-2.1 batch 2, merged 4; SDXL
    batch 1, merged 2), K2 at SD-2.1's step at a 96^2 capture grid, and
    (count 0: checks only) K3/K5 at the guidance's 77 tokens. Yielded one at
    a time, so that only one case's inputs live on the card at once."""
    V, D = 10, 64
    # SD-2.1 768^2: a detect pass, a step, K2 at 96^2
    r = "@sd21"
    yield from gn_conv_cases(torch, gen, GN_CONV_SHAPES_AT[768], V, row_suffix=r)
    for act in ("silu", None):
        yield groupnorm_case(torch, gen, V, 96, 512, act, 1, row="groupnorm" + r)
    yield attention_case(torch, gen, "flash_self", V, 9216, 9216, 1, 512, 1, row="flash_self" + r)
    for n, h in ((96 * 96, 5), (48 * 48, 10)):
        yield attention_case(torch, gen, "flash_self", V, n, n, h, D, 5, row="flash_self" + r)
        yield attention_case(torch, gen, "cross", V, n, 500, h, D, 5, row="cross" + r)
        yield attention_case(torch, gen, "cross", 2, n, 77, h, D, 0, row="cross" + r)
    yield capture_case(torch, gen, V, 20, 24, D, 3, row="capture" + r)
    for n, h, k4, k3 in ((96 * 96, 5, 1, 2), (48 * 48, 10, 2, 2)):
        yield attention_bwd_case(torch, gen, "flash_self_bwd", 4, n, n, h, D, k4,
                                 row="flash_self_bwd" + r)
        yield attention_bwd_case(torch, gen, "cross_bwd", 4, n, 500, h, D, k3, row="cross_bwd" + r)
    yield capture_case(torch, gen, 4, 20, 24, D, 3, backward=True, row="capture_bwd" + r)
    yield capture_unfused_case(torch, gen, 4, 20, D, 3, row="capture_unfused" + r)
    yield capture_unfused_case(torch, gen, 4, 20, D, 3, backward=True, row="capture_unfused_bwd" + r)

    # SDXL 1024^2: a detect pass, a step
    r = "@sdxl"
    yield from gn_conv_cases(torch, gen, GN_CONV_SHAPES_AT[1024], V, row_suffix=r)
    for act in ("silu", None):
        yield groupnorm_case(torch, gen, V, 128, 512, act, 1, row="groupnorm" + r)
    for n, h, d, count in ((128 * 128, 1, 512, 1), (64 * 64, 10, D, 10), (32 * 32, 20, D, 60)):
        yield attention_case(torch, gen, "flash_self", V, n, n, h, d, count, row="flash_self" + r)
    yield attention_case(torch, gen, "cross", V, 4096, 500, 10, D, 10, row="cross" + r)
    yield attention_case(torch, gen, "flash_cross", V, 1024, 500, 20, D, 60, row="flash_cross" + r)
    yield attention_case(torch, gen, "cross", 2, 4096, 77, 10, D, 0, row="cross" + r)
    yield attention_case(torch, gen, "flash_cross", 2, 1024, 77, 20, D, 0, row="flash_cross" + r)
    yield capture_case(torch, gen, V, 20, 32, D, 3, row="capture" + r)
    for n, h, count in ((64 * 64, 10, 3), (32 * 32, 20, 51)):
        yield attention_bwd_case(torch, gen, "flash_self_bwd", 2, n, n, h, D, count,
                                 row="flash_self_bwd" + r)
    yield attention_bwd_case(torch, gen, "cross_bwd", 2, 4096, 500, 10, D, 4, row="cross_bwd" + r)
    yield attention_bwd_case(torch, gen, "flash_cross_bwd", 2, 1024, 500, 20, D, 50,
                             row="flash_cross_bwd" + r)
    yield capture_case(torch, gen, 2, 20, 32, D, 3, backward=True, row="capture_bwd" + r)


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


def launches_now(count):
    return {n: fn.launches for n, fn in count.items()}


def check_counts(tag, count, per, units, unit_name):
    """Every kernel's launches since reset_counts() against per[name] x units."""
    launches = launches_now(count)
    for name, n in launches.items():
        want = per[name] * units
        print(f"[{tag}] launches {name:<19} {n} = {n / units:g} per {unit_name} "
              f"(expected {per[name]})")
        assert n == want, f"{tag} {name}: {n} launches, expected {want}"
    return launches


def phase_kernels(torch, out_dir, only=None):
    """Every case of kernel_cases (SD-1.5) and backbone_cases (SD-2.1,
    SDXL): held to its plain version, timed; the per-pass sums by row (a
    kernel on one backbone's path). `only`: kernel or row names."""
    import itertools

    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = {}
    # the same sums over one guided DDIM step and one decode of a generate call
    paths = {}
    failures = []

    def add(total, value):
        return None if value is None else (total or 0.0) + value

    for case in itertools.chain(kernel_cases(torch, gen), backbone_cases(torch, gen)):
        row = case.get("row", case["name"])
        if only and case["name"] not in only and row not in only:
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
            print(f"[kernel] {row:<11} {case['shape']:<36} two launches bitwise equal: "
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
            print(f"[kernel] {row:<11} {case['shape']:<36} scale a: max rel err "
                  f"{a_err:.3e} (tol {case['scale_a_tol']:.0e}) vs the two-pass plain version")
        other = (f"library {lib_ms:.3f} ms" if lib_ms is not None
                 else f"unfused path {unf_ms:.3f} ms" if unf_ms is not None else "no library call")
        print(f"[kernel] {row:<11} {case['shape']:<36} x{case['count']} "
              f"max_abs_err {err:.3e} (tol {tol:.3e}) {'OK' if ok else 'FAIL'} | "
              f"kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  {other}  "
              f"bound {b_ms:.3f} ms ({b_by})"
              + (f"  exp floor {e_ms:.3f} ms" if e_ms is not None else ""), flush=True)
        if not ok:
            failures.append(f"{row} {case['shape']}: err {err} finite {finite} "
                            f"deterministic {same}")
        s = summary.setdefault(row, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=None,
                                         unfused_ms=None, bound_ms=0.0, ops_ms=0.0, bytes_ms=0.0,
                                         shapes=[]))
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
                                exp_floor_ms=e_ms, max_abs_err=err, path=case.get("path")))
        if case.get("path"):
            path, per = case["path"]
            p = paths.setdefault(path, {}).setdefault(case["name"], dict(
                launches=0, ms=0.0, plain_ms=0.0, library_ms=None, unfused_ms=None, ops_ms=0.0,
                bytes_ms=0.0))
            p["launches"] += per
            p["ms"] += per * ms
            p["plain_ms"] += per * plain_ms
            p["library_ms"] = add(p["library_ms"], None if lib_ms is None else per * lib_ms)
            p["unfused_ms"] = add(p["unfused_ms"], None if unf_ms is None else per * unf_ms)
            p["ops_ms"] += per * case["flops"] / case["peak"] * 1e3
            p["bytes_ms"] += per * case["nbytes"] / HBM_BYTES_PER_S * 1e3
        del case
        torch.cuda.empty_cache()
    for path, rows in paths.items():
        for name, p in rows.items():
            p["bound_ms"] = max(p["ops_ms"], p["bytes_ms"])
            other = (f"library {p['library_ms']:.3f}" if p["library_ms"] is not None
                     else f"unfused path {p['unfused_ms']:.3f}" if p["unfused_ms"] is not None
                     else "no library call")
            print(f"[kernel] per {path} ({GEN_BATCH} images): {name:<11} {p['launches']:3d} "
                  f"launches, kernel {p['ms']:.3f} ms, plain {p['plain_ms']:.3f} ms, {other} ms, "
                  f"bound {p['bound_ms']:.3f} ms")
        total = sum(p["ms"] for p in rows.values())
        print(f"[kernel] per {path} ({GEN_BATCH} images): the kernels {total:.3f} ms", flush=True)
    with open(os.path.join(out_dir, "kernels.json"), "w") as f:
        json.dump(dict(summary, paths=paths), f, indent=1)
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

    cfg = rt.cfg
    rt_plain = plain_runtime(rt)
    maps = {}
    for name, r in (("kernels", rt), ("plain", rt_plain)):
        gen = torch.Generator(device=rt.device).manual_seed(3)
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


def check_launches(tag, launches, per, units, unit_name):
    """As check_counts, for a snapshot of the counts, with one line of output."""
    for name, n in launches.items():
        assert n == per[name] * units, f"{tag} {name}: {n} launches, expected {per[name]} x {units}"
    print(f"[cli] {tag}: launches as expected, {units} x per {unit_name} "
          f"({sum(launches.values())} in all)", flush=True)


def phase_cli(torch, rt, card, out_dir):
    """The five-stage CLI in process, on a synthetic CelebA layout written by
    examples/make_synthetic_celeba.py (12 train/regression + 4 test images
    of 512^2), then --resume, a mid-stage resume and learn_keypoints on the
    image folder. Each stage runs with the counts set to 0 just before it
    and read just after; stage 3 and 5 also per chunk."""
    import shutil
    import tempfile

    import numpy as np

    from stablekeypoints_tpu_torch import main as cli
    from stablekeypoints_tpu_torch.api import learn_keypoints
    from stablekeypoints_tpu_torch.data.base import load_image_rgb
    from stablekeypoints_tpu_torch.data.registry import build_dataset
    from stablekeypoints_tpu_torch.pipeline.runtime import Runtime
    from stablekeypoints_tpu_torch.utils.checkpoint import TrainCheckpointer
    from stablekeypoints_tpu_torch.utils.logging import MetricsLogger

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="cli_", dir=os.path.join(REPO, "build"))
    log_dir = os.path.join(out_dir, "cli")
    os.makedirs(log_dir, exist_ok=True)
    data, out = os.path.join(root, "celeba"), os.path.join(root, "out")
    t0 = time.time()
    subprocess.run([sys.executable, os.path.join(REPO, "examples", "make_synthetic_celeba.py"),
                    "--root", data, "--n", "16", "--image_size", "512"],
                   check=True, timeout=300, capture_output=True)
    print(f"[cli] synthetic CelebA layout, 16 images of 512^2: {time.time() - t0:.2f} s",
          flush=True)

    count = counters()
    stages, chunks = {}, {"precompute_all_keypoints": [], "evaluate": []}
    current = []  # the stage running now (3 or 5 record their chunks)

    def staged(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            reset_counts()
            current.append(name)
            start = time.time()
            try:
                result = fn(*a, **k)
                torch.cuda.synchronize()
            finally:
                current.pop()
            stages[name] = dict(seconds=time.time() - start, launches=launches_now(count))
            return result
        return run

    augmented = Runtime.augmented_keypoints

    def per_chunk(self, context, images, indices, **random):
        before = launches_now(count)
        start = time.time()
        pts = augmented(self, context, images, indices, **random)
        if current and current[-1] in chunks:
            views = len(images) * self.cfg.augmentation_iterations
            chunks[current[-1]].append(dict(
                images=len(images), passes=views // self.views_per_pass(views),
                dispatch_s=time.time() - start,  # host time to queue the chunk (no wait)
                launches={n: v - before[n] for n, v in launches_now(count).items()}))
        return pts

    step_secs = []  # stage 1: (kind, s) per step, host clock around a synchronised step
    step_methods = {kind: getattr(Runtime, f"train_step_{kind}") for kind in ("fill", "cached")}

    def timed_step(kind):
        def step(*a, **k):
            torch.cuda.synchronize()
            start = time.time()
            out = step_methods[kind](*a, **k)
            torch.cuda.synchronize()
            step_secs.append((kind, time.time() - start))
            return out
        return step

    hooked = {name: getattr(cli, name) for name in
              ("optimize_embedding", "find_best_indices", "precompute_all_keypoints", "evaluate")}
    argv = ["--dataset_name", "celeba_aligned", "--dataset_loc", data, "--save_folder", out,
            "--num_steps", "4", "--checkpoint_every", "2", "--num_indices", "8",
            "--max_num_points", "12", "--eval_batch_images", "4"]
    torch.cuda.reset_peak_memory_stats()
    try:
        for name, fn in hooked.items():
            setattr(cli, name, staged(name, fn))
        Runtime.augmented_keypoints = per_chunk
        for kind in step_methods:
            setattr(Runtime, f"train_step_{kind}", timed_step(kind))
        t0 = time.time()
        first = cli.main(argv)
        first_s = time.time() - t0
        for kind, fn in step_methods.items():
            setattr(Runtime, f"train_step_{kind}", fn)
        first_stages, first_chunks = dict(stages), {k: list(v) for k, v in chunks.items()}
        regressor = np.load(os.path.join(out, "regressor.npy"))
        artifacts = sorted(f for f in os.listdir(out) if f.endswith((".npy", ".pt")))
        checkpoints = sorted(os.listdir(os.path.join(out, "checkpoints")))
        stages.clear()
        for v in chunks.values():
            v.clear()
        t0 = time.time()
        again = cli.main(argv + ["--resume"])
        again_s = time.time() - t0
    finally:
        for name, fn in hooked.items():
            setattr(cli, name, fn)
        Runtime.augmented_keypoints = augmented
        for kind, fn in step_methods.items():
            setattr(Runtime, f"train_step_{kind}", fn)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    shutil.copy(os.path.join(out, "metrics.jsonl"), log_dir)

    # the first run: five stages, the artifact set, launch counts
    names = ("embedding", "indices", "source_keypoints", "target_keypoints", "visible",
             "regressor", "all_errors")
    assert artifacts == sorted(f"{n}.{e}" for n in names for e in ("npy", "pt")), artifacts
    assert checkpoints == ["step_00000002"], checkpoints
    assert set(first_stages) == set(hooked), first_stages
    assert np.isfinite(first["mean_distance"]), first["mean_distance"]
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    check_launches("stage 1 (4 steps)", first_stages["optimize_embedding"]["launches"],
                   PER_STEP, cfg.num_steps, "training step")
    check_launches("stage 2 (2 vote batches)", first_stages["find_best_indices"]["launches"],
                   PER_PASS, -(-cfg.num_indices // cfg.batch_size), "pass")
    for stage, label, n_images in (("precompute_all_keypoints", "stage 3", 12),
                                   ("evaluate", "stage 5", 4)):
        rows = first_chunks[stage]
        assert sum(r["images"] for r in rows) == n_images, rows
        for i, r in enumerate(rows):
            check_launches(f"{label} chunk {i} ({r['images']} images, {r['passes']} passes)",
                           r["launches"], PER_PASS, r["passes"], "pass")
        check_launches(label, first_stages[stage]["launches"], PER_PASS,
                       sum(r["passes"] for r in rows), "pass")
    s_step = first_stages["optimize_embedding"]["seconds"] / cfg.num_steps
    s3 = first_stages["precompute_all_keypoints"]["seconds"] / 12
    s5 = first_stages["evaluate"]["seconds"] / 4
    print(f"[cli] SD-1.5 512^2 CLI run: {first_s:.2f} s; stage 1 {s_step:.4f} s/step (batch 4, "
          f"4 steps: 3 fill + 1 cached); stage 2 "
          f"{first_stages['find_best_indices']['seconds'] / cfg.num_indices:.4f} s/image; "
          f"stage 3 {s3:.4f} s/image (12 images, chunks of 4); stage 5 {s5:.4f} s/image "
          f"(4 images) | {card}")
    print(f"[cli] peak device memory {peak_gib:.2f} GiB; mean_distance {first['mean_distance']:.6f} "
          f"| {card}", flush=True)
    print(f"[cli] stage 1 steps (synchronised): {[(k, round(v, 4)) for k, v in step_secs]}; "
          f"stage 3/5 host time to queue each chunk: "
          f"{[round(r['dispatch_s'], 4) for st in first_chunks.values() for r in st]} s", flush=True)

    # --resume: stages 1-3 reused, the regressor refitted bitwise, stage 5 again
    with open(os.path.join(out, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    second = max(i for i, r in enumerate(records) if r.get("event") == "config")
    reused = {r["artifact"] for r in records[second:] if r.get("event") == "stage_artifact_reused"}
    assert reused == {"embedding", "indices", "keypoints"}, reused
    assert set(stages) == {"evaluate"}, stages
    assert np.array_equal(again["regressor"], regressor), "the refitted regressor differs"
    diff = abs(again["mean_distance"] - first["mean_distance"])
    print(f"[cli] --resume: {again_s:.2f} s, reused {sorted(reused)}, regressor bitwise equal, "
          f"mean_distance {again['mean_distance']:.6f} (first run {first['mean_distance']:.6f}, "
          f"difference {diff:.3e}, tol 1e-3 relative)", flush=True)
    assert diff <= 1e-3 * max(1.0, abs(first["mean_distance"])), diff

    # mid-stage: 6 steps from the first run's step-2 checkpoint
    mid = os.path.join(root, "mid")
    os.makedirs(os.path.join(mid, "checkpoints"))
    shutil.copy(os.path.join(out, "checkpoints", "step_00000002"), os.path.join(mid, "checkpoints"))
    mid_cfg = cli.config_from_args(cli.build_parser().parse_args(
        argv + ["--num_steps", "6", "--save_folder", mid, "--log_every", "1"]))
    mid_rt = Runtime(mid_cfg, rt.unet, rt.vae, rt.schedule, rt.device)
    logger = MetricsLogger(mid)
    count = reset_counts()
    t0 = time.time()
    hooked["optimize_embedding"](mid_rt, build_dataset(mid_cfg, "train"), logger,
                                 checkpointer=TrainCheckpointer(mid))
    torch.cuda.synchronize()
    mid_s = time.time() - t0
    logger.close()
    check_launches("mid-stage resume (steps 3-5)", launches_now(count), PER_STEP, 3,
                   "training step")
    with open(os.path.join(mid, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    shutil.copy(os.path.join(mid, "metrics.jsonl"), os.path.join(log_dir, "mid_metrics.jsonl"))
    assert records[0]["event"] == "resumed" and records[0]["step"] == 3, records[0]
    steps = [r["step"] for r in records if "loss" in r]
    assert steps == [3, 4, 5] and all(np.isfinite(r["loss"]) for r in records if "loss" in r)
    adam_steps = float(TrainCheckpointer(mid).restore(4)["optimizer"]["state"][0]["step"])
    assert adam_steps == 5, adam_steps  # 3 from the checkpoint + steps 3 and 4
    print(f"[cli] mid-stage resume: 'resumed' at step 3, steps {steps}, the step-4 checkpoint's "
          f"Adam count {adam_steps:g}: {mid_s:.2f} s | {card}", flush=True)

    # learn_keypoints on the image folder (custom adapter), then one detect
    folder = os.path.join(data, "Img", "img_align_celeba_png")
    lk_rt = Runtime(dataclasses.replace(rt.cfg, num_steps=2, num_indices=4), rt.unet, rt.vae,
                    rt.schedule, rt.device)
    t0 = time.time()
    model = learn_keypoints(folder, runtime=lk_rt)
    pts = model.detect(load_image_rgb(os.path.join(folder, "000001.png"), rt.cfg.image_size))
    torch.cuda.synchronize()
    lk_s = time.time() - t0
    assert pts.shape == (rt.cfg.top_k, 2) and np.isfinite(pts).all()
    assert (pts >= 0).all() and (pts <= 1).all(), pts
    assert len(set(model.indices.tolist())) == rt.cfg.top_k
    print(f"[cli] learn_keypoints on the 16-image folder (2 steps, 4 voted images) -> indices "
          f"{model.indices.tolist()} -> detect {np.round(pts[:3], 4).tolist()}...: {lk_s:.2f} s "
          f"| {card}", flush=True)

    # stage 3 once more on the warm runtime of the earlier phases, with the
    # CLI run's context and indices: s/image, then a profile of the same call
    stage3_rt = Runtime(cfg, rt.unet, rt.vae, rt.schedule, rt.device)
    reg_ds = build_dataset(cfg, "train_reg")

    def stage3():
        hooked["precompute_all_keypoints"](stage3_rt, reg_ds, first["embedding"], first["indices"])
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    t0 = time.time()
    stage3()
    warm_s3 = (time.time() - t0) / 12
    print(f"[cli] stage 3 again, warm runtime: {warm_s3:.4f} s/image | {card}", flush=True)
    profile = profile_call(torch, stage3, "stage 3, 12 images in chunks of 4", out_dir,
                           "profile_stage3.txt", card, warm_s3 * 12e3)
    shutil.rmtree(root, ignore_errors=True)

    total = {n: sum(st["launches"][n] for st in first_stages.values()) for n in count}
    return dict(launches=total, stages=first_stages, chunks=first_chunks, s_per_step_stage1=s_step,
                s_per_image_stage3=s3, s_per_image_stage5=s5, seconds=first_s,
                resume_seconds=again_s, mean_distance=first["mean_distance"],
                mean_distance_resume=again["mean_distance"], peak_gib=peak_gib,
                mid_resume_seconds=mid_s, learn_keypoints_seconds=lk_s, step_secs=step_secs,
                s_per_image_stage3_warm=warm_s3, profile_stage3=profile)


def plain_runtime(rt, **overrides):
    """A runtime of the same weights (the seed's, or cfg.model_path's) with
    every kernel switched off: the plain PyTorch layers."""
    from stablekeypoints_tpu_torch.pipeline.runtime import Runtime

    return Runtime.create(dataclasses.replace(rt.cfg, pallas_capture="off", flash_attention="off",
                                              fused_groupnorm="off", fused_gn_conv="off",
                                              **overrides))


def held_to_plain(torch, tag, got, want, card, tol=5e-2, cos_min=0.99, bound=None):
    """max |got - want| within tol of max |want| (or within `bound`), and
    their cosine >= cos_min (None: reported only)."""
    err = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    cos = torch.nn.functional.cosine_similarity(got.float().flatten(), want.float().flatten(),
                                                dim=0).item()
    limit = tol * top if bound is None else bound
    print(f"[{tag}] max abs err {err:.4e} of max {top:.4e} "
          f"({err / top:.3e}; tol {limit:.4e}), cosine {cos:.5f}"
          + (f" (tol >= {cos_min})" if cos_min is not None else "") + f" | {card}", flush=True)
    assert err <= limit and (cos_min is None or cos >= cos_min), (tag, err, limit, cos)
    return dict(max_abs_err=err, max_ref=top, tol=limit, cosine=cos)


def phase_weights(torch, card, out_dir, root):
    """A full-width SD-1.5 diffusers directory written under `root` by the
    port's own fabricate_checkpoint (the UNet fp16 safetensors, the VAE fp32
    .bin under diffusers-0.8 attention names; random weights, stddev 0.02),
    loaded by Runtime.create(Config(model_path=root)) on the card: every
    parameter the file's tensor cast to its dtype, bitwise; one M=1 detect's
    maps held to the plain layers'. Returns the loaded runtime."""
    import resource

    import numpy as np

    from stablekeypoints_tpu_torch.config import Config
    from stablekeypoints_tpu_torch.models import weights as W
    from stablekeypoints_tpu_torch.models.unet import SD15_CONFIG
    from stablekeypoints_tpu_torch.models.vae import SD_VAE_CONFIG
    from stablekeypoints_tpu_torch.pipeline.runtime import Runtime

    t0 = time.time()
    W.fabricate_checkpoint(root, SD15_CONFIG, SD_VAE_CONFIG, seed=11, dtype=torch.float16,
                           vae_fmt="bin", vae_dtype=torch.float32, legacy_vae_names=True,
                           stddev=0.02)
    fab_s = time.time() - t0
    files = {part: sorted(os.listdir(os.path.join(root, part))) for part in ("unet", "vae")}
    nbytes = {part: sum(os.path.getsize(os.path.join(root, part, f)) for f in fs)
              for part, fs in files.items()}
    print(f"[weights] fabricated SD-1.5 diffusers directory: unet/{files['unet']} "
          f"{nbytes['unet'] / 2**30:.3f} GiB fp16, vae/{files['vae']} {nbytes['vae'] / 2**20:.1f} "
          f"MiB fp32 (diffusers-0.8 attention names): {fab_s:.1f} s", flush=True)

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    rt = Runtime.create(Config(model_path=root))
    torch.cuda.synchronize()
    load_s = time.time() - t0
    peak_gib = (torch.cuda.max_memory_allocated() - held) / 2**30
    host_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"[weights] Runtime.create(model_path=...) on cuda: {load_s:.2f} s; device memory "
          f"above what was held before: peak {peak_gib:.2f} GiB, now "
          f"{(torch.cuda.memory_allocated() - held) / 2**30:.2f} GiB; host peak RSS of the "
          f"process so far {host_gib:.2f} GiB | {card}", flush=True)

    t0 = time.time()
    checked, kinds = 0, {}
    for module, state in ((rt.unet, W.load_unet_state(root, rt.unet.config)),
                          (rt.vae, W.load_vae_state(root, rt.vae.config))):
        for name, p in module.state_dict().items():
            src = state[name]
            assert p.device.type == rt.device.type and torch.equal(p, src.to(p.dtype).to(p.device)), name
            key = f"{src.dtype} -> {p.dtype}".replace("torch.", "")
            kinds[key] = kinds.get(key, 0) + 1
            checked += 1
    print(f"[weights] {checked} parameters bitwise equal to the file's tensor cast to their "
          f"dtype ({kinds}): {time.time() - t0:.1f} s", flush=True)

    ctx = torch.randn((1, rt.cfg.num_tokens, rt.unet.config.context_dim), generator=torch.Generator().manual_seed(1))
    image = np.random.default_rng(2).uniform(0, 1, (rt.cfg.image_size, rt.cfg.image_size, 3))
    count = reset_counts()
    rel, agree = maps_vs_plain(torch, rt, ctx, image.astype(np.float32), "weights", card)
    launches = check_counts("weights", count, PER_PASS, 1, "pass")
    return rt, dict(launches=launches, fabricate_s=fab_s, load_s=load_s, file_bytes=nbytes,
                    device_peak_gib=peak_gib, host_peak_gib=host_gib, parameters=checked,
                    casts=kinds, maps_rel_err=rel, argmax_agree=agree)


def phase_generate(torch, rt, card, out_dir):
    """generate_images on the runtime (2 images, the 50-step schedule):
    guidance 1.0, then 7.5 with the final-step capture; launches per call
    against PER_UNET_FORWARD x forwards + PER_DECODE (+ the capture);
    one UNet forward and one decode counted and profiled on their own; one
    guided step's eps held to the plain layers, and one decode of a fixed
    latent held to the fp32 plain layers beside the bf16 plain layers."""
    import numpy as np

    from stablekeypoints_tpu_torch.models.scheduler import DDIMSchedule
    from stablekeypoints_tpu_torch.pipeline.generate import generate_images
    from stablekeypoints_tpu_torch.pipeline.runtime import Runtime

    cfg, n_img, scale = rt.cfg, GEN_BATCH, 7.5
    steps = len(rt.schedule.timesteps)
    ctx = torch.randn((1, cfg.num_tokens, rt.unet.config.context_dim), generator=torch.Generator().manual_seed(12))
    short = Runtime(cfg, rt.unet, rt.vae, DDIMSchedule.create(2), rt.device)
    t0 = time.time()  # warm-up: first calls at these shapes
    generate_images(short, ctx, n_img, generator=torch.Generator(device=rt.device).manual_seed(13),
                    guidance_scale=scale, capture_final_maps=True)
    print(f"[generate] warm-up (2 steps, guidance {scale}, capture): {time.time() - t0:.2f} s",
          flush=True)

    runs, total = {}, dict(ZERO)
    for guidance, capture in ((1.0, False), (scale, True)):
        count = reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        images, maps = generate_images(rt, ctx, n_img,
                                       generator=torch.Generator(device=rt.device).manual_seed(14),
                                       guidance_scale=guidance, capture_final_maps=capture)
        secs = time.time() - t0  # the images are on the host: the device is done
        forwards = steps * (1 if guidance == 1.0 else 2)
        want = added(scaled(PER_UNET_FORWARD, forwards), PER_DECODE,
                     PER_CAPTURE_FORWARD if capture else ZERO)
        launches = check_counts(f"generate guidance {guidance}", count, want, 1, "generate call")
        total = added(total, launches)
        assert images.shape == (n_img, cfg.image_size, cfg.image_size, 3), images.shape
        assert np.isfinite(images).all() and images.min() >= 0 and images.max() <= 1
        if capture:
            assert maps.shape == (n_img, cfg.num_tokens, cfg.feature_upsample_res,
                                  cfg.feature_upsample_res), maps.shape
            assert np.isfinite(maps).all()
        print(f"[generate] guidance {guidance}{', capture' if capture else ''}: {steps} DDIM "
              f"steps, {forwards} UNet forwards of {n_img} images + decode: {secs:.3f} s = "
              f"{secs / n_img:.4f} s/image; images mean {images.mean():.4f} std "
              f"{images.std():.4f} in [{images.min():.3f}, {images.max():.3f}] | {card}",
              flush=True)
        runs[str(guidance)] = dict(seconds=secs, s_per_image=secs / n_img, forwards=forwards,
                                   launches=launches, capture=capture)

    gen = torch.Generator(device=rt.device).manual_seed(15)
    lat = torch.randn((n_img, cfg.image_size // 8, cfg.image_size // 8, 4), generator=gen,
                      device=rt.device)
    ts = torch.full((n_img,), int(rt.schedule.timesteps[0]), dtype=torch.int32, device=rt.device)
    cond = ctx.to(rt.device).expand(n_img, -1, -1)
    uncond = torch.zeros((n_img, 77, rt.unet.config.context_dim), device=rt.device)

    def forward(r, c):
        return r.unet(lat, ts, c)[0]

    def guided_step():
        eps_c, eps_u = forward(rt, cond), forward(rt, uncond)
        return rt.schedule.ddim_step(eps_u + scale * (eps_c - eps_u), lat, 0)

    with torch.inference_mode():
        count = reset_counts()
        forward(rt, cond)
        torch.cuda.synchronize()
        per_forward = check_counts("generate", count, PER_UNET_FORWARD, 1, "UNet forward")
        count = reset_counts()
        rt.vae.decode(lat)
        torch.cuda.synchronize()
        per_decode = check_counts("generate", count, PER_DECODE, 1, "decode")
        walls = {}
        for name, fn in (("step", guided_step), ("decode", lambda: rt.vae.decode(lat))):
            fn()
            torch.cuda.synchronize()
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            walls[name] = (time.time() - t0) * 1e3
            print(f"[generate] one {'guided DDIM step (2 UNet forwards)' if name == 'step' else 'decode'}"
                  f" of {n_img} images: {walls[name]:.2f} ms | {card}", flush=True)

    def inference(fn):
        def run():
            with torch.inference_mode():
                fn()
        return run

    profiles = {
        "step": profile_call(torch, inference(guided_step), "one guided DDIM step (2 UNet "
                             f"forwards, {n_img} images)", out_dir, "profile_generate_step.txt",
                             card, walls["step"]),
        "decode": profile_call(torch, inference(lambda: rt.vae.decode(lat)),
                               f"one VAE decode ({n_img} images)", out_dir, "profile_decode.txt",
                               card, walls["decode"]),
    }

    plain = plain_runtime(rt)
    with torch.inference_mode():
        got_c, got_u = forward(rt, cond), forward(rt, uncond)
        want_c, want_u = forward(plain, cond), forward(plain, uncond)
        vs = "kernels vs plain layers"
        checks = {"eps_cond": held_to_plain(torch, f"generate eps, learned context: {vs}",
                                            got_c, want_c, card),
                  "eps_uncond": held_to_plain(torch, f"generate eps, zeros [77] context: {vs}",
                                              got_u, want_u, card)}
        # the guided eps: by the triangle inequality, within the two forwards'
        # tolerances weighted by |s| and |s - 1|
        bound = 5e-2 * (scale * want_c.abs().max().item()
                        + (scale - 1) * want_u.abs().max().item())
        checks["eps_guided"] = held_to_plain(
            torch, f"generate guided eps (scale {scale}): {vs}", got_u + scale * (got_c - got_u),
            want_u + scale * (want_c - want_u), card, cos_min=None, bound=bound)
        # the decode's pixels go through no softmax or normalization that
        # would shrink bf16's error, which is ~6e-2 of max for the plain
        # layers themselves (tools/decode_error.py): both bf16 paths are held
        # to the fp32 plain layers, the kernels within twice the plain
        # layers' own error (they round as the JAX kernels do: up to three
        # more bf16 roundings a normalization)
        got, want = rt.vae.decode(lat), plain.vae.decode(lat)
        del plain
        ref = plain_runtime(rt, dtype="float32")
        exact = ref.vae.decode(lat)
        del ref
        plain_err = held_to_plain(torch, "generate VAE.decode: plain bf16 vs fp32 plain", want,
                                  exact, card, tol=1.0)
        checks["decode"] = held_to_plain(
            torch, "generate VAE.decode: kernels bf16 vs fp32 plain", got, exact, card,
            bound=2 * plain_err["max_abs_err"])
        checks["decode"]["vs_plain_bf16"] = held_to_plain(
            torch, "generate VAE.decode: kernels vs plain bf16 (reported)", got, want, card,
            tol=1.0, cos_min=None)
    torch.cuda.empty_cache()
    return dict(launches=total, runs=runs, per_unet_forward=per_forward, per_decode=per_decode,
                wall_ms=walls, profiles=profiles, checks=checks)


def phase_visualize(torch, rt, card, out_dir):
    """visualize_attn_maps (4 images, with a regressor) and create_vid (4
    frames) on a synthetic CelebA layout of 512^2 images; where matplotlib
    does not import, the same calls with their plots replaced by no-ops (the
    phase says so). Then latent_warp: an M=1 detect held to the plain layers
    (one encode of the one image), a fill and a cached training step, and
    the fixed-loss context gradient against the plain layers."""
    import shutil
    import tempfile

    import numpy as np

    from stablekeypoints_tpu_torch.data.registry import build_dataset
    from stablekeypoints_tpu_torch.data.synthetic import SyntheticBlobs
    from stablekeypoints_tpu_torch.pipeline import visualize
    from stablekeypoints_tpu_torch.pipeline.runtime import Runtime

    try:
        import matplotlib

        plots = f"matplotlib {matplotlib.__version__} imports: plots written"
    except ImportError:
        plots = None
    print(f"[visualize] {plots or 'matplotlib does not import here: the plots are skipped (no-ops)'}",
          flush=True)
    root = tempfile.mkdtemp(prefix="vis_", dir=os.path.join(REPO, "build"))
    data, out = os.path.join(root, "celeba"), os.path.join(root, "out")
    subprocess.run([sys.executable, os.path.join(REPO, "examples", "make_synthetic_celeba.py"),
                    "--root", data, "--n", "8", "--image_size", str(rt.cfg.image_size)],
                   check=True, timeout=300, capture_output=True)
    cfg = dataclasses.replace(rt.cfg, dataset_name="celeba_aligned", dataset_loc=data,
                              save_folder=out)
    vrt = Runtime(cfg, rt.unet, rt.vae, rt.schedule, rt.device)
    ds = build_dataset(cfg, "train")
    frames = [ds[i] for i in range(4)]
    ctx = torch.randn((1, cfg.num_tokens, rt.unet.config.context_dim), generator=torch.Generator().manual_seed(16))
    indices = np.arange(cfg.top_k)
    n_kpts = np.asarray(frames[0]["kpts"]).shape[0]
    regressor = np.random.default_rng(17).standard_normal((2 * cfg.top_k, 2 * n_kpts)) * 0.1
    saved = {}
    if plots is None:
        for name in ("pyplot", "save_grid", "plot_point_correspondences"):
            saved[name] = getattr(visualize, name)
            setattr(visualize, name, lambda *a, **k: None)
    total = dict(ZERO)
    try:
        count = reset_counts()
        t0 = time.time()
        visualize.visualize_attn_maps(vrt, ds, ctx, indices, regressor=regressor, num_images=4)
        vis_s = time.time() - t0
        total = added(total, check_counts("visualize_attn_maps", count, PER_PASS, 4, "pass"))
        count = reset_counts()
        t0 = time.time()
        tracks = visualize.create_vid(vrt, frames, ctx, indices)
        vid_s = time.time() - t0
        total = added(total, check_counts("create_vid", count, PER_PASS, 4, "pass"))
    finally:
        for name, fn in saved.items():
            setattr(visualize, name, fn)
    found = sorted(os.path.relpath(os.path.join(d, f), out) for d, _, fs in os.walk(out)
                   for f in fs)
    want = {f"{n}.{e}" for n in ("keypoints", "saved_maps") for e in ("npy", "pt")}
    if plots:
        want |= {"unsupervised_keypoints.pdf", "estimated_keypoints.pdf", "gt_keypoints.pdf"}
        want |= {f"keypoint_{j:03d}.png" for j in range(cfg.top_k)}
        want |= {os.path.join("frames", f"frame_{i:05d}.png") for i in range(4)}
    assert set(found) == want, (sorted(want - set(found)), sorted(set(found) - want))
    keypoints = np.load(os.path.join(out, "keypoints.npy"))
    maps = np.load(os.path.join(out, "saved_maps.npy"))
    assert keypoints.shape == (4, cfg.top_k, 2) and np.isfinite(keypoints).all()
    assert maps.shape == (4, cfg.top_k, cfg.image_size, cfg.image_size)
    assert np.isfinite(maps.astype(np.float32)).all() and np.array_equal(keypoints, tracks)
    print(f"[visualize] visualize_attn_maps (4 images, regressor) {vis_s:.2f} s, create_vid (4 "
          f"frames) {vid_s:.2f} s; {len(found)} files: {found} | {card}", flush=True)
    shutil.rmtree(root, ignore_errors=True)

    # latent_warp: the view latents are the one image's latent warped
    wrt = Runtime(dataclasses.replace(rt.cfg, latent_warp=True), rt.unet, rt.vae, rt.schedule,
                  rt.device)
    black = wrt.black_latent
    print(f"[visualize] latent_warp: black-image latent {[round(v, 4) for v in black.tolist()]}",
          flush=True)
    encodes = []
    wrt._encode = lambda x, real=wrt._encode: encodes.append(x.shape[0]) or real(x)
    image = np.random.default_rng(2).uniform(0, 1, (cfg.image_size, cfg.image_size, 3))
    count = reset_counts()
    rel, agree = maps_vs_plain(torch, wrt, ctx, image.astype(np.float32), "latent_warp", card)
    total = added(total, check_counts("latent_warp detect", count, PER_PASS, 1, "pass"))
    assert encodes == [1], encodes  # one encode of one image, not of its 10 views
    data = SyntheticBlobs(length=8, image_size=cfg.image_size)
    images = np.stack([data[i]["img"] for i in range(cfg.batch_size)])
    gen = torch.Generator(device=rt.device).manual_seed(18)
    context = wrt.train_context(wrt.init_context())
    opt = wrt.optimizer(context)
    wrt.train_step_fill(context, opt, images, generator=gen)  # warm-up
    steps = {}
    for kind, per in (("fill", PER_STEP), ("cached", PER_STEP_WARP_CACHED)):
        encodes.clear()
        count = reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        if kind == "fill":
            _, _, aux, lat = wrt.train_step_fill(context, opt, images, generator=gen)
        else:
            _, _, aux = wrt.train_step_cached(context, opt, lat, images, generator=gen)
        torch.cuda.synchronize()
        secs = time.time() - t0
        total = added(total, check_counts(f"latent_warp {kind} step", count, per, 1, "step"))
        loss = float(aux["loss"])
        assert np.isfinite(loss), aux
        assert encodes == ([cfg.batch_size] if kind == "fill" else []), encodes
        steps[kind] = dict(seconds=secs, loss=loss)
        print(f"[visualize] latent_warp {kind} step (batch {cfg.batch_size}, encodes {encodes}): "
              f"{secs:.4f} s, loss {loss:.6f} | {card}", flush=True)
    del wrt._encode
    grad = gradient_check(torch, wrt, data, card, "latent_warp")
    return dict(launches=total, plots=plots, visualize_s=vis_s, create_vid_s=vid_s, files=found,
                latent_warp=dict(maps_rel_err=rel, argmax_agree=agree, steps=steps,
                                 grad_check=grad, black_latent=black.tolist()))


def gradient_check(torch, rt, data, card, tag="train", batch=2, offload_plain=False):
    """The context gradient of a fixed loss through the kernels against the
    same through the plain layers (every kernel off), both on the card, bf16.
    `offload_plain` keeps the plain path's saved activations in host memory
    (SDXL's plain attention saves ~60 GB at 1024^2; where they are kept does
    not change what is computed).
    Token indices and Gaussian targets are chosen once from the plain path's
    maps (in bf16 the two paths could select differently), so both paths
    differentiate one function: sharpening (MSE to fixed targets) +
    equivariance on those tokens, weighted as the training loss. With
    cfg.latent_warp the warped views' latents are the originals' warped."""
    import numpy as np

    from stablekeypoints_tpu_torch.ops.gaussians import gaussian_circles
    from stablekeypoints_tpu_torch.ops.keypoints import find_k_max_pixels
    from stablekeypoints_tpu_torch.ops.losses import equivariance_loss
    from stablekeypoints_tpu_torch.ops.selection import furthest_point_sampling, select_candidates
    from stablekeypoints_tpu_torch.ops.transforms import apply_affine, sample_thetas

    cfg = rt.cfg
    rt_plain = plain_runtime(rt)
    gen = torch.Generator(device=rt.device).manual_seed(6)
    images = torch.from_numpy(np.stack([data[i]["img"] for i in range(batch)])).to(rt.device)
    thetas = sample_thetas(gen, batch, rt.aff)
    both = torch.cat([images, apply_affine(images, thetas)])
    noise = torch.randn(rt.latent_shape(2 * batch, cfg.image_size), generator=gen, device=rt.device)
    ctx0 = rt.init_context()

    def maps_of(r, context):
        if r.cfg.latent_warp:
            lat = r._encode(images)
            latents = torch.cat([lat, r._warp_latents(lat, thetas)])
        else:
            latents = r._encode(both)
        return r._attn_maps(both, context, noise, -1, None, True, latents=latents)

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

    with (torch.autograd.graph.save_on_cpu() if offload_plain else contextlib.nullcontext()):
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


def phase_backbone(torch, fam, card, out_dir):
    """SD-2.1 at 768^2 (batch 2) or SDXL at 1024^2 (batch 1) from the seed,
    full width, bf16, every kernel auto, through the user's entry points:
    Runtime.create(Config(model_type=...)); an M=1 detect (10 views, one
    pass) with its launches, s/image, peak memory and a profile; its maps
    held to the plain layers on passes of 2 views (the plain 96^2
    self-attention of 10 views, a [10, 5, 9216, 9216] fp32 tensor, does not
    fit beside its copies); a fill and a cached step (launches per step,
    s/step, a profile of the cached one) and the fixed-loss context gradient
    against the plain layers on 2 views; a vote over 4 images. SD-2.1: one
    fill step at a 96^2 capture grid (K2 at d 64). SDXL: generate_images
    (1 image, 4 DDIM steps, guidance 7.5, the final-step capture) and the
    `--model_type` CLI through stage 2 on 4 synthetic images."""
    import numpy as np

    from stablekeypoints_tpu_torch.api import KeypointModel
    from stablekeypoints_tpu_torch.config import Config
    from stablekeypoints_tpu_torch.data.synthetic import SyntheticBlobs
    from stablekeypoints_tpu_torch.pipeline.indices import find_best_indices
    from stablekeypoints_tpu_torch.pipeline.runtime import Runtime

    bb = BACKBONES[fam]
    tag, label = fam, bb["label"]
    t0 = time.time()
    cfg = Config(model_type=bb["model_type"], image_size=bb["image_size"],
                 batch_size=bb["batch_size"])
    rt = Runtime.create(cfg)
    torch.cuda.synchronize()
    cfg, ucfg = rt.cfg, rt.unet.config
    print(f"[{tag}] {label} runtime from seed {cfg.seed}: {time.time() - t0:.1f} s "
          f"({sum(p.numel() for p in rt.unet.parameters()) / 1e6:.0f}M UNet params, "
          f"{sum(p.numel() * p.element_size() for p in rt.unet.parameters()) / 2**30:.2f} GiB; "
          f"heads of {ucfg.head_dim_fixed}, context {ucfg.context_dim}, "
          f"{ucfg.prediction_type}, VAE scale {rt.vae.config.scaling_factor})", flush=True)
    ctx = torch.randn((1, cfg.num_tokens, ucfg.context_dim), generator=torch.Generator().manual_seed(1))
    model = KeypointModel(rt, ctx.numpy(), np.arange(cfg.top_k))
    rng = np.random.default_rng(2)
    images = rng.uniform(0, 1, (4, cfg.image_size, cfg.image_size, 3)).astype(np.float32)

    # detect
    t0 = time.time()
    model.detect_batch(images[:1])
    torch.cuda.synchronize()
    print(f"[{tag}] warm-up M=1 detect: {time.time() - t0:.2f} s", flush=True)
    count = reset_counts()
    torch.cuda.reset_peak_memory_stats()
    secs, pts = detect_seconds(torch, model, images, 1)
    passes = -(-cfg.augmentation_iterations // rt.views_per_pass(cfg.augmentation_iterations))
    launches = check_counts(tag, count, bb["per_pass"], passes, "detect pass")
    peak_detect = torch.cuda.max_memory_allocated() / 2**30
    assert pts.shape == (1, cfg.top_k, 2) and np.isfinite(pts).all(), pts
    assert (pts >= 0).all() and (pts <= 1).all(), pts
    again = detect_seconds(torch, model, images, 1)[0]
    print(f"[{tag}] {label} detect M=1 ({cfg.augmentation_iterations} views, {passes} pass): "
          f"{secs:.3f} s/image, then {again:.3f}; peak device memory {peak_detect:.2f} GiB | "
          f"{card}", flush=True)
    profile_detect = profile_call(torch, lambda: model.detect_batch(images[:1]),
                                  f"one {label} M=1 detect", out_dir,
                                  f"profile_{tag}_detect.txt", card, again * 1e3)
    two = Runtime(dataclasses.replace(cfg, eval_views_per_pass=2), rt.unet, rt.vae, rt.schedule,
                  rt.device)
    rel, agree = maps_vs_plain(torch, two, ctx, images[0], tag, card)

    # training: an epoch of fill steps, then one of cached steps
    data = SyntheticBlobs(length=cfg.batch_size, image_size=cfg.image_size)
    batch = np.stack([data[i]["img"] for i in range(cfg.batch_size)])
    gen = torch.Generator(device=rt.device).manual_seed(5)
    ctx0 = rt.init_context()
    t0 = time.time()
    context = rt.train_context(ctx0)
    opt = rt.optimizer(context)
    lat = rt.train_step_fill(context, opt, batch, generator=gen)[3]
    rt.train_step_cached(context, opt, lat, batch, generator=gen)
    torch.cuda.synchronize()
    print(f"[{tag}] warm-up (one fill, one cached step): {time.time() - t0:.2f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    learned, step_secs, count, losses = run_stage1(torch, rt, data, ctx0, gen, 2,
                                                   os.path.join(out_dir, tag))
    train_launches = check_counts(tag, count, bb["per_step"], 2, "training step")
    peak_train = torch.cuda.max_memory_allocated() / 2**30
    assert len(losses) == 2 and all(np.isfinite(losses)), losses
    assert [len(step_secs[k]) for k in ("fill", "cached")] == [1, 1], step_secs
    assert (learned - ctx0).abs().max().item() > 0 and torch.isfinite(learned).all()
    s_fill, s_cached = step_secs["fill"][0], step_secs["cached"][0]
    print(f"[{tag}] {label} batch {cfg.batch_size}: fill {s_fill:.4f} s/step, cached "
          f"{s_cached:.4f} s/step; losses {[round(x, 6) for x in losses]}; peak device memory "
          f"{peak_train:.2f} GiB | {card}", flush=True)
    profile_step = profile_call(torch, lambda: rt.train_step_cached(context, opt, lat, batch,
                                                                    generator=gen),
                                f"one {label} cached training step", out_dir,
                                f"profile_{tag}_step.txt", card, s_cached * 1e3)
    del context, opt, lat
    torch.cuda.empty_cache()
    grad = gradient_check(torch, rt, data, card, tag, batch=1, offload_plain=fam == "sdxl")

    # the vote: 4 images, batch cfg.batch_size
    vote_rt = Runtime(dataclasses.replace(cfg, num_indices=4), rt.unet, rt.vae, rt.schedule,
                      rt.device)
    vote_data = SyntheticBlobs(length=4, image_size=cfg.image_size)
    vgen = torch.Generator(device=rt.device).manual_seed(7)
    count = reset_counts()
    t0 = time.time()
    indices = find_best_indices(vote_rt, vote_data, learned, generator=vgen)
    torch.cuda.synchronize()
    vote_s = time.time() - t0
    vote_launches = check_counts(tag, count, bb["per_pass"], -(-4 // cfg.batch_size),
                                 "vote batch")
    assert indices.shape == (cfg.top_k,) and len(set(indices.tolist())) == cfg.top_k, indices
    print(f"[{tag}] vote over 4 images: indices {indices.tolist()}, {vote_s / 4:.4f} s/image "
          f"(the first call at the vote's shapes) | {card}", flush=True)
    result = dict(launches=launches, train_launches=train_launches, vote_launches=vote_launches,
                  s_per_image=secs, s_per_image_again=again, peak_gib_detect=peak_detect,
                  maps_rel_err=rel, argmax_agree=agree, s_per_step_fill=s_fill,
                  s_per_step_cached=s_cached, losses=losses, peak_gib_train=peak_train,
                  grad_check=grad, vote_s_per_image=vote_s / 4, indices=indices.tolist(),
                  profile_detect=profile_detect, profile_step=profile_step)

    if fam == "sd21":  # K2 at d 64: one fill step at a 96^2 capture grid
        rt96 = Runtime(dataclasses.replace(cfg, feature_upsample_res=96), rt.unet, rt.vae,
                       rt.schedule, rt.device)
        c96 = rt96.train_context(ctx0)
        count = reset_counts()
        _, _, aux = rt96.train_step(c96, rt96.optimizer(c96), batch, generator=gen)
        torch.cuda.synchronize()
        result["capture96_launches"] = check_counts(f"{tag} 96^2 capture", count,
                                                    PER_STEP_SD21_96, 1, "training step")
        assert np.isfinite(aux["loss"].item()) and torch.isfinite(c96.grad).all()
        print(f"[{tag}] one fill step at a 96^2 capture grid (K2 fwd and bwd at d 64): loss "
              f"{aux['loss'].item():.6f} | {card}", flush=True)
        del rt96, c96
    if fam == "sdxl":
        result["generate"] = backbone_generate(torch, rt, learned, card, out_dir)
        del model, two, vote_rt
        rt = None
        torch.cuda.empty_cache()
        result["cli"] = backbone_cli(torch, card, out_dir)
    return result


def backbone_generate(torch, rt, context, card, out_dir):
    """SDXL generate_images: 1 image, 4 DDIM steps, guidance 7.5 and the
    final-step capture (micro-conditioning of 1024^2 on all 9 forwards), the
    1024^2 decode; launches per call; one forward's eps against the plain
    layers."""
    import numpy as np

    from stablekeypoints_tpu_torch.models.scheduler import DDIMSchedule
    from stablekeypoints_tpu_torch.pipeline.generate import generate_images
    from stablekeypoints_tpu_torch.pipeline.runtime import Runtime

    cfg, steps, scale = rt.cfg, 4, 7.5
    short = Runtime(cfg, rt.unet, rt.vae, DDIMSchedule.create(steps), rt.device)
    gen = lambda: torch.Generator(device=rt.device).manual_seed(14)  # noqa: E731
    t0 = time.time()
    generate_images(short, context, 1, generator=gen(), guidance_scale=scale,
                    capture_final_maps=True)
    print(f"[sdxl] generate warm-up: {time.time() - t0:.2f} s", flush=True)
    count = reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    images, maps = generate_images(short, context, 1, generator=gen(), guidance_scale=scale,
                                   capture_final_maps=True)
    secs = time.time() - t0
    want = added(scaled(PER_UNET_FORWARD_SDXL, 2 * steps), PER_DECODE, PER_CAPTURE_FORWARD_SDXL)
    launches = check_counts("sdxl generate", count, want, 1, "generate call")
    assert images.shape == (1, cfg.image_size, cfg.image_size, 3), images.shape
    assert np.isfinite(images).all() and images.min() >= 0 and images.max() <= 1
    assert maps.shape == (1, cfg.num_tokens, cfg.feature_upsample_res,
                          cfg.feature_upsample_res) and np.isfinite(maps).all(), maps.shape
    print(f"[sdxl] generate_images 1 image, {steps} DDIM steps, guidance {scale}, capture: "
          f"{secs:.3f} s; image mean {images.mean():.4f} std {images.std():.4f} | {card}",
          flush=True)
    lat = torch.randn((1, cfg.image_size // 8, cfg.image_size // 8, 4),
                      generator=torch.Generator(device=rt.device).manual_seed(15),
                      device=rt.device)
    ts = torch.full((1,), int(short.schedule.timesteps[0]), dtype=torch.int32, device=rt.device)
    cond = context.to(rt.device).float()
    plain = plain_runtime(rt)
    with torch.inference_mode():
        got = rt.unet(lat, ts, cond, added_cond=rt.added_cond(1))[0]
        ref = plain.unet(lat, ts, cond, added_cond=plain.added_cond(1))[0]
        check = held_to_plain(torch, "sdxl generate eps, learned context: kernels vs plain layers",
                              got, ref, card)
    del plain
    torch.cuda.empty_cache()
    return dict(launches=launches, seconds=secs, steps=steps, guidance=scale, eps_check=check)


def backbone_cli(torch, card, out_dir):
    """`python -m stablekeypoints_tpu_torch.main --model_type
    stabilityai/stable-diffusion-xl-base-1.0 --image_size 1024` in process
    on a folder of 4 synthetic 1024^2 images (the custom adapter: stages 1
    and 2): 2 steps at batch 1, the vote over the 4 images; the launches of
    the whole run against 2 steps and 4 vote batches."""
    import shutil
    import tempfile

    import numpy as np
    from PIL import Image

    from stablekeypoints_tpu_torch import main as cli

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="sdxl_cli_", dir=os.path.join(REPO, "build"))
    try:
        folder, out = os.path.join(root, "imgs"), os.path.join(root, "out")
        os.makedirs(folder)
        rng = np.random.default_rng(0)
        for i in range(4):
            Image.fromarray(rng.integers(0, 255, (1024, 1024, 3), dtype=np.uint8)).save(
                os.path.join(folder, f"{i:03d}.png"))
        argv = ["--dataset_name", "custom", "--dataset_loc", folder, "--save_folder", out,
                "--model_type", BACKBONES["sdxl"]["model_type"], "--image_size", "1024",
                "--batch_size", "1", "--num_steps", "2", "--num_indices", "4"]
        count = reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        results = cli.main(argv)
        torch.cuda.synchronize()
        secs = time.time() - t0
        launches = launches_now(count)
        check_launches("sdxl --model_type CLI, 2 steps + 4 vote batches", launches,
                       added(scaled(PER_STEP_SDXL, 2), scaled(PER_PASS_SDXL, 4)), 1, "run")
        assert results["embedding"].shape == (1, 500, 2048), results["embedding"].shape
        assert len(results["indices"]) == 10 and np.isfinite(results["embedding"]).all()
        shutil.copy(os.path.join(out, "metrics.jsonl"), os.path.join(out_dir, "sdxl_cli_metrics.jsonl"))
        print(f"[sdxl] CLI {' '.join(argv[6:])}: stages 1-2 in {secs:.2f} s (runtime creation "
              f"included), indices {np.asarray(results['indices']).tolist()} | {card}", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return dict(launches=launches, seconds=secs)


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
                                "attn_fwd_kernel<40, 1>", "attn_fwd_kernel<64, 1>",
                                "attn_fwd_kernel<80, 1>")),
    ("K1/K2 capture", ("capture_fwd_kernel",)),
    ("K7 gn_conv", ("gn_conv_kernel",)),
    ("K3 cross", ("cross_fwd_kernel",)),
    ("K4/K5 flash", ("attn_fwd_kernel", "flash_wide_kernel")),
    ("K6 groupnorm", ("gn_coeffs_kernel", "apply_kernel")),
    ("convolution (cuDNN)", ("fprop", "conv", "Conv", "nchw", "nhwc")),
    ("matmul (cuBLAS)", ("gemm", "nvjet", "Kernel2")),
)


PHASES = ("kernels", "detect", "train", "vote", "capture96", "cli", "weights", "generate",
          "visualize", "sd21", "sdxl")


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
    if rt is None and set(phases) & {"train", "vote", "capture96", "cli"}:
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
    if "cli" in phases:
        results["cli"] = phase_cli(torch, rt, card, out_dir)
    if set(phases) & {"weights", "generate", "visualize"}:
        # the fabricated checkpoint stays on disk while runtimes that load
        # it (their plain-layer twins) may be created
        os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
        root = tempfile.mkdtemp(prefix="weights_", dir=os.path.join(REPO, "build"))
        try:
            if "weights" in phases:
                rt, results["weights"] = phase_weights(torch, card, out_dir, root)
            elif rt is None:
                from stablekeypoints_tpu_torch.config import Config
                from stablekeypoints_tpu_torch.pipeline.runtime import Runtime

                rt = Runtime.create(Config())
            if "generate" in phases:
                results["generate"] = phase_generate(torch, rt, card, out_dir)
            if "visualize" in phases:
                results["visualize"] = phase_visualize(torch, rt, card, out_dir)
        finally:
            shutil.rmtree(root, ignore_errors=True)
    rt = None  # the SD-1.5 weights leave the card before the larger backbones
    torch.cuda.empty_cache()
    for fam in ("sd21", "sdxl"):
        if fam in phases:
            results[fam] = phase_backbone(torch, fam, card, out_dir)
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
    # the d-64 rows: forward kernels per detect pass of their backbone's
    # phase, backward kernels per training step, K2 per SD-2.1 step at 96^2
    for row, s in summary.items():
        if "@" not in row:
            continue
        name, fam = row.split("@")
        key = ("capture96_launches" if name.startswith("capture_unfused")
               else "train_launches" if name.endswith("_bwd") else "launches")
        rows.append(dict(
            name=row, **KERNELS[name], launches=results[fam][key][name],
            max_abs_err=s["max_abs_err"], ms=s["ms"], plain_ms=s["plain_ms"],
            bound_ms=s["bound_ms"],
            bound_by="operations" if s["ops_ms"] >= s["bytes_ms"] else "bytes",
            library_ms=s["library_ms"], unfused_ms=s["unfused_ms"],
            per={"launches": f"one {BACKBONES[fam]['label']} detect forward pass (10 views)",
                 "train_launches": f"one {BACKBONES[fam]['label']} training step (batch "
                                   f"{BACKBONES[fam]['batch_size']})",
                 "capture96_launches": "one SD-2.1 768^2 training step at a 96^2 capture grid"
                 }[key],
        ))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
