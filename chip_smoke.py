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
              exponential floor (one ex2 per score at 16 per clock per SM);
              K1/K2 also at a tensor-parallel rank's heads (total_heads the
              layer's) at the [tensor] phase's step shapes.
  3. detect   a full-width SD-1.5 runtime from the seed (random weights),
              KeypointModel.detect_batch on 1 and 4 images of 512^2 with a
              random [1, 500, 768] context and indices 0..9; launch counts
              of every kernel against the expected count per forward pass;
              the same calls with K7 off (fused_gn_conv="off"); a
              torch.profiler trace of one M=1 call (device time by kernel);
              the ensembled maps against the same runtime with every kernel
              switched off (plain PyTorch layers).
  4. serve    the serving export of the same runtime: export_detector for
              batches 1 and 4 with a random [20, 10] regressor (deleted at
              the end); ServedDetector.load in a fresh interpreter that
              imports no jax, serving batch 1 from its CUDA graph, then in
              this process with each kernel's launches counted inside each
              graph capture (as many as the detect passes launch); served
              keypoints against the live eager augmented_keypoints with the
              same seed (none off by more than a pixel, regressed within
              1e-5 of the regressor on them); a replay calls no wrapper and
              its profile shows every kernel; served against eager
              detect_batch s/image at M=1 and M=4, in turns; export, load
              and capture seconds, artifact bytes, device memory.
  5. train    stage 1 on the same runtime: optimize_embedding on
              SyntheticBlobs (8 images of 512^2), batch 4, an epoch of fill
              steps then one of cached steps; s/step, peak memory, losses,
              launch counts per step against the prediction; a profile of
              one cached step; the context gradient of a fixed loss through
              the kernels against the same through the plain layers.
  6. vote     stage 2 on the same runtime: find_best_indices over 8 images
              with the learned context (launches per vote batch, s/image,
              distinct indices in range); then learn_keypoints (2 steps,
              4 voted images) and one detect, the whole user flow.
  7. capture96  the same weights at a 96^2 capture grid, where the layers
              route the capture to K2 (no K1): 2 fill + 2 cached training
              steps, a profile of one cached step, the fixed-loss context
              gradient against the plain layers, and one M=1 detect whose
              maps are held to the plain layers'.
  8. cli      the five-stage CLI, `stablekeypoints_tpu_torch.main.main`, at
              full width on a synthetic CelebA layout of 16 images of 512^2
              (examples/make_synthetic_celeba.py: 12 train/regression, 4
              test): 4 stage-1 steps (checkpoint every 2), the vote over 8
              images, stage 3 on 12 images and stage 5 on 4 in chunks of 4;
              launch counts per step, vote batch and stage-3/5 chunk;
              s/step and s/image per stage; the artifact set; a --resume
              rerun that reuses the artifacts; a mid-stage resume of
              optimize_embedding from the step-2 checkpoint; learn_keypoints
              on the image folder and one detect.
  9. parallel data parallel (parallel/mesh.py) on the same runtime: world 1
              over NCCL in this process (a fill and a cached step through
              the mesh: launches per step, one all_reduce call and one NCCL
              kernel a step; a steps_per_call group of 4 with the all-reduce
              inside the CUDA graph: launches counted at capture, one NCCL
              kernel a replayed step; one step from one state against the
              non-mesh step; grouped s/step against the non-mesh group in
              turns; peak memory), then world 2 over gloo on the one card
              (two processes, batch 2 each): the averaged gradient of one
              step against world 1's batch 4, a vote batch and a stage-3
              chunk gathered against world 1's; native.available() and the
              host decode of a 512^2 JPEG by native_io="on" against PIL.
 9b. tensor   tensor parallel (parallel/tensor.py): the mesh (1, 2) over gloo,
              both ranks on the one card, each holding its Megatron slice of
              the UNet: SD-1.5 512^2 batch 4, a fill and a cached step against
              the one-process steps on the same inputs, launches per step (each
              kernel at the rank's heads), one world all_reduce a step and the
              model group's all-reduces as predicted from the config, a 96^2
              step (K2), a vote forward; SDXL 1024^2 batch 1, a fill step, the
              ensembled maps of 2 views against the one-process maps, an M=1
              detect; per rank the UNet's bytes against the plan, peak memory.
 10. weights  a full-width SD-1.5 diffusers directory written by the port's
              fabricate_checkpoint (UNet fp16 safetensors, VAE fp32 .bin
              under diffusers-0.8 names), Runtime.create(model_path=...) on
              the card: load time, peak memory, every parameter bitwise the
              file's cast; one M=1 detect's maps against the plain layers.
 11. generate generate_images on the loaded runtime (2 images, 50 DDIM
              steps) at guidance 1.0 and 7.5 (with the final-step capture):
              s/image, launches per call, per UNet forward and per decode; a
              profile of one guided step and of one decode; the guided eps
              against the plain layers, a decode against the fp32 plain
              layers (within twice the bf16 plain layers' own error).
 12. visualize  visualize_attn_maps and create_vid on 4 synthetic CelebA
              images (plots where matplotlib imports); latent_warp: an M=1
              detect (one encode of the image) against the plain layers, a
              fill and a cached step, the fixed-loss context gradient.
 13. sd21, sdxl  SD-2.1 768^2 and SDXL 1024^2 at full width (see
              phase_backbone); sdxl also exports, loads and serves one
              1024^2 image from a CUDA graph against its live detect.
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
            "capture_unfused_bwd": 0, "capture_bwd_precise": 0, "capture_unfused_bwd_precise": 0}
# expected launches per training step (batch 4, merged batch 8, one VAE encode
# call per step: of both image sets on fill steps, of the warped ones on cached
# steps). Forward as detect; backward: the first self-attention of down_0 runs
# before any layer reads the context, so it gets no gradient (K4 5 - 1), and
# up_2's cross-attention output reaches no loss (truncation, K5 3 - 1).
PER_STEP = dict(PER_PASS, capture_bwd=4, cross_bwd=2, flash_self_bwd=4, flash_cross_bwd=2)
# at a 96^2 capture grid the four captures run K2 instead of K1
PER_STEP_96 = dict(PER_STEP, capture=0, capture_bwd=0, capture_unfused=4, capture_unfused_bwd=4)
# remat on: the backward runs every transformer of the truncated forward again
# (each is on the gradient's path: all read the context), so each forward
# kernel of the UNet twice (K1 4, K3 2, K4 5, K5 3 more); the VAE (no grad)
# and the backward kernels as before
PER_STEP_REMAT = dict(PER_STEP, capture=8, cross=4, flash_self=11, flash_cross=6)


def precise(per):
    """`per` with capture_fp32_bwd: the capture backward launches are the
    precise kernels'."""
    return dict(per, capture_bwd=0, capture_unfused_bwd=0,
                capture_bwd_precise=per["capture_bwd"],
                capture_unfused_bwd_precise=per["capture_unfused_bwd"])
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
# SD-2.1: K4 down_0 x1 + down_1 x2, K3 down_0 x2 + down_1 x2, K1 x3. Its
# merged batch of 4 at 768^2 is 9 units of 512^2 (> 8), so remat's auto rule
# turns it on: the backward runs the transformers of down_0, down_1 (K4, K3
# x4 each) and up_1 (K1 x3) again; those after the last capture reach no loss
PER_STEP_SD21 = dict(PER_PASS_SD21, capture_bwd=3, cross_bwd=4, flash_self_bwd=3,
                     capture=6, cross=14, flash_self=15)
# SDXL: K4 down_1 x3, down_2 x20, mid x10, up_0 x21 (two whole stacks and the
# third's first block, which captures); K3 down_1 x4; K5 down_2 x20, mid x10,
# up_0 x20; K1 x3
PER_STEP_SDXL = dict(PER_PASS_SDXL, capture_bwd=3, cross_bwd=4, flash_self_bwd=54,
                     flash_cross_bwd=50)
# SD-2.1 at a 96^2 capture grid: the three captures run K2 (d 64) instead of K1
PER_STEP_SD21_96 = dict(PER_STEP_SD21, capture=0, capture_bwd=0, capture_unfused=6,
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


def _headmean(q, kh, s, total=None):
    """One PyTorch expression of the capture: matmul, softmax, head-mean (the
    sum over the heads given / `total`, a tensor-parallel rank's part)."""
    import torch

    p = torch.softmax(torch.matmul(q, kh.transpose(-1, -2)).float() * s, dim=-1)
    return p.mean(1) if total is None else p.sum(1) / total


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


def _dk_unrounded(q, k, g, s):
    """dk [B, T, H, D] of the capture backward with dsim in fp32, before its
    final rounding to bf16: the reference of the precise check."""
    import torch

    h = q.shape[1]
    kf = k.float()
    p = torch.softmax(torch.einsum("bhnd,bthd->bhnt", q.float(), kf) * s, dim=-1)
    t1 = g.float()[:, None] * (1.0 / h) * p
    dsim = (t1 - p * t1.sum(-1, keepdim=True)) * s
    del p, t1
    return torch.einsum("bhnt,bhnd->bthd", dsim, q.float())


def _mean_rel_err(got, want):
    return ((got.float() - want).abs().mean() / want.abs().mean()).item()


def _precise_versus(kernel, q_up, k, g, s):
    """(the precise kernel's dk error, the default kernel's) against the
    unrounded fp32 dk, as mean |error| over mean |dk|: rounding dsim to bf16
    (the default) adds its own error to the final rounding both share."""
    def run():
        want = _dk_unrounded(q_up, k, g, s)
        errs = tuple(_mean_rel_err(kernel(precise)[1], want) for precise in (True, False))
        del want
        return errs
    return run


def capture_case(torch, gen, b, h, x, d, count, backward=False, row=None, t=500,
                 precise=False, total=None):
    """K1 (forward, or with `backward` its backward against a random map
    cotangent) from tt [b, h, 128, x, d] (an x^2 grid's row-resized queries)
    to the 128^2 capture; the library call is matmul + softmax + head-mean on
    the upsampled queries (and its autograd). Forward maps within 1e-4,
    gradients within 2^-6 of their largest magnitude. `precise`: the
    capture_fp32_bwd backward against the plain version with precise=True,
    within 2^-7 (one bf16 ulp at the top binade: only the final roundings
    differ), its library call autograd in fp32; its error against the
    unrounded dk below the default kernel's (`versus`). `total`: the layer's
    heads, of which these h are a tensor-parallel rank's (total_heads)."""
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
            kernel=lambda: attn_capture.capture_attention_fused(tt, ww, k, s, total),
            plain=lambda: attn_capture.capture_fused_plain(tt, ww, k, s, total),
            library=lambda: _headmean(q_up, kh, s, total),
            nbytes=2 * (tt.numel() + ww.numel() + k.numel()) + 4 * b * n * t,
            flops=2 * b * h * n * t * d + 2 * b * h * n * x * d, peak=PEAK_BF16, tol=1e-4,
            exps=b * h * n * t, deterministic=True)  # one ex2 a score; heads summed in order
    g = _randn(torch, gen, b, n, t, scale=1e-3, dtype=torch.float32)
    name = "capture_bwd_precise" if precise else "capture_bwd"
    if precise:  # the library: autograd in fp32 (dsim fp32 through the products)
        q_up, kh = q_up.float(), kh.float()
    qg, khg = q_up.detach().requires_grad_(), kh.detach().requires_grad_()
    case = dict(
        name=name, row=row or name, count=count,
        shape=f"tt[{b},{h},128,{x},{d}] g[{b},{n},{t}]",
        kernel=lambda: attn_capture.capture_attention_fused_bwd(tt, ww, k, g, s, precise, total),
        plain=lambda: attn_capture.capture_fused_bwd_plain(tt, ww, k, g, s, precise, total),
        library_time=_minus_forward(
            lambda: torch.autograd.grad(_headmean(qg, khg, s, total), (qg, khg), g),
            lambda: _headmean(qg, khg, s, total)),
        nbytes=2 * 2 * (tt.numel() + k.numel()) + 2 * ww.numel() + 4 * g.numel(),
        # precise: the two products of fp32 dsim take it as two bf16 halves
        flops=2 * b * h * n * ((5 if precise else 3) * t * d + 2 * x * d), peak=PEAK_BF16,
        tol=2.0**-7 if precise else 2.0**-6, relative=True,
        exps=2 * b * h * n * t)  # one ex2 a score in the statistics, one in the backward
    if precise:
        q_bf = q_up.to(torch.bfloat16)
        case["versus"] = _precise_versus(
            lambda p: attn_capture.capture_attention_fused_bwd(tt, ww, k, g, s, p), q_bf, k, g, s)
    return case


def capture_unfused_case(torch, gen, b, h, d, count, backward=False, row=None, t=500,
                         precise=False, total=None):
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
            kernel=lambda: attn_capture.capture_attention(q, k, s, total),
            plain=lambda: attn_capture.capture_plain(q, k, s, total),
            library=lambda: _headmean(q, kh, s, total),
            nbytes=2 * (q.numel() + k.numel()) + 4 * b * n * t,
            flops=2 * b * h * n * t * d, peak=PEAK_BF16, tol=1e-4, exps=b * h * n * t,
            deterministic=True)
    g = _randn(torch, gen, b, n, t, scale=1e-3, dtype=torch.float32)
    name = "capture_unfused_bwd_precise" if precise else "capture_unfused_bwd"
    ql, khl = (q.float(), kh.float()) if precise else (q, kh)
    qg, khg = ql.detach().requires_grad_(), khl.detach().requires_grad_()
    case = dict(
        name=name, row=row or name,
        shape=f"q[{b},{h},{n},{d}] g[{b},{n},{t}]", count=count,
        kernel=lambda: attn_capture.capture_attention_bwd(q, k, g, s, precise, total),
        plain=lambda: attn_capture.capture_bwd_plain(q, k, g, s, precise, total),
        library_time=_minus_forward(
            lambda: torch.autograd.grad(_headmean(qg, khg, s, total), (qg, khg), g),
            lambda: _headmean(qg, khg, s, total)),
        nbytes=2 * 2 * (q.numel() + k.numel()) + 4 * g.numel(),
        flops=2 * b * h * n * (5 if precise else 3) * t * d, peak=PEAK_BF16,
        tol=2.0**-7 if precise else 2.0**-6, relative=True, exps=2 * b * h * n * t)
    if precise:
        case["versus"] = _precise_versus(
            lambda p: attn_capture.capture_attention_bwd(q, k, g, s, p), q, k, g, s)
    return case


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
    # capture_fp32_bwd: the precise K1 and K2 backward at the same shapes
    cases += [capture_case(torch, gen, B, 8, x, d, count, backward=True, precise=True)
              for x, d, count in ((16, 160, 3), (32, 80, 1))]
    cases += [capture_unfused_case(torch, gen, B, 8, d, count, backward=True, precise=True)
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
    yield capture_case(torch, gen, 4, 20, 24, D, 3, backward=True, precise=True,
                       row="capture_bwd_precise" + r)
    yield capture_unfused_case(torch, gen, 4, 20, D, 3, backward=True, precise=True,
                               row="capture_unfused_bwd_precise" + r)

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


def tensor_cases(torch, gen):
    """K1/K2 at a tensor-parallel rank's heads with total_heads the layer's
    (the [tensor] phase's mesh (1, 2)), at the shapes its training steps give
    them: SD-1.5 512^2 (merged batch 8) at 4 of 8 heads, K1 forward and
    backward and, at its 96^2 capture grid, K2; SDXL 1024^2 (merged batch 2)
    at 10 of 20 heads, K1. Each a row of its own ("<kernel>@tp",
    "<kernel>@sdxl_tp")."""
    for x, d, count in ((16, 160, 3), (32, 80, 1)):
        yield capture_case(torch, gen, 8, 4, x, d, count, row="capture@tp", total=8)
        yield capture_case(torch, gen, 8, 4, x, d, count, backward=True, row="capture_bwd@tp",
                           total=8)
    for d, count in ((160, 3), (80, 1)):
        yield capture_unfused_case(torch, gen, 8, 4, d, count, row="capture_unfused@tp", total=8)
        yield capture_unfused_case(torch, gen, 8, 4, d, count, backward=True,
                                   row="capture_unfused_bwd@tp", total=8)
    yield capture_case(torch, gen, 2, 10, 32, 64, 3, row="capture@sdxl_tp", total=20)
    yield capture_case(torch, gen, 2, 10, 32, 64, 3, backward=True, row="capture_bwd@sdxl_tp",
                       total=20)


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
    # capture_fp32_bwd: the TPU kernels' precise=True
    "capture_bwd_precise": dict(route="cuda",
                                source="stablekeypoints_tpu_torch/kernels/csrc/attn_capture.cu",
                                replaces="stablekeypoints_tpu/kernels/attn_capture.py:367"),
    "capture_unfused_bwd_precise": dict(
        route="cuda", source="stablekeypoints_tpu_torch/kernels/csrc/attn_capture.cu",
        replaces="stablekeypoints_tpu/kernels/attn_capture.py:284"),
}
# the run whose launch counts each kernel's row reports (its main path):
# backward kernels the training step, K2 the 96^2 capture phase, the precise
# backward kernels one capture_fp32_bwd step of either, the rest the detect
# forward: (phase, key of its launches)
LAUNCHES_FROM = {"capture_unfused": ("capture96", "launches"),
                 "capture_unfused_bwd": ("capture96", "launches"),
                 "capture_bwd_precise": ("train", "precise_launches"),
                 "capture_unfused_bwd_precise": ("capture96", "precise_launches"),
                 **{n: ("train", "launches") for n in ("capture_bwd", "cross_bwd",
                                                       "flash_self_bwd", "flash_cross_bwd")}}


def counters():
    """{kernel name: (wrapper, the attribute that counts its launches)}."""
    from stablekeypoints_tpu_torch.kernels import attn_capture, cross_attn, flash, gn_conv, groupnorm

    count = {
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
    count = {n: (fn, "launches") for n, fn in count.items()}
    # capture_fp32_bwd: the precise backward kernels, counted by the same wrappers
    count["capture_bwd_precise"] = (attn_capture.capture_attention_fused_bwd, "launches_precise")
    count["capture_unfused_bwd_precise"] = (attn_capture.capture_attention_bwd, "launches_precise")
    return count


def reset_counts():
    count = counters()
    for fn, attr in count.values():
        setattr(fn, attr, 0)
    return count


def launches_now(count):
    return {n: getattr(fn, attr) for n, (fn, attr) in count.items()}


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

    for case in itertools.chain(kernel_cases(torch, gen), backbone_cases(torch, gen),
                                tensor_cases(torch, gen)):
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
        versus = None
        if "versus" in case:  # precise: its error below the default kernel's
            versus = case["versus"]()
            ok = ok and versus[0] < versus[1]
            print(f"[kernel] {row:<11} {case['shape']:<36} dk against the unrounded fp32 dk, "
                  f"mean |err| / mean |dk|: precise {versus[0]:.3e}, default kernel "
                  f"{versus[1]:.3e} (the precise one must be smaller)", flush=True)
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
                                exp_floor_ms=e_ms, max_abs_err=err, path=case.get("path"),
                                precise_vs_default=versus))
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


# the [serve] phase: batch sizes exported, the seed of the compared requests,
# and the kernel names a profiled replay must show on the device (K4 and K5
# share attn_fwd_kernel; the VAE's d-512 attention is flash_wide_kernel)
SERVE_BATCHES = (1, 4)
SERVE_SEED = 5
SERVE_KERNEL_MARKS = {"capture": ("capture_fwd_kernel",), "cross": ("cross_fwd_kernel",),
                      "flash_self": ("attn_fwd_kernel", "flash_wide_kernel"),
                      "flash_cross": ("attn_fwd_kernel",), "groupnorm": ("apply_kernel",),
                      "gn_coeffs": ("gn_coeffs_kernel",), "gn_conv": ("gn_conv_kernel",)}

# a fresh interpreter that loads the artifact (argv: repo, artifact, images
# .npy, seed, output .npz) and serves batch 1 from its CUDA graph
SERVE_CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from stablekeypoints_tpu_torch.serving import ServedDetector
t0 = time.time()
det = ServedDetector.load(sys.argv[2])
load_s = time.time() - t0
images = np.load(sys.argv[3])
out = det.detect(images, seed=int(sys.argv[4]))
np.savez(sys.argv[5], **out)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "stablekeypoints_tpu"))
print(json.dumps({"load_s": load_s, "graphs": {b: p.graph is not None
                                               for b, p in det.programs.items()},
                  "capture_s": {b: p.capture_s for b, p in det.programs.items()},
                  "imported": bad}))
"""


def load_counting_captures(torch, art, passes_of, per_pass, tag, card):
    """ServedDetector.load(art) on the card, with each kernel wrapper's
    launches counted inside each batch size's graph capture (the wrappers
    count in Python, so a capture counts its kernels once) and held to
    per_pass x the passes of a detect at that batch size."""
    from stablekeypoints_tpu_torch import serving

    per_capture = {}
    capture = serving.StaticProgram.capture

    def counted(program, pool):
        count = reset_counts()
        capture(program, pool)
        per_capture[program.inputs["images"].shape[0]] = launches_now(count)

    serving.StaticProgram.capture = counted
    try:
        t0 = time.time()
        det = serving.ServedDetector.load(art)
        torch.cuda.synchronize()
        load_s = time.time() - t0
    finally:
        serving.StaticProgram.capture = capture
    for b, launches in sorted(per_capture.items()):
        for name, n in launches.items():
            want = per_pass[name] * passes_of(b)
            assert n == want, f"{tag} capture b={b} {name}: {n} launches, expected {want}"
        print(f"[{tag}] capture b={b}: launches as a detect of {b} image(s), "
              f"{passes_of(b)} x per pass ({sum(launches.values())} kernel launches in the "
              f"graph); warm-up {det.programs[b].warmup_s:.2f} s, capture "
              f"{det.programs[b].capture_s:.2f} s | {card}", flush=True)
    assert all(p.graph is not None for p in det.programs.values())
    return det, per_capture, load_s


def served_vs_live(tag, served, live, size, regressor=None):
    """Served keypoints against the live eager ones: the count that is not
    bitwise equal, none off by more than one pixel (1/size); `regressed`
    within 1e-5 of the regressor applied to the served keypoints."""
    import numpy as np

    kp = served["keypoints"]
    assert kp.shape == live.shape and np.isfinite(kp).all(), (kp.shape, live.shape)
    unequal = int((kp != live).any(axis=-1).sum())
    diff = float(np.abs(kp - live).max())
    out = dict(unequal=unequal, max_abs_diff=diff)
    line = (f"[{tag}] served vs live eager, {kp.shape[0]} image(s): {unequal} of "
            f"{kp.shape[0] * kp.shape[1]} keypoints not bitwise equal, max diff {diff:.3e} "
            f"(tol one pixel, {1 / size:.3e})")
    if regressor is not None:
        m = kp.shape[0]
        want = ((kp.reshape(m, -1).astype(np.float64) - 0.5) @ regressor + 0.5).reshape(m, -1, 2)
        out["regressed_err"] = float(np.abs(served["regressed"] - want).max())
        line += f"; regressed vs the regressor on them {out['regressed_err']:.3e} (tol 1e-5)"
        assert out["regressed_err"] <= 1e-5, out
    print(line, flush=True)
    assert diff <= 1 / size, out
    return out


def profile_shows_kernels(tag, profile):
    """Every kernel of the detect path by name in a profiled replay."""
    assert profile is not None, f"{tag}: the profile of a replay shows no device time"
    missing = sorted(n for n, marks in SERVE_KERNEL_MARKS.items()
                     if not any(any(m in key for key in profile["names"]) for m in marks))
    assert not missing, f"{tag}: the profiled replay shows no kernel of {missing}"
    print(f"[{tag}] the profiled replay shows every detect kernel on the device: "
          f"{', '.join(sorted({m for marks in SERVE_KERNEL_MARKS.values() for m in marks}))}",
          flush=True)


def phase_serve(torch, rt, card, out_dir):
    """The serving export on the detect phase's SD-1.5 512^2 runtime (full
    width, bf16, every kernel auto, weights from the seed): export_detector
    for batches 1 and 4 with a random [20, 10] regressor under build/;
    ServedDetector.load in a fresh interpreter (no jax), which serves batch
    1; then in this process, with each graph capture's launches held to the
    detect pass's; served keypoints against the live eager
    augmented_keypoints with the same seed (none off by more than a pixel,
    regressed within 1e-5); another seed changes them; replays launch no
    wrapper; a profiled replay shows every kernel; served s/image at M=1
    and M=4 beside eager detect_batch, in turns; export, load and capture
    seconds, bytes and peak memory. The artifact is deleted at the end."""
    import numpy as np

    from stablekeypoints_tpu_torch.api import KeypointModel
    from stablekeypoints_tpu_torch.serving import export_detector

    cfg = rt.cfg
    size, n = cfg.image_size, cfg.augmentation_iterations
    ctx = torch.randn((1, cfg.num_tokens, rt.unet.config.context_dim),
                      generator=torch.Generator().manual_seed(1)).numpy()
    indices = np.arange(cfg.top_k)
    rng = np.random.default_rng(2)
    images = rng.uniform(0, 1, (4, size, size, 3)).astype(np.float32)
    regressor = (0.1 * rng.standard_normal((2 * cfg.top_k, 10))).astype(np.float32)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="serve_", dir=os.path.join(REPO, "build"))
    try:
        art = os.path.join(root, "artifact")
        t0 = time.time()
        manifest = export_detector(rt, ctx, indices, art, batch=SERVE_BATCHES,
                                   regressor=regressor)
        export_s = time.time() - t0
        nbytes = sum(manifest["files"].values())
        print(f"[serve] export_detector SD-1.5 {size}^2, batches {manifest['batches']}, "
              f"regressor [20, 10]: {export_s:.2f} s, {nbytes / 1e9:.3f} GB in "
              f"{len(manifest['files'])} files | {card}", flush=True)

        def live(m, seed=SERVE_SEED):
            return rt.augmented_keypoints(ctx, images[:m], indices,
                                          generator=torch.Generator().manual_seed(seed)
                                          ).cpu().numpy()

        # a fresh interpreter: loads the artifact alone and serves batch 1
        np.save(os.path.join(root, "images.npy"), images[:1])
        t0 = time.time()
        r = subprocess.run([sys.executable, "-c", SERVE_CHILD, REPO, art,
                            os.path.join(root, "images.npy"), str(SERVE_SEED),
                            os.path.join(root, "served.npz")],
                           capture_output=True, text=True, cwd=REPO, timeout=600)
        child_s = time.time() - t0
        assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
        child = json.loads(r.stdout.strip().splitlines()[-1])
        assert child["imported"] == [] and all(child["graphs"].values()), child
        with np.load(os.path.join(root, "served.npz")) as z:
            child_out = {k: z[k] for k in z.files}
        print(f"[serve] a fresh process (no jax): load {child['load_s']:.2f} s (capture "
              f"{', '.join(f'b={b} {s:.2f} s' for b, s in child['capture_s'].items())}), "
              f"{child_s:.1f} s with its start | {card}", flush=True)
        child_check = served_vs_live("serve fresh process", child_out, live(1), size, regressor)

        # this process
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        det, per_capture, load_s = load_counting_captures(
            torch, art, lambda b: -(-b * n // rt.views_per_pass(b * n)), PER_PASS, "serve", card)
        served_gib = (torch.cuda.memory_allocated() - base[0]) / 2**30
        pool_gib = (torch.cuda.memory_reserved() - base[1]) / 2**30
        print(f"[serve] ServedDetector.load in this process: {load_s:.2f} s; "
              f"{served_gib:.2f} GiB allocated (weights, static inputs and outputs), "
              f"{pool_gib:.2f} GiB more reserved (those and the graph pool) | {card}", flush=True)
        checks = {}
        for m in SERVE_BATCHES:
            checks[m] = served_vs_live("serve", det.detect(images[:m], seed=SERVE_SEED),
                                       live(m), size, regressor)
        first = det.detect(images[:1], seed=SERVE_SEED)["keypoints"]
        other = det.detect(images[:1], seed=SERVE_SEED + 1)["keypoints"]
        assert np.abs(other - first).max() > 0, "another seed left the keypoints unchanged"
        count = reset_counts()
        det.detect(images, seed=SERVE_SEED)
        assert not any(launches_now(count).values()), launches_now(count)
        print("[serve] another seed changes the keypoints; a replay calls no kernel wrapper",
              flush=True)

        # s/image in turns: served, eager, eager, served
        model = KeypointModel(rt, ctx, indices)
        secs = {"served": {}, "eager": {}}
        for kind in ("served", "eager", "eager", "served"):
            for m in SERVE_BATCHES:
                t0 = time.time()
                if kind == "served":
                    det.detect(images[:m], seed=SERVE_SEED)
                else:
                    model.detect_batch(images[:m])
                torch.cuda.synchronize()
                secs[kind].setdefault(m, []).append((time.time() - t0) / m)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        for m in SERVE_BATCHES:
            print(f"[serve] M={m}: served {secs['served'][m][0]:.4f} / "
                  f"{secs['served'][m][1]:.4f} s/image, eager detect_batch "
                  f"{secs['eager'][m][0]:.4f} / {secs['eager'][m][1]:.4f} | {card}", flush=True)
        print(f"[serve] peak device memory {peak_gib:.2f} GiB (the exporting runtime and the "
              f"served detector) | {card}", flush=True)
        profile = profile_call(torch, lambda: det.detect(images[:1], seed=SERVE_SEED),
                               "one served M=1 detect (graph replay)", out_dir,
                               "profile_serve.txt", card, min(secs["served"][1]) * 1e3)
        profile_shows_kernels("serve", profile)
        launches = {name: sum(c[name] for c in per_capture.values()) for name in PER_PASS}
        result = dict(launches=launches, per_capture=per_capture, export_s=export_s,
                      artifact_bytes=nbytes, child=dict(child, check=child_check, seconds=child_s),
                      load_s=load_s, served_gib=served_gib, reserved_gib=pool_gib,
                      peak_gib=peak_gib,
                      capture_s={b: p.capture_s for b, p in det.programs.items()},
                      warmup_s={b: p.warmup_s for b, p in det.programs.items()},
                      checks=checks, s_per_image=secs, profile=profile)
        del det
        torch.cuda.empty_cache()
        return result
    finally:
        shutil.rmtree(root, ignore_errors=True)


def backbone_serve(torch, rt, ctx, images, eager_s, card, tag):
    """One batch-1 export of the backbone's runtime, loaded in this process
    (the capture's launches held to the detect pass's), one image served
    from the graph against the live eager detect with the same seed; the
    artifact is deleted at the end."""
    import numpy as np

    from stablekeypoints_tpu_torch.serving import export_detector

    cfg = rt.cfg
    n = cfg.augmentation_iterations
    indices = np.arange(cfg.top_k)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix=f"serve_{tag}_", dir=os.path.join(REPO, "build"))
    try:
        t0 = time.time()
        manifest = export_detector(rt, ctx, indices, root, batch=1)
        export_s = time.time() - t0
        nbytes = sum(manifest["files"].values())
        det, per_capture, load_s = load_counting_captures(
            torch, root, lambda b: -(-b * n // rt.views_per_pass(b * n)),
            BACKBONES[tag]["per_pass"], tag, card)
        live = rt.augmented_keypoints(ctx, images[:1], indices,
                                      generator=torch.Generator().manual_seed(SERVE_SEED))
        check = served_vs_live(tag, det.detect(images[:1], seed=SERVE_SEED),
                               live.cpu().numpy(), cfg.image_size)
        served = []
        for _ in range(2):
            t0 = time.time()
            det.detect(images[:1], seed=SERVE_SEED)
            served.append(time.time() - t0)
        print(f"[{tag}] served from a graph: export {export_s:.1f} s ({nbytes / 1e9:.2f} GB), "
              f"load {load_s:.1f} s (capture {det.programs[1].capture_s:.2f} s), "
              f"{served[0]:.4f} / {served[1]:.4f} s/image against eager {eager_s:.4f} | {card}",
              flush=True)
        result = dict(launches=per_capture[1], export_s=export_s, artifact_bytes=nbytes,
                      load_s=load_s, warmup_s=det.programs[1].warmup_s,
                      capture_s=det.programs[1].capture_s, check=check, s_per_image=served)
        del det
        torch.cuda.empty_cache()
        return result
    finally:
        shutil.rmtree(root, ignore_errors=True)


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
    extra = {}
    # capture_fp32_bwd (with remat on in [train]) through the user's entry point
    per_precise = precise(PER_STEP_REMAT if tag == "train" else per_step)
    extra["precise_launches"], extra["precise_check"] = precise_step(
        torch, rt, data, card, tag, per_precise, remat=tag == "train")
    if tag == "train":
        extra["remat"] = remat_check(torch, rt, data, card, out_dir)
        extra["group"] = train_group(torch, rt, data, card, out_dir, ctx0)
    torch.cuda.empty_cache()
    grad = gradient_check(torch, rt, data, card, tag)
    return learned, dict(s_per_step_fill=s_fill, s_per_step_cached=s_cached, secs=secs,
                         launches=launches, peak_gib=peak_gib, losses=losses, profile=profile,
                         grad_check=grad, **extra)


def counting_captures(per_capture):
    """A context that counts each kernel's launches inside every
    StepGraph capture into the list `per_capture`."""
    from stablekeypoints_tpu_torch.pipeline import runtime as rtmod

    capture = rtmod.StepGraph.capture

    def counted(graph):
        count = reset_counts()
        capture(graph)
        per_capture.append(launches_now(count))

    @contextlib.contextmanager
    def ctx():
        rtmod.StepGraph.capture = counted
        try:
            yield
        finally:
            rtmod.StepGraph.capture = capture

    return ctx()


def check_capture(tag, per_capture, per):
    assert len(per_capture) == 1, f"{tag}: {len(per_capture)} captures, expected 1"
    for name, n in per_capture[0].items():
        assert n == per[name], f"{tag} capture {name}: {n} launches, expected {per[name]}"
    print(f"[{tag}] launches inside the graph capture: one cached step's "
          f"({sum(per_capture[0].values())} kernel launches: " + ", ".join(
              f"{n} {v}" for n, v in per_capture[0].items() if v) + ")", flush=True)


def group_inputs(torch, rt, data, k):
    """k cached steps' inputs: the dataset's first two batches in turn,
    [k, B, H, W, 3] images and [k, B, h, w, 4] latents."""
    import numpy as np

    b = rt.cfg.batch_size
    batches = [torch.from_numpy(np.stack([data[i]["img"] for i in range(o, o + b)])).to(rt.device)
               for o in (0, b % len(data))]
    lats = [rt._encode(x) for x in batches]
    return (torch.stack([lats[j % 2] for j in range(k)]),
            torch.stack([batches[j % 2] for j in range(k)]))


def _copy_state(dst, src):
    """The context, Adam state and generator of `src` into `dst`'s tensors,
    in place (a captured graph keeps reading the same addresses)."""
    (ctx_d, opt_d, gen_d), (ctx_s, opt_s, gen_s) = dst, src
    import torch

    with torch.no_grad():
        ctx_d.copy_(ctx_s)
        for k, v in opt_s.state[ctx_s].items():
            opt_d.state[ctx_d][k].copy_(v)
    gen_d.set_state(gen_s.get_state())


def _distance(a, b):
    return ((a - b).norm() / b.norm()).item()


def grouped_vs_eager(torch, rt, lat_k, img_k, card, tag, seed=11):
    """K grouped steps (train_step_scan: on a new graph the first step is
    its warm-up) against K eager train_step_cached steps from one context,
    Adam state and generator state, twice (the second K all replays), with
    a second eager run from the same state beside them: the kernels' dq
    sums land in no fixed order, so two eager runs part too, and Adam's
    first steps move each element by about +-lr whatever its gradient's
    size. Then one replay against one eager step from one state (copied
    in): the context after it within 1e-3 of its norm, the gradient within
    5e-2 of its largest magnitude with cosine >= 0.999. Over K steps the
    grouped run must stay within 1e-3 of the context's norm of the eager
    one, or within twice the distance of the two eager runs where that is
    larger. Returns the eager and grouped states and the numbers."""
    k = len(lat_k)
    ctx0 = rt.init_context()
    runs = {}
    for name in ("eager", "eager2", "grouped"):
        ctx = rt.train_context(ctx0)
        runs[name] = (ctx, rt.optimizer(ctx), torch.Generator(device=rt.device).manual_seed(seed))
    checks = []
    for rnd in range(2):
        losses = {}
        for name in ("eager", "eager2"):
            ctx, opt, gen = runs[name]
            losses[name] = [rt.train_step_cached(ctx, opt, lat_k[j], img_k[j], generator=gen)[2]
                            ["loss"].item() for j in range(k)]
        ctx, opt, gen = runs["grouped"]
        losses["grouped"] = rt.train_step_scan(ctx, opt, lat_k, img_k, generator=gen)[2][
            "loss"].tolist()
        torch.cuda.synchronize()
        ref = runs["eager"][0]
        d_ge, d_ee = _distance(runs["grouped"][0], ref), _distance(runs["eager2"][0], ref)
        change = (ref - ctx0).norm().item() / ref.norm().item()
        ok = d_ge <= max(1e-3, 2 * d_ee) and all(
            map(__import__("math").isfinite, sum(losses.values(), [])))
        print(f"[{tag}] {k} grouped vs {k} eager steps ({'the first a warm-up, ' if rnd == 0 else 'all replays, '}"
              f"steps {k * rnd}-{k * rnd + k - 1}): |context diff| / |context| {d_ge:.3e}; a "
              f"second eager run {d_ee:.3e} (the kernels' own spread); the context moved "
              f"{change:.3e} of its norm (tol: 1e-3, or twice the eager spread) "
              f"{'OK' if ok else 'FAIL'}; losses grouped {[round(x, 7) for x in losses['grouped']]} "
              f"eager {[round(x, 7) for x in losses['eager']]} eager2 "
              f"{[round(x, 7) for x in losses['eager2']]} | {card}", flush=True)
        checks.append(dict(grouped_vs_eager=d_ge, eager_vs_eager=d_ee, change=change,
                           losses=losses, ok=ok))
    # one step from one state
    _copy_state(runs["grouped"], runs["eager"])
    ctx_e, opt_e, gen_e = runs["eager"]
    ctx_g, opt_g, gen_g = runs["grouped"]
    rt.train_step_cached(ctx_e, opt_e, lat_k[0], img_k[0], generator=gen_e)
    rt.train_step_scan(ctx_g, opt_g, lat_k[:1], img_k[:1], generator=gen_g)
    torch.cuda.synchronize()
    d1 = _distance(ctx_g, ctx_e)
    g_rel = ((ctx_g.grad - ctx_e.grad).abs().max() / ctx_e.grad.abs().max()).item()
    g_cos = torch.nn.functional.cosine_similarity(ctx_g.grad.flatten(), ctx_e.grad.flatten(),
                                                  dim=0).item()
    one_ok = d1 <= 1e-3 and g_rel <= 5e-2 and g_cos >= 0.999
    print(f"[{tag}] one replay vs one eager step from one state: |context diff| / |context| "
          f"{d1:.3e} (tol 1e-3), gradient max abs err / max {g_rel:.3e} (tol 5e-2), cosine "
          f"{g_cos:.6f} (tol >= 0.999) {'OK' if one_ok else 'FAIL'} | {card}", flush=True)
    checks.append(dict(one_step=d1, grad_rel=g_rel, grad_cos=g_cos, ok=one_ok))
    assert all(c["ok"] for c in checks), checks
    del runs["eager2"]
    return runs["eager"], runs["grouped"], checks


def timed_turns(torch, k, fns, turns=("grouped", "eager", "eager", "grouped")):
    """s/step of each of `fns` ({name: a call that runs k steps}) in
    `turns`; host clock around each synchronised call."""
    secs = {name: [] for name in fns}
    for name in turns:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fns[name]()
        torch.cuda.synchronize()
        secs[name].append((time.perf_counter() - t0) / k)
    return secs


def train_group(torch, rt, data, card, out_dir, ctx0, k=4):
    """steps_per_call on the SD-1.5 step: optimize_embedding with
    steps_per_call=k over 2 fill steps and one group of k cached steps (its
    launches counted inside the capture: one cached step's); k grouped
    against k eager steps from one state; grouped and eager s/step in
    turns with each one's busy share; a profile of one replay."""
    import numpy as np

    cfg = rt.cfg
    log_dir = os.path.join(out_dir, "train_group")
    os.makedirs(log_dir, exist_ok=True)
    if os.path.exists(os.path.join(log_dir, "metrics.jsonl")):
        os.remove(os.path.join(log_dir, "metrics.jsonl"))
    from stablekeypoints_tpu_torch.pipeline.optimize import optimize_embedding
    from stablekeypoints_tpu_torch.utils.logging import MetricsLogger

    calls = []
    scan = rt.train_step_scan
    rt.train_step_scan = lambda *a, **kw: calls.append(len(a[2])) or scan(*a, **kw)
    per_capture = []
    logger = MetricsLogger(log_dir)
    rt.cfg = dataclasses.replace(cfg, num_steps=2 + k, steps_per_call=k, log_every=1)
    try:
        with counting_captures(per_capture):
            t0 = time.time()
            learned = optimize_embedding(rt, data, logger, context=ctx0,
                                         generator=torch.Generator(device=rt.device).manual_seed(9))
            torch.cuda.synchronize()
            run_s = time.time() - t0
    finally:
        rt.cfg = cfg
        logger.close()
        del rt.__dict__["train_step_scan"]
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        losses = [json.loads(line)["loss"] for line in f if '"loss"' in line]
    assert calls == [k], f"train_step_scan calls {calls}, expected one group of {k}"
    assert len(losses) == 2 + k and all(np.isfinite(losses)), losses
    assert torch.isfinite(learned).all() and (learned - ctx0).abs().max().item() > 0
    check_capture("train", per_capture, PER_STEP)
    print(f"[train] optimize_embedding, steps_per_call {k}: 2 fill steps, then one group of {k} "
          f"cached steps (its first the graph's warm-up) in {run_s:.2f} s; losses "
          f"{[round(x, 6) for x in losses]} | {card}", flush=True)

    lat_k, img_k = group_inputs(torch, rt, data, k)
    (ctx_e, opt_e, gen_e), (ctx_g, opt_g, gen_g), checks = grouped_vs_eager(
        torch, rt, lat_k, img_k, card, "train")

    def grouped():
        rt.train_step_scan(ctx_g, opt_g, lat_k, img_k, generator=gen_g)

    def eager():
        for j in range(k):
            rt.train_step_cached(ctx_e, opt_e, lat_k[j], img_k[j], generator=gen_e)

    secs = timed_turns(torch, k, {"grouped": grouped, "eager": eager})
    s_g, s_e = (float(np.mean(secs[n])) for n in ("grouped", "eager"))
    print(f"[train] SD-1.5 512^2 batch 4 cached steps, in turns (grouped, eager, eager, grouped): "
          f"grouped {s_g:.4f} s/step {[round(x, 4) for x in secs['grouped']]}, eager "
          f"{s_e:.4f} s/step {[round(x, 4) for x in secs['eager']]} | {card}", flush=True)
    prof_g = profile_call(torch, grouped, f"one group of {k} replays", out_dir,
                          "profile_train_group.txt", card, s_g * k * 1e3)
    prof_e = profile_call(torch, eager, f"{k} eager cached steps", out_dir,
                          "profile_train_eager4.txt", card, s_e * k * 1e3)
    one = lambda: rt.train_step_scan(ctx_g, opt_g, lat_k[:1], img_k[:1], generator=gen_g)  # noqa: E731
    one_s = timed_turns(torch, 1, {"replay": one}, turns=("replay", "replay"))["replay"]
    prof_1 = profile_call(torch, one, "one replay (a group of 1)", out_dir,
                          "profile_train_replay.txt", card, float(np.mean(one_s)) * 1e3)
    for prof in (prof_g, prof_1):
        assert prof is None or any("capture_bwd_kernel" in n for n in prof["names"]), \
            "the replay's profile shows no capture backward kernel"
    del ctx_e, opt_e, ctx_g, opt_g, lat_k, img_k
    rt._step_graphs.clear()
    torch.cuda.empty_cache()
    return dict(launches_in_capture=per_capture[0], losses=losses, run_s=run_s, checks=checks,
                s_per_step_grouped=s_g, s_per_step_eager=s_e, secs=secs, replay_s=one_s,
                profile_grouped=prof_g, profile_eager=prof_e, profile_replay=prof_1)


def remat_check(torch, rt, data, card, out_dir, k=4):
    """remat on (Runtime.create(Config(remat="on")), the same seeded
    weights) against the runtime's remat off: the launches of one cached
    step (PER_STEP_REMAT), each step's peak memory, s/step in turns, and a
    group of k through a graph (its launches inside the capture)."""
    import numpy as np

    from stablekeypoints_tpu_torch.pipeline.runtime import Runtime

    rt_r = Runtime.create(dataclasses.replace(rt.cfg, remat="on"))
    assert rt_r.unet.config.remat and not rt.unet.config.remat
    lat_k, img_k = group_inputs(torch, rt, data, k)
    out = {}
    states = {}
    for name, r in (("off", rt), ("on", rt_r)):
        ctx = r.train_context(r.init_context())
        opt = r.optimizer(ctx)
        gen = torch.Generator(device=r.device).manual_seed(12)
        r.train_step_cached(ctx, opt, lat_k[0], img_k[0], generator=gen)  # warm-up
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        count = reset_counts()
        r.train_step_cached(ctx, opt, lat_k[1], img_k[1], generator=gen)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launches = check_counts(f"train remat {name}", count,
                                PER_STEP_REMAT if name == "on" else PER_STEP, 1, "cached step")
        out[name] = dict(peak_gib=peak / 2**30, step_gib=(peak - base) / 2**30, launches=launches)
        states[name] = (r, ctx, opt, gen)
        print(f"[train] remat {name}: a cached step's peak device memory {peak / 2**30:.2f} GiB, "
              f"{(peak - base) / 2**30:.2f} GiB above what was allocated before it | {card}",
              flush=True)

    def steps(name):
        r, ctx, opt, gen = states[name]
        return lambda: [r.train_step_cached(ctx, opt, lat_k[j], img_k[j], generator=gen)
                        for j in range(2)]

    secs = timed_turns(torch, 2, {"off": steps("off"), "on": steps("on")},
                       turns=("off", "on", "on", "off"))
    s_off, s_on = float(np.mean(secs["off"])), float(np.mean(secs["on"]))
    print(f"[train] remat off {s_off:.4f} s/step {[round(x, 4) for x in secs['off']]}, on "
          f"{s_on:.4f} s/step {[round(x, 4) for x in secs['on']]} (eager cached steps, in "
          f"turns off, on, on, off) | {card}", flush=True)
    r, ctx, opt, gen = states["on"]
    per_capture = []
    with counting_captures(per_capture):
        r.train_step_scan(ctx, opt, lat_k, img_k, generator=gen)  # warm-up, capture, replays
    check_capture("train remat on", per_capture, PER_STEP_REMAT)
    grouped = timed_turns(torch, k, {"grouped": lambda: r.train_step_scan(
        ctx, opt, lat_k, img_k, generator=gen)}, turns=("grouped", "grouped"))["grouped"]
    print(f"[train] remat on, grouped: {float(np.mean(grouped)):.4f} s/step "
          f"{[round(x, 4) for x in grouped]} | {card}", flush=True)
    out.update(s_per_step_off=s_off, s_per_step_on=s_on, secs=secs,
               launches_in_capture=per_capture[0], s_per_step_on_grouped=float(np.mean(grouped)))
    del states, ctx, opt, r, rt_r
    torch.cuda.empty_cache()
    return out


def precise_step(torch, rt, data, card, tag, per_step, remat):
    """One step through Runtime.create(Config(capture_fp32_bwd=True[,
    remat="on"])) (the same seeded weights): its launches against
    `per_step`, a finite loss, and its context gradient against the
    runtime's default step on the same inputs (within 5e-2 of the largest
    magnitude, cosine >= 0.99: only dsim's rounding differs)."""
    import numpy as np

    from stablekeypoints_tpu_torch.ops.transforms import sample_thetas
    from stablekeypoints_tpu_torch.pipeline.runtime import Runtime

    cfg = dataclasses.replace(rt.cfg, capture_fp32_bwd=True, **({"remat": "on"} if remat else {}))
    rt_p = Runtime.create(cfg)
    b = cfg.batch_size
    images = torch.from_numpy(np.stack([data[i]["img"] for i in range(b)])).to(rt.device)
    gen = torch.Generator(device=rt.device).manual_seed(8)
    thetas = sample_thetas(gen, b, rt.aff)
    noise = torch.randn(rt.latent_shape(2 * b, cfg.image_size), generator=gen, device=rt.device)
    ctx0 = rt.init_context()
    results = {}
    for name, r in (("default", rt), ("precise", rt_p)):
        context = r.train_context(ctx0)
        count = reset_counts()
        _, _, aux = r.train_step(context, r.optimizer(context), images, thetas=thetas,
                                 noise=noise)
        torch.cuda.synchronize()
        launches = launches_now(count)
        results[name] = (context.grad.clone(), aux["loss"].item(), launches)
    g_d, loss_d, _ = results["default"]
    g_p, loss_p, launches = results["precise"]
    label = "capture_fp32_bwd" + (" remat on" if remat else "")
    check_launches(label, launches, per_step, 1, "step", phase=tag)
    rel = ((g_p - g_d).abs().max() / g_d.abs().max()).item()
    cos = torch.nn.functional.cosine_similarity(g_p.flatten(), g_d.flatten(), dim=0).item()
    print(f"[{tag}] one step with capture_fp32_bwd{' and remat on' if remat else ''}: loss "
          f"{loss_p:.6f} (default {loss_d:.6f}); context gradient against the default step's: "
          f"max abs err / max {rel:.3e} (tol 5e-2), cosine {cos:.6f} (tol >= 0.99) | {card}",
          flush=True)
    assert np.isfinite(loss_p) and torch.isfinite(g_p).all() and rel <= 5e-2 and cos >= 0.99
    del rt_p
    return launches, dict(rel_err=rel, cosine=cos, loss=loss_p, loss_default=loss_d)


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


def check_launches(tag, launches, per, units, unit_name, phase="cli"):
    """As check_counts, for a snapshot of the counts, with one line of output."""
    for name, n in launches.items():
        assert n == per[name] * units, f"{tag} {name}: {n} launches, expected {per[name]} x {units}"
    print(f"[{phase}] {tag}: launches as expected, {units} x per {unit_name} "
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


# a world-2 rank on the one card over gloo (argv: repo, rank, port, inputs
# .pt, output .pt): the SD-1.5 runtime from the seed, one cached step from
# the given state, a vote batch and a stage-3 chunk, gathered in rank order
PARALLEL_CHILD = r"""
import datetime, json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
rank, port, inputs, output = int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
t0 = time.time()
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=600))
try:
    from stablekeypoints_tpu_torch.config import Config
    from stablekeypoints_tpu_torch.kernels import attn_capture
    from stablekeypoints_tpu_torch.parallel.mesh import make_mesh
    from stablekeypoints_tpu_torch.pipeline.runtime import Runtime
    mesh = make_mesh(2, device="cuda:0")  # two ranks share the card: named
    rt = Runtime.create(Config(), mesh=mesh)
    torch.cuda.synchronize()
    create_s = time.time() - t0
    x = torch.load(inputs, weights_only=True)
    calls = {}
    for name in ("all_reduce", "all_gather", "broadcast"):
        def counted(*a, _fn=getattr(dist, name), _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        setattr(dist, name, counted)
    lat = x["latents"][mesh.rows(x["images"].shape[0])].to(mesh.device)
    out = {}
    torch.cuda.reset_peak_memory_stats()
    for turn in range(2):  # the first builds and plans; the second is timed
        ctx = rt.train_context(x["ctx"])
        opt = rt.optimizer(ctx)
        calls.clear()
        attn_capture.capture_attention_fused_bwd.launches = 0
        torch.cuda.synchronize()
        t1 = time.time()
        _, _, aux = rt.train_step_cached(ctx, opt, lat, x["images"], thetas=x["thetas"],
                                         noise=x["noise"])
        torch.cuda.synchronize()
        step_s = time.time() - t1
    out.update(grad=ctx.grad.cpu(), context=ctx.detach().cpu(),
               aux={k: float(v) for k, v in aux.items()})
    step_calls = dict(calls)
    k1_bwd = attn_capture.capture_attention_fused_bwd.launches
    group_raises = None  # a steps_per_call group cannot capture gloo's all-reduce: it raises
    if mesh.device.type == "cuda":
        try:
            rt.train_step_scan(ctx, opt, lat[None], x["images"][None], thetas=x["thetas"][None],
                               noise=x["noise"][None])
            group_raises = False
        except RuntimeError:
            group_raises = True
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    out["select"] = rt.select_indices(x["ctx"], x["images"], noise=x["vote_noise"]).cpu()
    out["keypoints"] = rt.augmented_keypoints(x["ctx"], x["images"], x["indices"],
                                              thetas=x["ens_thetas"], noise=x["ens_noise"]).cpu()
    if rank == 0:
        torch.save(out, output)
    print(json.dumps({"rank": rank, "create_s": create_s, "step_s": step_s,
                      "collectives_per_step": step_calls, "k1_bwd_per_step": k1_bwd,
                      "peak_gib": peak_gib, "gloo_group_raises": group_raises}), flush=True)
finally:
    dist.destroy_process_group()
"""


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def nccl_kernels(torch, fn):
    """{kernel name: launches} of the NCCL kernels one call of `fn` runs on
    the device (torch.profiler; a one-rank NCCL average is its oneRankReduce
    kernel)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    found = {}
    for e in prof.key_averages():
        # "nccl:all_reduce" is torch's annotation of the call on the device's
        # timeline, not a kernel
        if (e.device_type == torch.autograd.DeviceType.CUDA and not e.key.startswith("nccl:")
                and any(m in e.key.lower() for m in ("nccl", "onerank"))):
            found[e.key] = found.get(e.key, 0) + e.count
    return found


def phase_parallel(torch, rt, card, out_dir, k=4):
    """Data parallel (parallel/mesh.py) on the phase's SD-1.5 512^2 runtime:
    world 1 over NCCL (the production backend) in this process: a fill and
    a cached step through the mesh path (launches per step = [train]'s, one
    all_reduce call and one NCCL kernel a step), a group of k replays with
    the all-reduce inside the graph (launches counted at capture), one step
    from one state against the non-mesh step, grouped s/step against the
    non-mesh group in turns, peak memory; then world 2 over gloo on the one
    card (two processes, batch 2 each): the averaged gradient of one step
    against the world-1 batch-4 step, a vote batch and a stage-3 chunk
    gathered against world 1's; the native JPEG decoder's availability and
    its host decode time against PIL's."""
    import numpy as np
    import torch.distributed as dist

    from stablekeypoints_tpu_torch.data.synthetic import SyntheticBlobs
    from stablekeypoints_tpu_torch.parallel.mesh import destroy_group, make_mesh
    from stablekeypoints_tpu_torch.pipeline.runtime import Runtime

    cfg = rt.cfg
    data = SyntheticBlobs(length=8, image_size=cfg.image_size)
    images = np.stack([data[i]["img"] for i in range(cfg.batch_size)])
    res = {}
    t0 = time.time()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(1)
        prt = Runtime(cfg, rt.unet, rt.vae, rt.schedule, mesh.device, mesh)
        ctx0 = prt.init_context()  # a broadcast from rank 0
        print(f"[parallel] world 1 over {dist.get_backend()} on {mesh.device}: group and mesh "
              f"{time.time() - t0:.2f} s", flush=True)
        calls = []
        all_reduce = dist.all_reduce
        dist.all_reduce = lambda *a, **kw: calls.append(1) or all_reduce(*a, **kw)
        try:
            context = prt.train_context(ctx0)
            opt = prt.optimizer(context)
            gen = torch.Generator(device=prt.device).manual_seed(5)
            lat = prt.train_step_fill(context, opt, images, generator=gen)[3]  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            count = reset_counts()
            calls.clear()
            secs = {}
            for kind in ("fill", "cached"):
                t1 = time.time()
                if kind == "fill":
                    lat = prt.train_step_fill(context, opt, images, generator=gen)[3]
                else:
                    prt.train_step_cached(context, opt, lat, images, generator=gen)
                torch.cuda.synchronize()
                secs[kind] = time.time() - t1
            launches = check_counts("parallel", count, PER_STEP, 2, "step")
            assert len(calls) == 2, f"{len(calls)} all_reduce calls in 2 steps, expected 2"
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            nccl_eager = nccl_kernels(torch, lambda: prt.train_step_cached(
                context, opt, lat, images, generator=gen))
            print(f"[parallel] world 1 NCCL: fill {secs['fill']:.4f} s, cached "
                  f"{secs['cached']:.4f} s (eager, host clock); one all_reduce call a step; "
                  f"NCCL kernels in one eager cached step: {nccl_eager}; peak memory "
                  f"{peak_gib:.2f} GiB per rank | {card}", flush=True)
            assert sum(nccl_eager.values()) == 1, nccl_eager

            # one step from one state, through the mesh and without it
            states = []
            for r in (rt, prt):
                c = r.train_context(ctx0)
                o = r.optimizer(c)
                r.train_step_cached(c, o, lat, images,
                                    generator=torch.Generator(device=r.device).manual_seed(8))
                states.append(c)
            torch.cuda.synchronize()
            d1 = _distance(states[1], states[0])
            g_rel = ((states[1].grad - states[0].grad).abs().max()
                     / states[0].grad.abs().max()).item()
            g_cos = torch.nn.functional.cosine_similarity(
                states[1].grad.flatten(), states[0].grad.flatten(), dim=0).item()
            one_ok = d1 <= 1e-3 and g_rel <= 5e-2 and g_cos >= 0.999
            print(f"[parallel] one mesh step vs one non-mesh step from one state: |context "
                  f"diff| / |context| {d1:.3e} (tol 1e-3), gradient max abs err / max "
                  f"{g_rel:.3e} (tol 5e-2), cosine {g_cos:.6f} (tol >= 0.999): "
                  f"{'OK' if one_ok else 'FAIL'} | {card}", flush=True)
            assert one_ok, (d1, g_rel, g_cos)
            del states

            # a group of k with the all-reduce inside the graph
            lat_k, img_k = group_inputs(torch, prt, data, k)
            per_capture = []
            calls.clear()
            runs = {}
            for name, r in (("mesh", prt), ("plain", rt)):
                c = r.train_context(ctx0)
                runs[name] = (r, c, r.optimizer(c),
                              torch.Generator(device=r.device).manual_seed(9))
            r, c, o, g = runs["mesh"]
            with counting_captures(per_capture):
                aux = r.train_step_scan(c, o, lat_k, img_k, generator=g)[2]
            torch.cuda.synchronize()
            check_capture("parallel", per_capture, PER_STEP)
            # on the card the warm-up step's call and the capture's (the replays
            # call no Python); a CPU rehearsal runs the k steps eagerly
            eager = prt.device.type != "cuda"
            assert len(calls) == (k if eager else 2), f"{len(calls)} all_reduce calls in a new group"
            assert all(np.isfinite(aux["loss"].tolist())), aux

            def group(name):
                r, c, o, g = runs[name]
                return lambda: r.train_step_scan(c, o, lat_k, img_k, generator=g)

            group("plain")()  # the non-mesh graph's warm-up and capture
            calls.clear()
            nccl_group = nccl_kernels(torch, group("mesh"))
            assert len(calls) == (k if eager else 0), "a replay called all_reduce from Python"
            print(f"[parallel] a group of {k} replays: NCCL kernels {nccl_group} = "
                  f"{sum(nccl_group.values()) / k:g} a step (expected 1) | {card}", flush=True)
            assert sum(nccl_group.values()) == k, nccl_group
            turns = timed_turns(torch, k, {"mesh": group("mesh"), "plain": group("plain")},
                                turns=("mesh", "plain", "plain", "mesh"))
            s_mesh, s_plain = (float(np.mean(turns[n])) for n in ("mesh", "plain"))
            print(f"[parallel] grouped cached steps (k={k}), in turns: world 1 NCCL "
                  f"{s_mesh:.4f} s/step {[round(x, 4) for x in turns['mesh']]}, [train]'s "
                  f"non-mesh group {s_plain:.4f} s/step {[round(x, 4) for x in turns['plain']]} "
                  f"| {card}", flush=True)
            del runs, lat_k, img_k
            prt._step_graphs.clear()
            rt._step_graphs.clear()
        finally:
            dist.all_reduce = all_reduce
        res.update(launches=launches, secs=secs, peak_gib=peak_gib, nccl_eager=nccl_eager,
                   nccl_group=nccl_group, one_step=dict(context=d1, grad_rel=g_rel, cos=g_cos),
                   s_per_step_grouped=s_mesh, s_per_step_grouped_plain=s_plain, turns=turns)
    finally:
        destroy_group()
    torch.cuda.empty_cache()
    res["world2"] = world2_gloo(torch, rt, data, images, lat, card)
    res["native"] = native_decode(np, card)
    return res


def world2_gloo(torch, rt, data, images, lat, card):
    """Two ranks on the one card over gloo, batch 2 each, against this
    process's world-1 batch-4 runtime on the same inputs."""
    import numpy as np

    cfg = rt.cfg
    gen = torch.Generator(device="cpu").manual_seed(12)
    b, n = images.shape[0], cfg.augmentation_iterations
    size = cfg.image_size
    x = dict(ctx=rt.init_context().cpu(), images=torch.from_numpy(images), latents=lat.cpu(),
             thetas=_thetas(torch, rt, gen, b), noise=torch.randn((2 * b, size // 8, size // 8, 4),
                                                                  generator=gen),
             vote_noise=torch.randn((b, size // 8, size // 8, 4), generator=gen),
             indices=torch.arange(cfg.top_k), ens_thetas=_thetas(torch, rt, gen, b * n),
             ens_noise=torch.randn((b * n, size // 8, size // 8, 4), generator=gen))
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="parallel_", dir=os.path.join(REPO, "build"))
    try:
        torch.save(x, os.path.join(root, "inputs.pt"))
        port = free_port()
        t0 = time.time()
        procs = [subprocess.Popen(
            [sys.executable, "-c", PARALLEL_CHILD, REPO, str(r), str(port),
             os.path.join(root, "inputs.pt"), os.path.join(root, "out.pt")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)
            for r in range(2)]
        try:
            outs = [p.communicate(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.time() - t0
        for r, (p, (out, err)) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"world-2 rank {r} failed (rc {p.returncode}):\n{err[-4000:]}"
        ranks = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
        got = torch.load(os.path.join(root, "out.pt"), weights_only=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for r in ranks:
        print(f"[parallel] world 2 gloo rank {r['rank']} on cuda:0: runtime {r['create_s']:.1f} s, "
              f"a cached step (batch 2 of 4) {r['step_s']:.4f} s, collectives a step "
              f"{r['collectives_per_step']}, K1 bwd launches a step {r['k1_bwd_per_step']}, "
              f"peak memory {r['peak_gib']:.2f} GiB; a steps_per_call group under gloo "
              f"raises: {r['gloo_group_raises']} | {card}", flush=True)
        assert r["collectives_per_step"] == {"all_reduce": 1}, r
        assert r["gloo_group_raises"] is not False, "a group under gloo ran eager steps"
        assert r["k1_bwd_per_step"] == PER_STEP["capture_bwd"], r

    # world 1 on the same inputs: the batch of 4 twice (the second run is the
    # kernels' own spread), and its two halves as the two ranks split it
    def world1(rows):
        c = rt.train_context(x["ctx"])
        o = rt.optimizer(c)
        noise = torch.cat([x["noise"][rows], x["noise"][b + rows.start:b + rows.stop]])
        aux = rt.train_step_cached(c, o, lat[rows], images[rows], thetas=x["thetas"][rows],
                                   noise=noise)[2]
        return c.detach().cpu(), c.grad.cpu(), float(aux["loss"])

    (c1, g1, loss1), (c1b, g1b, _) = world1(slice(0, b)), world1(slice(0, b))
    halves = [world1(slice(0, b // 2)), world1(slice(b // 2, b))]
    g_half = (halves[0][1] + halves[1][1]) / 2

    def rel(g, ref):
        return ((g - ref).abs().max() / ref.abs().max()).item()

    def cos(g, ref):
        return torch.nn.functional.cosine_similarity(g.flatten(), ref.flatten(), dim=0).item()

    g_rel, g_cos, g_spread = rel(got["grad"], g1), cos(got["grad"], g1), rel(g1b, g1)
    h_rel, h_cos = rel(got["grad"], g_half), cos(got["grad"], g_half)
    gap_rel, gap_cos = rel(g_half, g1), cos(g_half, g1)
    d_ctx, d_spread = _distance(got["context"], c1), _distance(c1b, c1)
    loss_rel = abs(got["aux"]["loss"] - loss1) / abs(loss1)
    # the mesh against what it computes: world 1's two halves averaged
    half_ok = h_rel <= 5e-2 and h_cos >= 0.999
    # against the batch of 4: as close as world 1's own halves are to it
    ok = (half_ok and loss_rel <= 1e-3 and d_ctx <= 1e-3
          and g_rel <= gap_rel + 5e-2 and g_cos >= gap_cos - 1e-3)
    print(f"[parallel] world 2 (gloo, batch 2 a rank) one step from one state: the averaged "
          f"gradient vs world 1's two batch-2 halves averaged: max abs err / max {h_rel:.3e} (tol "
          f"5e-2, [train]'s replay tolerance: dq sums in no fixed order), cosine {h_cos:.6f} (tol "
          f">= 0.999); vs world 1's batch 4: max abs err / max {g_rel:.3e}, cosine {g_cos:.6f} "
          f"(tol: world 1's halves vs its batch 4, {gap_rel:.3e} + 5e-2 and cosine {gap_cos:.6f} "
          f"- 1e-3: the bf16 maps of a merged batch of 4 and of 8 round differently, and where "
          f"an image's token selection turns, its gradient lands on another token; two batch-4 "
          f"runs {g_spread:.3e}), |context diff| / |context| {d_ctx:.3e} (tol 1e-3; two runs "
          f"{d_spread:.3e}), loss {got['aux']['loss']:.6f} vs {loss1:.6f} (tol 1e-3 relative): "
          f"{'OK' if ok else 'FAIL'} | {card}", flush=True)
    assert ok, (h_rel, h_cos, g_rel, g_cos, gap_rel, gap_cos, d_ctx, loss_rel)

    sel1 = rt.select_indices(x["ctx"], images, noise=x["vote_noise"]).cpu()
    sel_halves = torch.cat([rt.select_indices(x["ctx"], images[h], noise=x["vote_noise"][h]).cpu()
                            for h in (slice(0, b // 2), slice(b // 2, b))])
    kp1 = rt.augmented_keypoints(x["ctx"], images, x["indices"], thetas=x["ens_thetas"],
                                 noise=x["ens_noise"]).cpu()
    sel_diff = int((got["select"] != sel1).sum())
    sel_halves_diff = int((got["select"] != sel_halves).sum())
    kp = got["keypoints"]
    assert kp.shape == kp1.shape and torch.isfinite(kp).all(), (kp.shape, kp1.shape)
    off = int(((kp - kp1).abs() * size).max(dim=-1).values.gt(0).sum())
    worst_px128 = float((kp - kp1).abs().max() * 128)
    print(f"[parallel] world 2 vs world 1, gathered: vote batch of {b}: {sel_diff} of "
          f"{sel1.numel()} selected tokens differ from world 1's batch of {b} (the bf16 maps of "
          f"other batch shapes), {sel_halves_diff} from world 1's two halves (tol 0); stage-3 chunk of {b} images x {n} views: "
          f"{off} of {kp.shape[0] * kp.shape[1]} keypoints off by any pixel, the worst "
          f"{worst_px128:.3f} pixels of the 128^2 map (tol 1) | {card}", flush=True)
    assert got["select"].shape == sel1.shape and sel_halves_diff == 0, sel_halves_diff
    assert all(len(set(row.tolist())) == cfg.top_k for row in got["select"])
    assert worst_px128 <= 1.0, worst_px128
    return dict(ranks=ranks, wall_s=wall, grad_rel=g_rel, grad_cos=g_cos, grad_spread=g_spread,
                halves_rel=h_rel, halves_cos=h_cos, gap_rel=gap_rel, gap_cos=gap_cos,
                context=d_ctx, context_spread=d_spread, loss=got["aux"]["loss"],
                loss_world1=loss1, select_diff=sel_diff, select_halves_diff=sel_halves_diff,
                keypoints_off=off,
                worst_px128=worst_px128)


def step_maps(torch, r, images, thetas, noise, context):
    """The fill step's merged forward on given draws: the maps [2b, T, R, R]
    of [originals; warped] (no grad unless `context` requires it)."""
    from stablekeypoints_tpu_torch.ops.transforms import apply_affine

    images, thetas = images.to(r.device), thetas.to(r.device)
    both = torch.cat([images, apply_affine(images, thetas)])
    return r._attn_maps(both, context, noise.to(r.device), -1, None, True,
                        latents=r._encode(both))


def chosen_tokens(torch, r, maps, b):
    """Per image: the tokens a step selects from `maps` (candidates of the
    original's maps, furthest-point sampling on the warped one's), and
    Gaussian targets at their peaks: gradient_check's fixed loss."""
    from stablekeypoints_tpu_torch.ops.gaussians import gaussian_circles
    from stablekeypoints_tpu_torch.ops.keypoints import find_k_max_pixels
    from stablekeypoints_tpu_torch.ops.selection import furthest_point_sampling, select_candidates

    cfg, out = r.cfg, []
    for i in range(b):
        cands = select_candidates(maps[i], cfg.top_k_strategy, cfg.furthest_point_num_samples,
                                  sigma=cfg.sigma, num_subjects=cfg.num_subjects)
        idx = furthest_point_sampling(maps[b + i], cfg.top_k, cands)
        pos = find_k_max_pixels(maps[i][idx], num=cfg.num_subjects) / maps.shape[-1]
        out.append((idx.cpu(), gaussian_circles(pos, maps.shape[-1], cfg.sigma).cpu()))
    return out


def fixed_loss_grad(torch, r, images, thetas, noise, ctx0, chosen):
    """(context gradient, value) of gradient_check's fixed loss on `chosen`
    tokens and targets, through the fill step's forward of `r`: one function
    on both sides of a comparison, whatever each side's selection. On a rank
    of a 'model' axis the gradient is its heads' part: the parts are summed
    over the model group here, as the training step's all-reduce sums them."""
    import torch.distributed as dist

    from stablekeypoints_tpu_torch.ops.losses import equivariance_loss

    cfg, b = r.cfg, len(chosen)
    context = r.train_context(ctx0)
    maps = step_maps(torch, r, images, thetas, noise, context)
    th = thetas.to(r.device)
    sl = torch.stack([((maps[i][idx.to(r.device)] - target.to(r.device)) ** 2).mean()
                      for i, (idx, target) in enumerate(chosen)]).mean()
    el = torch.stack([equivariance_loss(maps[i][idx.to(r.device)], maps[b + i][idx.to(r.device)],
                                        th[i]) for i, (idx, _) in enumerate(chosen)]).mean()
    loss = sl * cfg.sharpening_loss_weight + el * cfg.equivariance_attn_loss_weight
    (g,) = torch.autograd.grad(loss, context)
    if r.mesh.model_group is not None:
        dist.all_reduce(g, group=r.mesh.model_group)
    return g.cpu(), loss.item()


def maps_at(maps, chosen, b):
    """The maps of the originals and the warped images at `chosen` tokens."""
    import torch

    return torch.stack([maps[j * b + i][idx.to(maps.device)] for j in (0, 1)
                        for i, (idx, _) in enumerate(chosen)]).cpu()


TENSOR_CHILD = r"""
import dataclasses, datetime, json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import torch.distributed as dist
rank, port, inputs, out_path = int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=600))
try:
    import chip_smoke as cs
    from stablekeypoints_tpu_torch.api import KeypointModel
    from stablekeypoints_tpu_torch.config import Config
    from stablekeypoints_tpu_torch.parallel import tensor as ptensor
    from stablekeypoints_tpu_torch.parallel.mesh import make_mesh
    from stablekeypoints_tpu_torch.pipeline.runtime import Runtime
    mesh = make_mesh(1, 2, device="cuda:0")  # two ranks share the card: named
    x = torch.load(inputs, weights_only=True)
    calls = {}
    all_reduce = dist.all_reduce
    def counted(*a, **k):
        key = "world" if k.get("group") in (None, dist.group.WORLD) else "model"
        calls[key] = calls.get(key, 0) + 1
        return all_reduce(*a, **k)
    dist.all_reduce = counted
    out, info = {}, {"rank": rank}

    def plan_bytes(rt):
        # the plan's slices of the whole UNet, each in its parameter's dtype
        cfg = rt.unet.config
        plan, full = ptensor.split_plan(cfg, 2), ptensor.full_unet_shapes(cfg)
        size = {n: p.element_size() for n, p in rt.unet.named_parameters()}
        n = 0
        for name, shape in full.items():
            part = ptensor.take_slice(torch.empty(shape, device="meta"), plan[name], rank, 2)
            n += part.numel() * size[name]
        got = sum(p.numel() * p.element_size() for p in rt.unet.parameters())
        return got, n

    def step(rt, kind, ctx0, **kw):
        # one step from ctx0: (grad, loss, context, latents, launches, calls, model all-reduces, s)
        c = rt.train_context(ctx0)
        o = rt.optimizer(c)
        count = cs.reset_counts()
        calls.clear()
        before = dict(ptensor.all_reduce_counts)
        torch.cuda.synchronize()
        t0 = time.time()
        res = getattr(rt, "train_step_" + kind)(c, o, **kw)
        torch.cuda.synchronize()
        secs = time.time() - t0
        model = {k: ptensor.all_reduce_counts[k] - before[k] for k in before}
        lat = res[3] if kind == "fill" else None
        return dict(grad=c.grad.cpu(), loss=float(res[2]["loss"]), context=c.detach().cpu(),
                    latents=None if lat is None else lat.cpu(), launches=cs.launches_now(count),
                    calls=dict(calls), model=model, secs=secs)

    # SD-1.5 512^2, batch 4: this rank's slices of the seed's weights
    t0 = time.time()
    rt = Runtime.create(Config(), mesh=mesh)
    torch.cuda.synchronize()
    info["create_s"] = time.time() - t0
    info["bytes"], info["plan_bytes"] = plan_bytes(rt)
    torch.cuda.reset_peak_memory_stats()
    s = x["sd"]
    runs = {}
    for turn in range(2):  # the second is timed and counted
        runs["fill"] = step(rt, "fill", s["ctx"], images=s["images"], thetas=s["thetas"],
                            noise=s["noise"])
        runs["cached"] = step(rt, "cached", s["ctx"], latents=s["latents"], images=s["images"],
                              thetas=s["thetas_c"], noise=s["noise_c"])
    info["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    # the step's maps at the one-process selection, this rank's own selection,
    # and the fixed loss's gradient on the one-process selection
    with torch.no_grad():
        maps = cs.step_maps(torch, rt, s["images"], s["thetas"], s["noise"],
                            s["ctx"].to(rt.device))
    b = s["images"].shape[0]
    fixed = dict(maps=cs.maps_at(maps, s["chosen"], b),
                 selected=[idx for idx, _ in cs.chosen_tokens(torch, rt, maps, b)])
    del maps
    fixed["grad"], fixed["loss"] = cs.fixed_loss_grad(torch, rt, s["images"], s["thetas"],
                                                      s["noise"], s["ctx"], s["chosen"])
    # the 96^2 capture grid: K2 at this rank's heads
    rt96 = Runtime(dataclasses.replace(rt.cfg, feature_upsample_res=96), rt.unet, rt.vae,
                   rt.schedule, rt.device, mesh)
    r96 = step(rt96, "cached", s["ctx"], latents=s["latents"], images=s["images"],
               thetas=s["thetas_c"], noise=s["noise_c"])
    # one forward: the vote batch
    before = dict(ptensor.all_reduce_counts)
    calls.clear()
    sel = rt.select_indices(s["ctx"], s["images"], noise=s["noise_c"][:4])
    info["vote_model"] = {k: ptensor.all_reduce_counts[k] - before[k] for k in before}
    info["vote_calls"] = dict(calls)
    out["sd"] = {k: {n: v for n, v in r.items() if n in ("grad", "loss", "context", "latents")}
                 for k, r in runs.items()}
    out["sd"]["select"] = sel.cpu()
    out["sd"]["fixed"] = fixed
    out["sd"]["grad96_finite"] = bool(torch.isfinite(r96["grad"]).all())
    info["sd"] = {k: {n: v for n, v in r.items() if n in ("launches", "calls", "model", "secs")}
                  for k, r in dict(runs, cached96=r96).items()}
    del rt, rt96, runs
    torch.cuda.empty_cache()

    # SDXL 1024^2, batch 1
    t0 = time.time()
    xcfg = Config(model_type=cs.BACKBONES["sdxl"]["model_type"], image_size=1024, batch_size=1)
    xrt = Runtime.create(xcfg, mesh=mesh)
    torch.cuda.synchronize()
    info["sdxl_create_s"] = time.time() - t0
    info["sdxl_bytes"], info["sdxl_plan_bytes"] = plan_bytes(xrt)
    torch.cuda.reset_peak_memory_stats()
    s = x["sdxl"]
    r = step(xrt, "fill", s["ctx"], images=s["images"], thetas=s["thetas"], noise=s["noise"])
    info["sdxl_peak_gib_train"] = torch.cuda.max_memory_allocated() / 2**30
    out["sdxl"] = {n: r[n] for n in ("grad", "loss", "context")}
    with torch.no_grad():
        maps = cs.step_maps(torch, xrt, s["images"], s["thetas"], s["noise"],
                            s["ctx"].to(xrt.device))
    fixed = dict(maps=cs.maps_at(maps, s["chosen"], 1),
                 selected=[idx for idx, _ in cs.chosen_tokens(torch, xrt, maps, 1)])
    del maps
    fixed["grad"], fixed["loss"] = cs.fixed_loss_grad(torch, xrt, s["images"], s["thetas"],
                                                      s["noise"], s["ctx"], s["chosen"])
    out["sdxl"]["fixed"] = fixed
    info["sdxl"] = {"fill": {n: r[n] for n in ("launches", "calls", "model", "secs")}}
    del r
    # the ensembled maps of one image on 2 views (one pass), then an M=1 detect
    two = Runtime(dataclasses.replace(xcfg, augmentation_iterations=2, eval_views_per_pass=2),
                  xrt.unet, xrt.vae, xrt.schedule, xrt.device, mesh)
    with torch.inference_mode():
        maps = two._ensembled_maps(s["ctx"].to(xrt.device), s["images"][:1].to(xrt.device),
                                   torch.arange(xcfg.top_k, device=xrt.device),
                                   thetas=s["view_thetas"], noise=s["view_noise"])
    out["sdxl"]["maps"] = maps.cpu()
    model = KeypointModel(xrt, s["ctx"].numpy(), np.arange(xcfg.top_k))
    torch.cuda.reset_peak_memory_stats()
    count = cs.reset_counts()
    calls.clear()
    before = dict(ptensor.all_reduce_counts)
    torch.cuda.synchronize()
    t0 = time.time()
    pts = model.detect_batch(s["images"][:1].numpy())
    torch.cuda.synchronize()
    info["sdxl"]["detect"] = dict(secs=time.time() - t0, launches=cs.launches_now(count),
                                  passes=-(-xcfg.augmentation_iterations
                                           // xrt.views_per_pass(xcfg.augmentation_iterations)),
                                  calls=dict(calls),
                                  model={k: ptensor.all_reduce_counts[k] - before[k]
                                         for k in before})
    info["sdxl_peak_gib_detect"] = torch.cuda.max_memory_allocated() / 2**30
    out["sdxl"]["keypoints"] = torch.as_tensor(pts)
    dist.all_reduce = all_reduce
    if rank == 0:
        torch.save(out, out_path)
    print(json.dumps(info), flush=True)
finally:
    dist.destroy_process_group()
"""


def phase_tensor(torch, rt, card, out_dir):
    """Tensor parallel (parallel/tensor.py): the mesh (1, 2) over gloo, both
    ranks on the one card (two processes), each holding its Megatron slice
    of the UNet. SD-1.5 512^2 (the phase's runtime's seed weights), batch 4:
    a fill and a cached step from one state against this process's
    one-process steps on the same inputs (context gradient within 5e-2 of
    its max, cosine >= 0.99; loss within 1e-3), launches per step (each
    kernel at the rank's heads, as many as [train]'s), one world all_reduce
    a step and the model group's as predicted from the config, a step at a
    96^2 capture grid (K2 at 4 of 8 heads), one forward of the vote batch;
    SDXL 1024^2, batch 1: a fill step against the one-process step, the
    ensembled maps of 2 views against the one-process maps (5e-2 of their
    max), an M=1 detect (10 views) with its launches; per rank the UNet
    parameter bytes against the plan's count, peak memory, s/step and
    s/image (two ranks and gloo's host copies on one card: not a speed)."""
    import numpy as np

    from stablekeypoints_tpu_torch.config import Config
    from stablekeypoints_tpu_torch.data.synthetic import SyntheticBlobs
    from stablekeypoints_tpu_torch.parallel.tensor import predicted_all_reduces
    from stablekeypoints_tpu_torch.pipeline.runtime import Runtime

    t_phase = time.time()
    gen = torch.Generator(device="cpu").manual_seed(21)
    cfg = rt.cfg
    b, size = cfg.batch_size, cfg.image_size
    data = SyntheticBlobs(length=b, image_size=size)
    images = torch.from_numpy(np.stack([data[i]["img"] for i in range(b)]))

    def draws(v, s):
        return _thetas(torch, rt, gen, v), torch.randn((2 * v, s // 8, s // 8, 4), generator=gen)

    sd = dict(ctx=rt.init_context().cpu(), images=images)
    sd["thetas"], sd["noise"] = draws(b, size)
    sd["thetas_c"], sd["noise_c"] = draws(b, size)

    # the one-process steps on the same inputs, twice (the kernels' own spread)
    def one_step(r, kind, s, **kw):
        c = r.train_context(s["ctx"])
        res = getattr(r, "train_step_" + kind)(c, r.optimizer(c), **kw)
        torch.cuda.synchronize()
        return dict(grad=c.grad.cpu(), loss=float(res[2]["loss"]), context=c.detach().cpu(),
                    latents=res[3].cpu() if kind == "fill" else None)

    ref = {}
    for turn in range(2):
        ref[turn] = {"fill": one_step(rt, "fill", sd, images=images, thetas=sd["thetas"],
                                      noise=sd["noise"])}
        sd.setdefault("latents", ref[turn]["fill"]["latents"])
        ref[turn]["cached"] = one_step(rt, "cached", sd, latents=sd["latents"], images=images,
                                       thetas=sd["thetas_c"], noise=sd["noise_c"])
    sel1 = rt.select_indices(sd["ctx"], images, noise=sd["noise_c"][:b]).cpu()
    # the fixed loss (gradient_check's) on the one-process selection and targets
    # of the fill step's maps: one function on both sides
    with torch.no_grad():
        maps1 = step_maps(torch, rt, images, sd["thetas"], sd["noise"], sd["ctx"].to(rt.device))
    sd["chosen"] = chosen_tokens(torch, rt, maps1, b)
    ref_fixed = dict(maps=maps_at(maps1, sd["chosen"], b))
    del maps1
    ref_fixed["runs"] = [fixed_loss_grad(torch, rt, images, sd["thetas"], sd["noise"], sd["ctx"],
                                         sd["chosen"]) for _ in range(2)]

    # SDXL: the one-process runtime for the references, then freed
    bb = BACKBONES["sdxl"]
    xcfg = Config(model_type=bb["model_type"], image_size=bb["image_size"],
                  batch_size=bb["batch_size"])
    t0 = time.time()
    xrt = Runtime.create(xcfg)
    xconfig, xsize = xrt.unet.config, xcfg.image_size
    xdata = SyntheticBlobs(length=1, image_size=xsize)
    xs = dict(ctx=xrt.init_context().cpu(),
              images=torch.from_numpy(np.stack([xdata[0]["img"]])))
    xs["thetas"], xs["noise"] = draws(1, xsize)
    xs["view_thetas"] = _thetas(torch, rt, gen, 2)
    xs["view_noise"] = torch.randn((2, xsize // 8, xsize // 8, 4), generator=gen)
    xref = one_step(xrt, "fill", xs, images=xs["images"], thetas=xs["thetas"],
                    noise=xs["noise"])
    with torch.no_grad():
        maps1 = step_maps(torch, xrt, xs["images"], xs["thetas"], xs["noise"],
                          xs["ctx"].to(xrt.device))
    xs["chosen"] = chosen_tokens(torch, xrt, maps1, 1)
    xref_fixed = dict(maps=maps_at(maps1, xs["chosen"], 1))
    del maps1
    xref_fixed["runs"] = [fixed_loss_grad(torch, xrt, xs["images"], xs["thetas"], xs["noise"],
                                          xs["ctx"], xs["chosen"])]
    two = Runtime(dataclasses.replace(xcfg, augmentation_iterations=2, eval_views_per_pass=2),
                  xrt.unet, xrt.vae, xrt.schedule, xrt.device)
    with torch.inference_mode():
        xmaps = two._ensembled_maps(xs["ctx"].to(xrt.device), xs["images"][:1].to(xrt.device),
                                    torch.arange(xcfg.top_k, device=xrt.device),
                                    thetas=xs["view_thetas"], noise=xs["view_noise"]).cpu()
    del xrt, two
    torch.cuda.empty_cache()
    print(f"[tensor] one-process references (SD-1.5 steps twice, SDXL a step and 2-view maps): "
          f"{time.time() - t0:.1f} s of SDXL", flush=True)

    root = tempfile.mkdtemp(prefix="tensor_", dir=os.path.join(REPO, "build"))
    try:
        torch.save(dict(sd=sd, sdxl=xs), os.path.join(root, "inputs.pt"))
        port = free_port()
        t0 = time.time()
        procs = [subprocess.Popen(
            [sys.executable, "-c", TENSOR_CHILD, REPO, str(r), str(port),
             os.path.join(root, "inputs.pt"), os.path.join(root, "out.pt")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)
            for r in range(2)]
        try:
            outs = [p.communicate(timeout=900) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.time() - t0
        for r, (p, (out, err)) in enumerate(zip(procs, outs)):
            with open(os.path.join(out_dir, f"tensor_rank{r}.log"), "w") as f:
                f.write(out + "\n== stderr\n" + err)
            assert p.returncode == 0, f"(1, 2) rank {r} failed (rc {p.returncode}):\n{err[-4000:]}"
        ranks = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
        got = torch.load(os.path.join(root, "out.pt"), weights_only=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    def rel(g, want):
        return ((g - want).abs().max() / want.abs().max()).item()

    def cos(g, want):
        return torch.nn.functional.cosine_similarity(g.flatten().float(), want.flatten().float(),
                                                     dim=0).item()

    res = dict(wall_s=wall, ranks=ranks)
    # the model group's all-reduces predicted from the configs
    config = rt.unet.config
    pred = {"sd": predicted_all_reduces(config, 2, size // 8, cfg.feature_upsample_res,
                                        cfg.truncate_unet, grad=True),
            "sdxl": predicted_all_reduces(xconfig, 2, xsize // 8, xcfg.feature_upsample_res,
                                          xcfg.truncate_unet, grad=True)}
    vote_pred = predicted_all_reduces(config, 2, size // 8, cfg.feature_upsample_res, True)
    detect_pred = predicted_all_reduces(xconfig, 2, xsize // 8, xcfg.feature_upsample_res, True)
    res["predicted"] = dict(pred, vote=vote_pred, sdxl_detect=detect_pred)
    for r in ranks:
        tag = f"[tensor] rank {r['rank']} (model coordinate {r['rank']} of 2, cuda:0)"
        for fam, per, runs in (("SD-1.5", PER_STEP, ("fill", "cached")),
                               ("SD-1.5 96^2", PER_STEP_96, ("cached96",)),
                               ("SDXL", PER_STEP_SDXL, ("fill",))):
            for kind in runs:
                x = r["sdxl" if fam == "SDXL" else "sd"][kind]
                want = pred["sdxl" if fam == "SDXL" else "sd"]
                print(f"{tag} {fam} {kind} step: {x['secs']:.3f} s, all_reduce calls "
                      f"{x['calls']}, model group {x['model']} (predicted {want}); launches "
                      f"{ {k: v for k, v in x['launches'].items() if v} } | {card}", flush=True)
                assert x["launches"] == per, (fam, kind, x["launches"])
                assert x["model"] == want, (fam, kind, x["model"], want)
                assert x["calls"] == {"world": 1, "model": sum(want.values())}, x["calls"]
        assert r["vote_model"] == vote_pred and r["vote_calls"] == {"model": vote_pred["forward"]}
        d = r["sdxl"]["detect"]
        assert d["launches"] == scaled(PER_PASS_SDXL, d["passes"]), d["launches"]
        assert d["model"] == scaled(detect_pred, d["passes"]), d
        assert d["calls"] == {"model": detect_pred["forward"] * d["passes"]}, d
        assert r["bytes"] == r["plan_bytes"] and r["sdxl_bytes"] == r["sdxl_plan_bytes"], r
        print(f"{tag}: UNet parameters {r['bytes'] / 2**30:.3f} GiB (SD-1.5; the plan's slices: "
              f"{r['plan_bytes'] / 2**30:.3f}), {r['sdxl_bytes'] / 2**30:.3f} GiB (SDXL; plan "
              f"{r['sdxl_plan_bytes'] / 2**30:.3f}); runtimes in {r['create_s']:.1f} / "
              f"{r['sdxl_create_s']:.1f} s; peak memory SD-1.5 steps {r['peak_gib']:.2f} GiB, "
              f"SDXL step {r['sdxl_peak_gib_train']:.2f} GiB, SDXL detect "
              f"{r['sdxl_peak_gib_detect']:.2f} GiB; vote forward model all-reduces "
              f"{r['vote_model']}; SDXL M=1 detect {d['secs']:.3f} s, model all-reduces "
              f"{d['model']} | {card}", flush=True)

    # the steps: the loss within 1e-3; their gradients reported beside each
    # side's selection (a bf16 map that rounds otherwise can turn a token of
    # the selection, and that token's gradient row moves with it)
    checks = {}
    for kind in ("fill", "cached"):
        g, w, w2 = got["sd"][kind], ref[0][kind], ref[1][kind]
        checks[kind] = dict(grad_rel=rel(g["grad"], w["grad"]), cos=cos(g["grad"], w["grad"]),
                            loss_rel=abs(g["loss"] - w["loss"]) / abs(w["loss"]),
                            context=_distance(g["context"], w["context"]),
                            spread_rel=rel(w2["grad"], w["grad"]),
                            spread_context=_distance(w2["context"], w["context"]))
    checks["fill"]["latents_rel"] = rel(got["sd"]["fill"]["latents"], ref[0]["fill"]["latents"])
    g, w = got["sdxl"], xref
    checks["sdxl"] = dict(grad_rel=rel(g["grad"], w["grad"]), cos=cos(g["grad"], w["grad"]),
                          loss_rel=abs(g["loss"] - w["loss"]) / abs(w["loss"]),
                          context=_distance(g["context"], w["context"]),
                          maps_rel=rel(g["maps"], xmaps))
    for name, c in checks.items():
        ok = c["loss_rel"] <= 1e-3 and (name != "sdxl" or c["maps_rel"] <= 5e-2)
        print(f"[tensor] (1, 2) {name} step vs the one-process step from one state: loss rel "
              f"err {c['loss_rel']:.3e} (tol 1e-3); gradient max abs err / max "
              f"{c['grad_rel']:.3e}, cosine {c['cos']:.6f} (reported: the selection may turn), "
              f"|context diff| / |context| {c['context']:.3e}"
              + (f"; two one-process runs: gradient {c['spread_rel']:.3e}, context "
                 f"{c['spread_context']:.3e}" if "spread_rel" in c else "")
              + (f"; latents {c['latents_rel']:.3e}" if "latents_rel" in c else "")
              + (f"; 2-view ensembled maps max abs err / max {c['maps_rel']:.3e} (tol 5e-2)"
                 if "maps_rel" in c else "")
              + f": {'OK' if ok else 'FAIL'} | {card}", flush=True)
        assert ok, (name, c)
    # the fixed loss: the gradient within 5e-2 of max, cosine >= 0.99, the
    # loss within 1e-3, the step's maps at the chosen tokens within 5e-2
    for name, mine, theirs, chosen in (("SD-1.5", got["sd"]["fixed"], ref_fixed, sd["chosen"]),
                                       ("SDXL", got["sdxl"]["fixed"], xref_fixed, xs["chosen"])):
        (g1, l1) = theirs["runs"][0]
        c = dict(grad_rel=rel(mine["grad"], g1), cos=cos(mine["grad"], g1),
                 loss_rel=abs(mine["loss"] - l1) / abs(l1),
                 maps_rel=rel(mine["maps"], theirs["maps"]),
                 spread_rel=rel(theirs["runs"][-1][0], g1),
                 turned=sum(len(set(a.tolist()) - set(idx.tolist()))
                            for a, (idx, _) in zip(mine["selected"], chosen)),
                 of=sum(len(idx) for idx, _ in chosen))
        ok = (c["grad_rel"] <= 5e-2 and c["cos"] >= 0.99 and c["loss_rel"] <= 1e-3
              and c["maps_rel"] <= 5e-2)
        print(f"[tensor] (1, 2) {name} fixed-loss context gradient (the one-process step's "
              f"tokens and targets) vs one process: max abs err / max {c['grad_rel']:.3e} (tol "
              f"5e-2; two one-process runs {c['spread_rel']:.3e}), cosine {c['cos']:.6f} (tol >= "
              f"0.99), loss rel err {c['loss_rel']:.3e} (tol 1e-3); the step's maps at those "
              f"tokens max abs err / max {c['maps_rel']:.3e} (tol 5e-2); {c['turned']} of "
              f"{c['of']} selected tokens turned in the (1, 2) step's own selection: "
              f"{'OK' if ok else 'FAIL'} | {card}", flush=True)
        checks[f"{name}_fixed"] = c
        assert ok, (name, c)
    sel_diff = int((got["sd"]["select"] != sel1).sum())
    kp = got["sdxl"]["keypoints"]
    assert kp.shape == (1, xcfg.top_k, 2) and torch.isfinite(kp).all(), kp
    assert got["sd"]["grad96_finite"]
    print(f"[tensor] vote batch of {b}: {sel_diff} of {sel1.numel()} selected tokens differ "
          f"from the one-process vote (reported); phase {time.time() - t_phase:.1f} s | {card}",
          flush=True)
    res.update(checks=checks, select_diff=sel_diff,
               tp={"launches": ranks[0]["sd"]["cached"]["launches"],
                   "capture96_launches": ranks[0]["sd"]["cached96"]["launches"]},
               sdxl_tp={"launches": ranks[0]["sdxl"]["fill"]["launches"]},
               launches=ranks[0]["sd"]["cached"]["launches"], phase_s=time.time() - t_phase)
    return res


def _thetas(torch, rt, gen, v):
    from stablekeypoints_tpu_torch.ops.transforms import sample_thetas

    return sample_thetas(gen, v, rt.aff).cpu()


def native_decode(np, card, reps=20):
    """native.available() on this machine, and where it is, the host decode
    of a 512^2 JPEG by native_io="on" against PIL (s/image, in turns)."""
    from PIL import Image

    from stablekeypoints_tpu_torch.data import base
    from stablekeypoints_tpu_torch.data.synthetic import SyntheticBlobs
    from stablekeypoints_tpu_torch.utils import native

    ok = native.available()
    print(f"[parallel] native.available() = {ok} (g++: {shutil.which('g++')}, "
          f"/usr/include/jpeglib.h: {os.path.exists('/usr/include/jpeglib.h')}) | {card}",
          flush=True)
    if not ok:
        return dict(available=False)
    root = tempfile.mkdtemp(prefix="jpeg_", dir=os.path.join(REPO, "build"))
    try:
        path = os.path.join(root, "blob.jpg")
        img = SyntheticBlobs(length=1, image_size=512)[0]["img"]
        Image.fromarray((img * 255).astype(np.uint8)).save(path, quality=95)
        secs = {"on": [], "off": []}
        outs = {}
        for mode in ("on", "off", "off", "on"):
            base.set_native_io(mode)
            t0 = time.perf_counter()
            for _ in range(reps):
                outs[mode] = base.load_image_rgb(path, 512)
            secs[mode].append((time.perf_counter() - t0) / reps)
        base.set_native_io("auto")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    same = bool(np.array_equal(outs["on"], outs["off"]))
    s_on, s_off = (float(np.mean(secs[m])) for m in ("on", "off"))
    # bitwise equal where the library links the libjpeg that PIL carries
    print(f"[parallel] host decode of a 512^2 JPEG: native_io on {s_on * 1e3:.3f} ms/image "
          f"{[round(x * 1e3, 3) for x in secs['on']]}, PIL {s_off * 1e3:.3f} ms/image "
          f"{[round(x * 1e3, 3) for x in secs['off']]}; pixels bitwise equal (at size): {same} "
          f"| {card}", flush=True)
    assert np.isfinite(outs["on"]).all() and outs["on"].shape == (512, 512, 3)
    return dict(available=True, s_on=s_on, s_pil=s_off, secs=secs, bitwise_equal=same)


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
    del two
    serve = backbone_serve(torch, rt, ctx.numpy(), images, again, card, tag) if fam == "sdxl" \
        else None

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
    group = backbone_group(torch, rt, data, card, out_dir, tag, label, bb["per_step"]) \
        if fam == "sdxl" else None
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
    if serve is not None:
        result["serve"] = serve
    if group is not None:
        result["group"] = group

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
        torch.cuda.empty_cache()
        # capture_fp32_bwd: the precise K1 and K2 backward at d 64
        result["precise_launches"], result["precise_check"] = precise_step(
            torch, rt, data, card, tag, precise(PER_STEP_SD21), remat=False)
        rt96 = Runtime(dataclasses.replace(cfg, feature_upsample_res=96), rt.unet, rt.vae,
                       rt.schedule, rt.device)
        result["precise96_launches"], result["precise96_check"] = precise_step(
            torch, rt96, data, card, f"{tag} 96^2", precise(PER_STEP_SD21_96), remat=False)
        del rt96
    if fam == "sdxl":
        result["generate"] = backbone_generate(torch, rt, learned, card, out_dir)
        del model, vote_rt
        rt = None
        torch.cuda.empty_cache()
        result["cli"] = backbone_cli(torch, card, out_dir)
    return result


def backbone_group(torch, rt, data, card, out_dir, tag, label, per_step, k=2):
    """k cached steps as one train_step_scan (one CUDA graph replayed per
    step; its launches inside the capture: one cached step's) against k
    eager steps from one state, s/step in turns, a profile of a group."""
    import numpy as np

    lat_k, img_k = group_inputs(torch, rt, data, k)
    per_capture = []
    with counting_captures(per_capture):
        (ctx_e, opt_e, gen_e), (ctx_g, opt_g, gen_g), checks = grouped_vs_eager(
            torch, rt, lat_k, img_k, card, tag)
    check_capture(tag, per_capture, per_step)

    def grouped():
        rt.train_step_scan(ctx_g, opt_g, lat_k, img_k, generator=gen_g)

    def eager():
        for j in range(k):
            rt.train_step_cached(ctx_e, opt_e, lat_k[j], img_k[j], generator=gen_e)

    secs = timed_turns(torch, k, {"grouped": grouped, "eager": eager})
    s_g, s_e = (float(np.mean(secs[n])) for n in ("grouped", "eager"))
    print(f"[{tag}] {label} batch {rt.cfg.batch_size} cached steps, in turns (grouped, eager, "
          f"eager, grouped): grouped {s_g:.4f} s/step {[round(x, 4) for x in secs['grouped']]}, "
          f"eager {s_e:.4f} s/step {[round(x, 4) for x in secs['eager']]} | {card}", flush=True)
    prof = profile_call(torch, grouped, f"one {label} group of {k} replays", out_dir,
                        f"profile_{tag}_group.txt", card, s_g * k * 1e3)
    del ctx_e, opt_e, ctx_g, opt_g, lat_k, img_k
    rt._step_graphs.clear()
    torch.cuda.empty_cache()
    return dict(launches_in_capture=per_capture[0], checks=checks, s_per_step_grouped=s_g,
                s_per_step_eager=s_e, secs=secs, profile=prof)


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
                host_ranges_ms=ranges, top=[list(r) for r in rows[:25]],
                names=sorted({key for _, _, key in rows}))


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


PHASES = ("kernels", "detect", "serve", "train", "vote", "capture96", "cli", "parallel",
          "tensor", "weights", "generate", "visualize", "sd21", "sdxl")


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
    if rt is None and set(phases) & {"serve", "train", "vote", "capture96", "cli", "parallel",
                                     "tensor"}:
        from stablekeypoints_tpu_torch.config import Config
        from stablekeypoints_tpu_torch.pipeline.runtime import Runtime

        rt = Runtime.create(Config())
    if "serve" in phases:
        results["serve"] = phase_serve(torch, rt, card, out_dir)
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
    if "parallel" in phases:
        results["parallel"] = phase_parallel(torch, rt, card, out_dir)
    if "tensor" in phases:
        results["tensor"] = phase_tensor(torch, rt, card, out_dir)
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
        src, key = LAUNCHES_FROM.get(name, ("detect", "launches"))
        rows.append(dict(
            name=name, **meta, launches=results[src][key][name],
            max_abs_err=s["max_abs_err"], ms=s["ms"], plain_ms=s["plain_ms"],
            bound_ms=s["bound_ms"],
            bound_by="operations" if s["ops_ms"] >= s["bytes_ms"] else "bytes",
            library_ms=s["library_ms"], unfused_ms=s["unfused_ms"],
            # the run whose shapes the times above are for
            per=("one training step with capture_fp32_bwd" + (" at a 96^2 capture grid"
                                                              if src == "capture96" else "")
                 if key == "precise_launches" else
                 {"train": "one training step",
                  "capture96": "one training step at a 96^2 capture grid (forward shapes: "
                               "a detect pass, 10 views)"}.get(src, "one detect forward pass")),
            launches_by_phase={p: results[p]["launches"][name] for p in results},
        ))
    # the d-64 rows: forward kernels per detect pass of their backbone's
    # phase, backward kernels per training step, K2 per SD-2.1 step at 96^2;
    # the tensor-parallel rows per step of a (1, 2) rank in [tensor]
    for row, s in summary.items():
        if "@" not in row:
            continue
        name, fam = row.split("@")
        if fam in ("tp", "sdxl_tp"):
            key = "capture96_launches" if name.startswith("capture_unfused") else "launches"
            rows.append(dict(
                name=row, **KERNELS[name], launches=results["tensor"][fam][key][name],
                max_abs_err=s["max_abs_err"], ms=s["ms"], plain_ms=s["plain_ms"],
                bound_ms=s["bound_ms"],
                bound_by="operations" if s["ops_ms"] >= s["bytes_ms"] else "bytes",
                library_ms=s["library_ms"], unfused_ms=s["unfused_ms"],
                per="one training step of a rank of the (1, 2) mesh, "
                    + ("SDXL 1024^2 (batch 1), 10 of 20 heads" if fam == "sdxl_tp"
                       else "SD-1.5 512^2 (batch 4), 4 of 8 heads")
                    + (" at a 96^2 capture grid" if key == "capture96_launches" else ""),
            ))
            continue
        key = ("precise96_launches" if name == "capture_unfused_bwd_precise"
               else "precise_launches" if name == "capture_bwd_precise"
               else "capture96_launches" if name.startswith("capture_unfused")
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
                 "capture96_launches": "one SD-2.1 768^2 training step at a 96^2 capture grid",
                 "precise_launches": "one SD-2.1 768^2 training step with capture_fp32_bwd",
                 "precise96_launches": "one SD-2.1 768^2 training step at a 96^2 capture grid "
                                       "with capture_fp32_bwd"}[key],
        ))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
