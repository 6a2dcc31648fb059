#!/usr/bin/env python3
"""Run the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits non-zero; nothing is skipped):
  1. build    every CUDA kernel from the checkout's sources (one nvcc per
              source, in parallel); Triton kernels compile at first launch.
  2. kernels  each forward kernel at the shapes one SD-1.5 512^2 detect
              forward gives it (10 augmented views), and each backward
              kernel at the shapes one training step gives it (batch 4,
              merged batch 8), bf16, against its plain PyTorch version on
              the same inputs, with a stated tolerance; CUDA-event times of
              the kernel, the plain version and, where one exists, a single
              PyTorch library call of the same function.
  3. detect   a full-width SD-1.5 runtime from the seed (random weights),
              KeypointModel.detect_batch on 1 and 4 images of 512^2 with a
              random [1, 500, 768] context and indices 0..9; launch counts
              of every kernel against the expected count per forward pass;
              a torch.profiler trace of one M=1 call (device time by
              kernel); the ensembled maps against the same runtime with
              every kernel switched off (plain PyTorch layers).
  4. train    stage 1 on the same runtime: optimize_embedding on
              SyntheticBlobs (8 images of 512^2), batch 4, an epoch of fill
              steps then one of cached steps; s/step, peak memory, losses,
              launch counts per step against the prediction; a profile of
              one cached step; the context gradient of a fixed loss through
              the kernels against the same through the plain layers.
Prints a `kernels` JSON line, the card's name and power limit, and last
{"ok": true, "device": {...}}. Needs a CUDA device; imports no JAX.

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

# expected launches per SD-1.5 512^2 detect forward pass (fused_gn_conv off)
PER_PASS = {"capture": 4, "cross": 2, "flash_self": 6, "flash_cross": 3, "groupnorm": 22,
            "capture_bwd": 0, "cross_bwd": 0, "flash_self_bwd": 0, "flash_cross_bwd": 0}
# expected launches per training step (batch 4, merged batch 8, one VAE encode
# call per step: of both image sets on fill steps, of the warped ones on cached
# steps). Forward as detect; backward: the first self-attention of down_0 runs
# before any layer reads the context, so it gets no gradient (K4 5 - 1), and
# up_2's cross-attention output reaches no loss (truncation, K5 3 - 1).
PER_STEP = {"capture": 4, "cross": 2, "flash_self": 6, "flash_cross": 3, "groupnorm": 22,
            "capture_bwd": 4, "cross_bwd": 2, "flash_self_bwd": 4, "flash_cross_bwd": 2}


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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

    # K6 GroupNorm(+SiLU) in the VAE encoder at 512^2 (eps 1e-6, 32 groups)
    for hw, c, act, count in ((512, 128, "silu", 4), (256, 128, "silu", 1), (256, 256, "silu", 3),
                              (128, 256, "silu", 1), (128, 512, "silu", 3), (64, 512, "silu", 9),
                              (64, 512, None, 1)):
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
    "groupnorm": dict(route="triton", source="stablekeypoints_tpu_torch/kernels/groupnorm.py",
                      replaces="stablekeypoints_tpu/kernels/groupnorm.py:110"),
    "capture_bwd": dict(route="cuda", source="stablekeypoints_tpu_torch/kernels/csrc/attn_capture.cu",
                        replaces="stablekeypoints_tpu/kernels/attn_capture.py:367"),
    "cross_bwd": dict(route="cuda", source="stablekeypoints_tpu_torch/kernels/csrc/cross_attn.cu",
                      replaces="stablekeypoints_tpu/kernels/cross_attn.py:174"),
    "flash_self_bwd": dict(route="cuda", source="stablekeypoints_tpu_torch/kernels/csrc/attn_bwd.cuh",
                           replaces="stablekeypoints_tpu/kernels/flash.py:126"),
    "flash_cross_bwd": dict(route="cuda", source="stablekeypoints_tpu_torch/kernels/csrc/attn_bwd.cuh",
                            replaces="stablekeypoints_tpu/kernels/flash.py:187"),
}


def counters():
    from stablekeypoints_tpu_torch.kernels import attn_capture, cross_attn, flash, groupnorm

    return {
        "capture": attn_capture.capture_attention_fused,
        "cross": cross_attn.cross_attention_resident,
        "flash_self": flash.flash_self_attention,
        "flash_cross": flash.flash_cross_attention,
        "groupnorm": groupnorm.fused_group_norm,
        "capture_bwd": attn_capture.capture_attention_fused_bwd,
        "cross_bwd": cross_attn.cross_attention_resident_bwd,
        "flash_self_bwd": flash.flash_self_attention_bwd,
        "flash_cross_bwd": flash.flash_cross_attention_bwd,
    }


def phase_kernels(torch, out_dir):
    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = {n: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                       ops_ms=0.0, bytes_ms=0.0, shapes=[]) for n in KERNELS}
    failures = []
    for case in kernel_cases(torch, gen):
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
        del got, want
        ms = cuda_ms(case["kernel"], 5)
        plain_ms = cuda_ms(case["plain"], 2)
        lib_ms = case["library_time"]() if "library_time" in case else cuda_ms(case["library"], 5)
        b_ms, b_by = bound_ms(case["nbytes"], case["flops"], case["peak"])
        ok = finite and all(e <= t for e, t in errs)
        if "scale_a" in case:
            got, want = case["scale_a"]()
            a_err = ((got - want).abs() / want.abs()).max().item()
            ok = ok and a_err <= case["scale_a_tol"]
            print(f"[kernel] {case['name']:<11} {case['shape']:<36} scale a: max rel err "
                  f"{a_err:.3e} (tol {case['scale_a_tol']:.0e}) vs the two-pass plain version")
        print(f"[kernel] {case['name']:<11} {case['shape']:<36} x{case['count']} "
              f"max_abs_err {err:.3e} (tol {tol:.3e}) {'OK' if ok else 'FAIL'} | "
              f"kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  library {lib_ms:.3f} ms  "
              f"bound {b_ms:.3f} ms ({b_by})", flush=True)
        if not ok:
            failures.append(f"{case['name']} {case['shape']}: err {err} finite {finite}")
        s = summary[case["name"]]
        c = case["count"]
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s["ms"] += c * ms
        s["plain_ms"] += c * plain_ms
        s["library_ms"] += c * lib_ms
        s["ops_ms"] += c * case["flops"] / case["peak"] * 1e3
        s["bytes_ms"] += c * case["nbytes"] / HBM_BYTES_PER_S * 1e3
        s["shapes"].append(dict(shape=case["shape"], count=c, ms=ms, plain_ms=plain_ms,
                                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err))
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, "kernels.json"), "w") as f:
        json.dump(summary, f, indent=1)
    if failures:
        raise AssertionError("kernel checks failed: " + "; ".join(failures))
    return summary


def phase_detect(torch, card, out_dir):
    import numpy as np

    from stablekeypoints_tpu_torch.api import KeypointModel
    from stablekeypoints_tpu_torch.config import Config
    from stablekeypoints_tpu_torch.pipeline.runtime import Runtime

    t0 = time.time()
    cfg = Config()  # SD-1.5, 512^2, 500 tokens, top_k 10, 10 views, bf16
    rt = Runtime.create(cfg)
    torch.cuda.synchronize()
    print(f"[detect] SD-1.5 runtime from seed {cfg.seed}: {time.time() - t0:.1f} s "
          f"({sum(p.numel() for p in rt.unet.parameters()) / 1e6:.0f}M UNet params)", flush=True)
    ctx = torch.randn((1, cfg.num_tokens, 768), generator=torch.Generator().manual_seed(1))
    model = KeypointModel(rt, ctx.numpy(), np.arange(cfg.top_k))
    rng = np.random.default_rng(2)
    images = rng.uniform(0, 1, (4, cfg.image_size, cfg.image_size, 3)).astype(np.float32)

    t0 = time.time()
    model.detect_batch(images[:1])  # warm-up: Triton compiles, cuDNN picks algorithms
    torch.cuda.synchronize()
    print(f"[detect] warm-up M=1: {time.time() - t0:.2f} s", flush=True)

    count = counters()
    for fn in count.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    results, secs = {}, {}
    for m in (1, 4):
        t0 = time.time()
        results[m] = model.detect_batch(images[:m])
        torch.cuda.synchronize()
        secs[m] = time.time() - t0
    launches = {n: fn.launches for n, fn in count.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    passes = sum(-(-m * cfg.augmentation_iterations // rt.views_per_pass(m * cfg.augmentation_iterations))
                 for m in (1, 4))
    for m, pts in results.items():
        assert pts.shape == (m, cfg.top_k, 2), pts.shape
        assert np.isfinite(pts).all() and (pts >= 0).all() and (pts <= 1).all(), pts
    for name, n in launches.items():
        want = PER_PASS[name] * passes
        print(f"[detect] launches {name:<15} {n} (expected {PER_PASS[name]} x {passes} passes)")
        assert n == want, f"{name}: {n} launches, expected {want}"
    for m in (1, 4):
        print(f"[detect] M={m}: {secs[m]:.3f} s, {secs[m] / m:.3f} s/image | {card}")
    print(f"[detect] peak device memory {peak_gib:.2f} GiB | {card}")
    print(f"[detect] keypoints image 0: {np.round(results[1][0], 4).tolist()}", flush=True)

    profile = profile_call(torch, lambda: model.detect_batch(images[:1]), "one M=1 detect",
                           out_dir, "profile.txt", card, secs[1] * 1e3)

    # the same runtime with every kernel switched off: plain PyTorch layers
    plain_cfg = Config(pallas_capture="off", flash_attention="off", fused_groupnorm="off")
    rt_plain = Runtime.create(plain_cfg)
    maps = {}
    for name, r in (("kernels", rt), ("plain", rt_plain)):
        gen = torch.Generator(device="cuda").manual_seed(3)
        maps[name] = r.augmented_maps(ctx, images[0], np.arange(cfg.top_k), generator=gen)
    ref = maps["plain"]
    rel = ((maps["kernels"] - ref).abs().max() / ref.abs().max()).item()
    kp = torch.stack([maps[k].flatten(1).argmax(1) for k in maps])
    agree = (kp[0] == kp[1]).float().mean().item()
    print(f"[detect] ensembled maps, kernels vs plain layers: max abs err / max {rel:.3e} "
          f"(tol 5e-2); argmax agreement {agree:.2f}", flush=True)
    assert rel <= 5e-2, rel
    del rt_plain, maps, ref
    torch.cuda.empty_cache()
    return rt, dict(launches=launches, s_per_image={m: secs[m] / m for m in secs},
                    peak_gib=peak_gib, maps_rel_err=rel, argmax_agree=agree, profile=profile)


def phase_train(torch, rt, card, out_dir):
    """Stage 1 on the detect phase's SD-1.5 runtime: optimize_embedding on
    SyntheticBlobs(8 images, 512^2), batch 4, 4 timed steps (an epoch of fill
    steps, then one of cached steps) after one untimed fill and one untimed
    cached step; launch counts per step; a profile of one cached step; the
    gradient of a fixed loss through the kernels vs the plain layers."""
    import numpy as np

    from stablekeypoints_tpu_torch.data.synthetic import SyntheticBlobs
    from stablekeypoints_tpu_torch.pipeline.optimize import optimize_embedding
    from stablekeypoints_tpu_torch.utils.logging import MetricsLogger

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
    print(f"[train] warm-up (one fill, one cached step): {time.time() - t0:.2f} s", flush=True)

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
    count = counters()
    for fn in count.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    log_dir = os.path.join(out_dir, "train")
    if os.path.exists(os.path.join(log_dir, "metrics.jsonl")):  # the logger appends
        os.remove(os.path.join(log_dir, "metrics.jsonl"))
    logger = MetricsLogger(log_dir)
    steps = 4
    rt.cfg = dataclasses.replace(cfg, num_steps=steps, log_every=1)
    learned = optimize_embedding(rt, data, logger, context=ctx0, generator=gen)
    rt.cfg = cfg
    logger.close()
    launches = {n: fn.launches for n, fn in count.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for kind in secs:
        del rt.__dict__[f"train_step_{kind}"]

    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        losses = [json.loads(line)["loss"] for line in f if '"loss"' in line]
    moved = (learned - ctx0).abs().max().item()
    print(f"[train] losses per step: {[round(x, 6) for x in losses]}; context moved by up to "
          f"{moved:.3e}", flush=True)
    assert len(losses) == steps and all(np.isfinite(losses)), losses
    assert len(secs["fill"]) == 2 and len(secs["cached"]) == 2, secs
    assert moved > 0 and torch.isfinite(learned).all()
    for name, n in launches.items():
        want = PER_STEP[name] * steps
        print(f"[train] launches {name:<15} {n} = {n / steps:g} per step "
              f"(predicted {PER_STEP[name]})")
        assert n == want, f"{name}: {n} launches in {steps} steps, expected {want}"
    s_fill, s_cached = (sum(secs[k]) / len(secs[k]) for k in ("fill", "cached"))
    print(f"[train] SD-1.5 512^2 batch 4: fill {s_fill:.4f} s/step {secs['fill']}, cached "
          f"{s_cached:.4f} s/step {secs['cached']} | {card}")
    print(f"[train] peak device memory {peak_gib:.2f} GiB | {card}", flush=True)

    profile = profile_call(torch, lambda: rt.train_step_cached(context, opt, lat, images,
                                                               generator=gen),
                           "one cached training step", out_dir, "profile_train.txt", card,
                           s_cached * 1e3)
    del context, opt, lat
    torch.cuda.empty_cache()
    grad = gradient_check(torch, rt, data, card)
    return dict(s_per_step_fill=s_fill, s_per_step_cached=s_cached, secs=secs,
                launches=launches, peak_gib=peak_gib, losses=losses, profile=profile,
                grad_check=grad)


def gradient_check(torch, rt, data, card, batch=2):
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
                                                  fused_groupnorm="off"))
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
    print(f"[train] fixed-loss context gradient, kernels vs plain layers (batch {batch}): "
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
PROFILE_GROUPS = (
    ("K1 capture bwd", ("capture_bwd_rows_kernel", "capture_bwd_keys_kernel")),
    ("K3/K4/K5 attention bwd", ("attn_bwd_dkdv_kernel", "attn_bwd_dq_kernel",
                                "flash_di_kernel", "cross_stats_kernel")),
    ("K1 capture", ("capture_fwd_kernel",)),
    ("K4/K5 flash", ("flash_fwd_kernel",)),
    ("K3 cross", ("cross_fwd_kernel",)),
    ("K6 groupnorm", ("stats_kernel", "coeffs_kernel", "apply_kernel")),
    ("convolution (cuDNN)", ("fprop", "conv", "Conv", "nchw", "nhwc")),
    ("matmul (cuBLAS)", ("gemm", "nvjet", "Kernel2")),
)


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from stablekeypoints_tpu_torch.kernels import _build  # fails outside a checkout

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    card = card_line()
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {torch.cuda.get_device_name(0)} | {card} | TF32 off: matmul "
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

    summary = phase_kernels(torch, out_dir)
    rt, detect = phase_detect(torch, card, out_dir)
    train = phase_train(torch, rt, card, out_dir)

    rows = []
    for name, meta in KERNELS.items():
        s = summary[name]
        bound = max(s["ops_ms"], s["bytes_ms"])
        backward = name.endswith("_bwd")
        rows.append(dict(
            name=name, **meta,
            # the run whose shapes the times below are for: training steps for
            # a backward kernel, detect passes for a forward kernel
            launches=(train if backward else detect)["launches"][name],
            max_abs_err=s["max_abs_err"], ms=s["ms"], plain_ms=s["plain_ms"],
            bound_ms=bound, bound_by="operations" if s["ops_ms"] >= s["bytes_ms"] else "bytes",
            library_ms=s["library_ms"],
            per="one training step" if backward else "one detect forward pass",
            launches_detect=detect["launches"][name], launches_train=train["launches"][name],
        ))
    with open(os.path.join(out_dir, "detect.json"), "w") as f:
        json.dump(dict(detect, card=card), f, indent=1)
    with open(os.path.join(out_dir, "train.json"), "w") as f:
        json.dump(dict(train, card=card), f, indent=1)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
