"""Where the K1/K2 capture forward's time goes: time ablated copies of the
PyTorch port's capture forward CUDA kernel on one NVIDIA GPU.

    python3 tools/capture_fwd_variants.py [--parent DIR] [--variant NAME=DIR] [--reps 10]
        [--d64] [--cuts A,B] [--tokens]

Each variant is `stablekeypoints_tpu_torch/kernels/csrc/` with one part
changed by a text substitution, built with nvcc into its own library
(`attn_capture.cu`) under build/capture_fwd_variants/ (all builds in
parallel) and timed at the shapes one SD-1.5 512^2 detect pass gives the
forward (10 views, 500 tokens; K1 at the 128^2 capture, K2 at a 96^2 one),
bf16; with --d64 at the d-64 shapes of SD-2.1 768^2 and SDXL 1024^2 (K1 at
a detect pass of 10 views, 20 heads; K1 at SDXL's tensor-parallel rank, 10
of 20 heads, batch 2; K2 at SD-2.1's 96^2 training step, batch 4); --tokens
adds the detect pass's shapes at 1000 tokens (K1 and K2 on clusters of two
blocks; a parent that refuses them prints "refused"):

  kernel     the kernel as committed
  no_exp     every exponential replaced by a multiply
  no_acc     the head-mean's shared-memory accumulation skipped (the last
             head still writes the output)
  no_kcopy   k copied for the first ring stages only
  no_qbuild  K1: the queries not built from tt and ww (constant fragments)
  x_nosync   past 512 tokens: the cluster barrier a head replaced by the
             block's (the other blocks' maxima and sums read unordered)
  parent     with --parent DIR: DIR/stablekeypoints_tpu_torch/kernels/csrc
             as it is (an earlier commit's kernel, for a same-card
             comparison)
  NAME       with --variant NAME=DIR: the csrc directory DIR as it is

--cuts A,B times only those variants (with `kernel`): each cut is a text
substitution into the kernel's source and fails the build where the source
no longer has that text. A variant's time against the kernel's bounds what
its part costs while the rest stays. Only whole trees compute the right
result: each row prints its largest difference from the plain version and
the exponential floor (B*H*N*T ex2 at 16 a clock per SM at 1.98 GHz, as
chip_smoke.py reckons it). Times are device times (CUDA
events around `--reps` calls queued behind a device-side spin), as
chip_smoke.py times. Needs a CUDA device and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys

from variant_build import build, card, device_ms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "stablekeypoints_tpu_torch", "kernels", "csrc")
OUT = os.path.join(REPO, "build", "capture_fwd_variants")
_ACC = ("          const float2 v = h == 0 ? make_float2(0.f, 0.f) : *at;\n"
        "          *at = make_float2(v.x + s[4 * j + 2 * r] * inv[r], v.y + s[4 * j + 2 * r + 1] * inv[r]);\n")
_KTX = "    mbar_expect_tx(&my_full[i % ST], kCfStage * 2);\n"
VARIANTS = {  # name: [(file, old, new)]
    "kernel": [],
    "x_nosync": [("attn_capture.cu", "      cluster_sync();\n      float m[2]", "      __syncthreads();\n      float m[2]")],
    "no_exp": [("common.cuh", 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                "y = x * 0.999f;")],
    "no_acc": [("attn_capture.cu", _ACC, "")],
    "no_kcopy": [("attn_capture.cu", _KTX,
                  "    if (i >= ST) {\n      mbar_arrive(&my_full[i % ST]);\n      return;\n    }\n"
                  + _KTX)],
    "no_qbuild": [("attn_capture.cu",
                   "      resize_frags<D>(qf, wf, Ts + (h & 1) * XP * LD, LD, xsteps, lane);",
                   "      for (int ks = 0; ks < KS; ++ks)\n"
                   "        qf[ks][0] = qf[ks][1] = qf[ks][2] = qf[ks][3] = 0x3c003c00u;")],
}
T = 500
# (label, B, H, K1 x or None for K2, D, launches per detect pass or step, total_heads)
CASES = (("K1", 10, 8, 16, 160, 3, 8), ("K1", 10, 8, 32, 80, 1, 8), ("K2", 10, 8, None, 160, 3, 8),
         ("K2", 10, 8, None, 80, 1, 8))
CASES_D64 = (("K1@sd21", 10, 20, 24, 64, 3, 20), ("K1@sdxl", 10, 20, 32, 64, 3, 20),
             ("K1@sdxl_tp", 2, 10, 32, 64, 3, 20), ("K2@sd21", 4, 20, None, 64, 3, 20))
# (..., tokens)
CASES_TOKENS = (("K1@t1000", 10, 8, 16, 160, 3, 8, 1000), ("K1@t1000", 10, 8, 32, 80, 1, 8, 1000),
                ("K2@t1000", 10, 8, None, 160, 3, 8, 1000))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="a checkout of an earlier commit to time beside")
    parser.add_argument("--variant", action="append", default=[], metavar="NAME=DIR",
                        help="also time the kernel of another csrc directory (same entry points)")
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--d64", action="store_true", help="the SD-2.x / SDXL d-64 shapes")
    parser.add_argument("--cuts", help="comma-separated variants to time (default: all)")
    parser.add_argument("--tokens", action="store_true", help="also the shapes at 1000 tokens")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("capture_fwd_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from stablekeypoints_tpu_torch.kernels import _build, attn_capture
    from stablekeypoints_tpu_torch.kernels._common import stream_handle
    from stablekeypoints_tpu_torch.ops.resize import resize_matrix

    cuts = set(args.cuts.split(",")) | {"kernel"} if args.cuts else set(VARIANTS)
    variants = {n: (CSRC, subs) for n, subs in VARIANTS.items() if n in cuts}
    if args.parent:
        variants["parent"] = (os.path.join(args.parent, "stablekeypoints_tpu_torch", "kernels",
                                           "csrc"), [])
    for spec in args.variant:
        name, _, path = spec.partition("=")
        variants[name] = (os.path.abspath(path), [])
    built = build(_build._nvcc_path(), OUT, variants, ("attn_capture",))
    libs = {n: ls["attn_capture"] for n, ls in built.items()}
    print(card())
    gen = torch.Generator(device="cuda").manual_seed(0)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf)

    totals = {n: 0.0 for n in libs}
    cases = CASES_D64 if args.d64 else CASES
    for label, B, H, x, d, count, total, *more in cases + (CASES_TOKENS if args.tokens else ()):
        t = more[0] if more else T
        scale = d ** -0.5
        k = randn(B, t, H, d)
        if x:
            tt, ww = randn(B, H, 128, x, d), resize_matrix(x, 128, "bicubic", bf, "cuda")
            n = 128 * 128
            want = attn_capture.capture_fused_plain(tt, ww, k, scale, total)
            shape = f"tt[{B},{H},128,{x},{d}] T {t}"
        else:
            n = 96 * 96
            q = randn(B, H, n, d)
            want = attn_capture.capture_plain(q, k, scale, total)
            shape = f"q[{B},{H},{n},{d}] T {t}"
        floor = B * H * n * t / (16 * torch.cuda.get_device_properties(0).multi_processor_count
                                 * 1.98e9) * 1e3
        out = torch.empty((B, n, t), device="cuda")
        kept = {}
        for name, lib in libs.items():
            if x:
                fn = lib.skp_capture_fwd
                ptrs, ints = [P(a.data_ptr()) for a in (tt, ww, k, out)], [B, H, 128, x, 128, t, d]
            else:
                fn = lib.skp_capture_q_fwd
                ptrs, ints = [P(a.data_ptr()) for a in (q, k, out)], [B, H, n, t, d]
            # total_heads last: an entry built before it took that argument
            # ignores the trailing integer
            fn.argtypes = [P] * len(ptrs) + [I] * len(ints) + [F, P, I]
            fn.restype = I

            def call(fn=fn, ptrs=ptrs, ints=ints):
                assert fn(*ptrs, *ints, scale, stream_handle(), total) == 0

            out.fill_(float("nan"))
            rc = fn(*ptrs, *ints, scale, stream_handle(), total)
            if rc != 0:  # a tree whose kernel does not take this shape
                print(f"{label} fwd {shape} x{count} {name:<10} refused ({rc})", flush=True)
                continue
            ms = device_ms(torch, call, args.reps)
            err = (out - want).abs().max().item()
            if not more:  # the T <= 512 rows, which every tree runs
                totals[name] += count * ms
            if name in ("kernel", "parent"):
                kept[name] = out.clone()
            same = (f"  bitwise the kernel's: {torch.equal(kept['kernel'], out)}"
                    if name == "parent" and "kernel" in kept else "")
            print(f"{label} fwd {shape} x{count} {name:<10} {ms:.4f} ms  max abs err {err:.2e}"
                  f"  ex2 floor {floor:.3f} ms{same}", flush=True)
        del out, want, kept
        torch.cuda.empty_cache()
    for name, ms in totals.items():
        print(f"all launches at 500 tokens (x counts) {name:<10} {ms:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
