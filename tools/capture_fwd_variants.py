"""Where the K1/K2 capture forward's time goes: time ablated copies of the
PyTorch port's capture forward CUDA kernel on one NVIDIA GPU.

    python3 tools/capture_fwd_variants.py [--parent DIR] [--variant NAME=DIR] [--reps 10]

Each variant is `stablekeypoints_tpu_torch/kernels/csrc/` with one part
changed by a text substitution, built with nvcc into its own library
(`attn_capture.cu`) under build/capture_fwd_variants/ (all builds in
parallel) and timed at the shapes one SD-1.5 512^2 detect pass gives the
forward (10 views, 500 tokens; K1 at the 128^2 capture, K2 at a 96^2 one),
bf16:

  kernel     the kernel as committed
  no_exp     every exponential replaced by a multiply
  no_acc     the head-mean's shared-memory accumulation skipped (the last
             head still writes the output)
  no_kcopy   k copied for the first ring stages only
  no_qbuild  K1: the queries not built from tt and ww (constant fragments)
  parent     with --parent DIR: DIR/stablekeypoints_tpu_torch/kernels/csrc
             as it is (an earlier commit's kernel, for a same-card
             comparison)
  NAME       with --variant NAME=DIR: the csrc directory DIR as it is

A variant's time against the kernel's bounds what its part costs while the
rest stays. Only whole trees compute the right result: each row prints its
largest difference from the plain version. Times are device times (CUDA
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
B, T = 10, 500
# (label, K1 x or None for K2, D, launches per detect pass)
CASES = (("K1", 16, 160, 3), ("K1", 32, 80, 1), ("K2", None, 160, 3), ("K2", None, 80, 1))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="a checkout of an earlier commit to time beside")
    parser.add_argument("--variant", action="append", default=[], metavar="NAME=DIR",
                        help="also time the kernel of another csrc directory (same entry points)")
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("capture_fwd_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from stablekeypoints_tpu_torch.kernels import _build, attn_capture
    from stablekeypoints_tpu_torch.kernels._common import stream_handle
    from stablekeypoints_tpu_torch.ops.resize import resize_matrix

    variants = {n: (CSRC, subs) for n, subs in VARIANTS.items()}
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
    for label, x, d, count in CASES:
        scale = d ** -0.5
        k = randn(B, T, 8, d)
        if x:
            tt, ww = randn(B, 8, 128, x, d), resize_matrix(x, 128, "bicubic", bf, "cuda")
            n = 128 * 128
            want = attn_capture.capture_fused_plain(tt, ww, k, scale)
            shape = f"tt[{B},8,128,{x},{d}]"
        else:
            n = 96 * 96
            q = randn(B, 8, n, d)
            want = attn_capture.capture_plain(q, k, scale)
            shape = f"q[{B},8,{n},{d}]"
        out = torch.empty((B, n, T), device="cuda")
        for name, lib in libs.items():
            if x:
                fn = lib.skp_capture_fwd
                ptrs, ints = [P(a.data_ptr()) for a in (tt, ww, k, out)], [B, 8, 128, x, 128, T, d]
            else:
                fn = lib.skp_capture_q_fwd
                ptrs, ints = [P(a.data_ptr()) for a in (q, k, out)], [B, 8, n, T, d]
            # total_heads (8) last: an entry built before it took that
            # argument ignores the trailing integer
            fn.argtypes = [P] * len(ptrs) + [I] * len(ints) + [F, P, I]
            fn.restype = I

            def call(fn=fn, ptrs=ptrs, ints=ints):
                assert fn(*ptrs, *ints, scale, stream_handle(), 8) == 0

            out.fill_(float("nan"))
            ms = device_ms(torch, call, args.reps)
            err = (out - want).abs().max().item()
            totals[name] += count * ms
            print(f"{label} fwd {shape} x{count} {name:<10} {ms:.4f} ms  max abs err {err:.2e}",
                  flush=True)
        del out, want
        torch.cuda.empty_cache()
    for name, ms in totals.items():
        print(f"all 8 launches (K1 4 + K2 4) {name:<10} {ms:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
