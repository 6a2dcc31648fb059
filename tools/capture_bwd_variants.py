"""Where the K1/K2 capture backward's time goes: time ablated copies of the
PyTorch port's capture backward CUDA kernels on one NVIDIA GPU.

    python3 tools/capture_bwd_variants.py [--parent DIR] [--reps 10]

Each variant is `stablekeypoints_tpu_torch/kernels/csrc/` with one part
changed by a text substitution, built with nvcc into its own library
(`attn_capture.cu`) under build/capture_bwd_variants/ (all builds in
parallel) and timed at the shapes one SD-1.5 512^2 training step gives the
backward (batch 8, 500 tokens; K1 at the 128^2 capture, K2 at a 96^2 one),
bf16:

  kernel        the kernels as committed
  no_g_copy     g tiles copied for the first ring stages only (statistics
                and backward pass)
  no_q_copy     backward pass: q tiles copied for the first ring stages only
  no_dq_reduce  backward pass: the dq bulk reduce-adds skipped
  no_exp        every exponential replaced by a multiply
  stats_only    the statistics pass alone
  no_finish     the finishing pass (K1 dt, K2 dq to bf16) skipped
  parent        with --parent DIR: DIR/stablekeypoints_tpu_torch/kernels/csrc
                as it is (an earlier commit's kernels, for a same-card
                comparison)
  parent_rows   the parent without its keys kernel, where it has one (the
                split of its time between its rows and keys kernels)
  NAME          with --variant NAME=DIR: the csrc directory DIR as it is

A variant's time against the kernel's bounds what its part costs while the
rest stays. Only `kernel` and `parent` compute the right result; the
largest difference of `parent`'s dk from `kernel`'s is printed. Times are
device times: CUDA events around `--reps` calls queued behind a device-side
spin, as chip_smoke.py times. Needs a CUDA device and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys

from variant_build import build, card, device_ms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "stablekeypoints_tpu_torch", "kernels", "csrc")
OUT = os.path.join(REPO, "build", "capture_bwd_variants")
_STATS_TX = "    const int st = j % ST;\n    mbar_expect_tx(&full[st], C::STX);"
_STATS_G = "    for (int cb = 0; cb < BK / 32; ++cb)\n      tma_load_2d(Gs + st * kCbGT + cb * kCbBQ * 32"
_BWD_TX = "      mbar_expect_tx(&full[st], C::TX);"
_BWD_Q = "      for (int cb = 0; cb < C::CB; ++cb)\n        tma_load_4d(Qs"
_BWD_G = "      for (int cb = 0; cb < KB / 32; ++cb)\n        tma_load_2d(Gs"
_BWD_LAUNCH = "  capture_bwd_kernel<D><<<"
_FINISH = "  if constexpr (kQ) {\n    const long chunks"
VARIANTS = {  # name: [(file, old, new)]
    "kernel": [],
    "no_g_copy": [
        ("attn_capture.cu", _STATS_TX, _STATS_TX.replace("C::STX", "C::STX - (j >= ST) * kCbGT * 4")),
        ("attn_capture.cu", _STATS_G, _STATS_G.replace("cb < BK / 32", "cb < (j < ST ? BK / 32 : 0)")),
        ("attn_capture.cu", _BWD_TX, _BWD_TX.replace("C::TX", "C::TX - (i >= ST) * C::GBT * 4")),
        ("attn_capture.cu", _BWD_G, _BWD_G.replace("cb < KB / 32", "cb < (i < ST ? KB / 32 : 0)")),
    ],
    "no_q_copy": [
        ("attn_capture.cu", _BWD_TX, _BWD_TX.replace("C::TX", "C::TX - (i >= ST) * C::CB * 64 * 128")),
        ("attn_capture.cu", _BWD_Q, _BWD_Q.replace("cb < C::CB", "cb < (i < ST ? C::CB : 0)")),
    ],
    "no_dq_reduce": [("attn_capture.cu",
                      "      bulk_reduce_add_f32(dq_acc + (bh * N + n0 + wt) * D, Dq + wt * C::DQLD, D * 4);",
                      "")],
    "no_exp": [("common.cuh", 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                "y = x * 0.999f;")],
    "stats_only": [("attn_capture.cu", _BWD_LAUNCH, "  if (false) " + _BWD_LAUNCH.strip()),
                   ("attn_capture.cu", _FINISH, "  if (true) return 0;\n" + _FINISH)],
    "no_finish": [("attn_capture.cu", _FINISH, "  if (true) return 0;\n" + _FINISH)],
}
_PARENT_KEYS = "  capture_bwd_keys_kernel<D, kQ><<<"
B, T = 8, 500
# (label, K1 x or None for K2, D, launches per step)
CASES = (("K1", 16, 160, 3), ("K1", 32, 80, 1), ("K2", None, 160, 3), ("K2", None, 80, 1))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="a checkout of an earlier commit to time beside")
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--variant", action="append", default=[], metavar="NAME=DIR",
                        help="also time the kernels of another csrc directory (same entry points)")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("capture_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from stablekeypoints_tpu_torch.kernels import _build
    from stablekeypoints_tpu_torch.kernels._common import stream_handle
    from stablekeypoints_tpu_torch.ops.resize import resize_matrix

    variants = {n: (CSRC, subs) for n, subs in VARIANTS.items()}
    for spec in args.variant:
        name, _, path = spec.partition("=")
        variants[name] = (os.path.abspath(path), [])
    old_abi = set()  # variants with the rows + keys kernels' entry points
    if args.parent:
        pdir = os.path.join(args.parent, "stablekeypoints_tpu_torch", "kernels", "csrc")
        variants["parent"] = (pdir, [])
        with open(os.path.join(pdir, "attn_capture.cu")) as f:
            if _PARENT_KEYS in f.read():
                variants["parent_rows"] = (pdir, [("attn_capture.cu", _PARENT_KEYS,
                                                   "  if (false) " + _PARENT_KEYS.strip())])
                old_abi = {"parent", "parent_rows"}
    built = build(_build._nvcc_path(), OUT, variants, ("attn_capture",))
    libs = {n: ls["attn_capture"] for n, ls in built.items()}
    print(card())
    gen = torch.Generator(device="cuda").manual_seed(0)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(bf)

    def p(x):
        return P(x.data_ptr())

    for label, x, d, count in CASES:
        scale = d ** -0.5
        k = randn(B, T, 8, d)
        n = 128 * 128 if x else 96 * 96
        g = torch.randn((B, n, T), generator=gen, device="cuda") * 1e-3
        lse, c = (torch.empty((B, 8, n), device="cuda") for _ in range(2))
        acc = torch.empty((B, 8, n, d), device="cuda")
        dk = torch.empty_like(k)
        if x:
            tt, ww = randn(B, 8, 128, x, d), resize_matrix(x, 128, "bicubic", bf, "cuda")
            q, out = torch.empty((B, 8, n, d), dtype=bf, device="cuda"), torch.empty_like(tt)
            shape = f"tt[{B},8,128,{x},{d}]"
        else:
            q = randn(B, 8, n, d)
            out = torch.empty_like(q)
            shape = f"q[{B},8,{n},{d}]"
        ref = None
        for name, lib in libs.items():
            if x:
                fn = lib.skp_capture_bwd
                if name in old_abi:
                    ptrs, ints = [p(a) for a in (tt, ww, k, g, lse, c, out, dk)], [B, 8, 128, x, 128, T, d]
                else:
                    ptrs = [p(a) for a in (tt, ww, k, g, q, lse, c, acc, out, dk)]
                    ints = [B, 8, 128, x, 128, T, T, d]
            else:
                fn = lib.skp_capture_q_bwd
                if name in old_abi:
                    ptrs, ints = [p(a) for a in (q, k, g, lse, c, out, dk)], [B, 8, n, T, d]
                else:
                    ptrs, ints = [p(a) for a in (q, k, g, lse, c, acc, out, dk)], [B, 8, n, T, T, d]
            fn.argtypes = [P] * len(ptrs) + [I] * len(ints) + [F, P]
            fn.restype = I

            def call(fn=fn, ptrs=ptrs, ints=ints):
                assert fn(*ptrs, *ints, scale, stream_handle()) == 0

            ms = device_ms(torch, call, args.reps)
            extra = ""
            if name == "kernel":
                ref = dk.float().clone()
            elif name == "parent":
                extra = f"  dk max diff from kernel {(dk.float() - ref).abs().max().item():.2e}"
            print(f"{label} bwd {shape} x{count} {name:<13} {ms:.4f} ms{extra}", flush=True)
        del q, out, acc, g
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
