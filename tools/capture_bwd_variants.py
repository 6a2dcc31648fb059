"""Where the K1/K2 capture backward's time goes: time ablated copies of the
PyTorch port's capture backward CUDA kernels on one NVIDIA GPU.

    python3 tools/capture_bwd_variants.py [--parent DIR] [--reps 10] [--d64] [--cuts A,B]
        [--precise]

Each variant is `stablekeypoints_tpu_torch/kernels/csrc/` with one part
changed by a text substitution, built with nvcc into its own library
(`attn_capture.cu`) under build/capture_bwd_variants/ (all builds in
parallel) and timed at the shapes one SD-1.5 512^2 training step gives the
backward (batch 8, 500 tokens; K1 at the 128^2 capture, K2 at a 96^2 one),
bf16; with --d64 at the d-64 shapes of SD-2.1 768^2 and SDXL 1024^2
training steps (K1 at 20 heads, SD-2.1 batch 4, SDXL 2; SDXL's
tensor-parallel rank, 10 of 20 heads; K2 at SD-2.1's 96^2 step); with
--precise the capture_fp32_bwd entry points:

  kernel        the kernels as committed
  (the next six cut the three-pass kernels: d 80 and 160, and the parent's
  d 64)
  no_g          g tiles copied for the first ring stages only (statistics
                and backward pass)
  no_q_copy     backward pass: q tiles copied for the first ring stages only
  no_dq_reduce  backward pass: the dq bulk reduce-adds skipped
  no_exp        every exponential replaced by a multiply
  stats_only    the statistics pass alone
  no_finish     the finishing pass (K1 dt, K2 dq to bf16) skipped
  rows_only     d 64: the rows pass alone (no keys pass, no sums)
  keys_only     d 64: the keys pass and the sums alone
  keys_no_g     d 64: keys-pass g tiles copied for the first ring stages only
  rows_wg3      d 64: three rows-pass warpgroups and 64-key tiles (two and 128
                as committed)
  mut_*         d 64 mutation checks, each one wait dropped (their results
                must be wrong): mut_rows_full the rows pass's k-tile wait,
                mut_keys_empty the keys pass's refill wait for a free stage,
                mut_keys_full the keys pass's wait for a tile's q and g
  parent        with --parent DIR: DIR/stablekeypoints_tpu_torch/kernels/csrc
                as it is (an earlier commit's kernels, for a same-card
                comparison)
  parent_rows   the parent without its keys kernel, where it has one (the
                split of its time between its rows and keys kernels)
  NAME          with --variant NAME=DIR: the csrc directory DIR as it is

--cuts A,B times only those variants (with `kernel`): a cut is a text
substitution into the kernel's source and fails the build where the source
no longer has that text. A variant's time against the kernel's bounds what
its part costs while the rest stays. Only `kernel` and `parent` compute the
right result; their dk and dt (dq) are held to the plain version (largest
difference over the plain gradient's largest magnitude), and so are the
mutation checks'. Each row prints the exponential floor (2*B*H*N*T ex2 at
16 a clock per SM at 1.98 GHz). Times are device times: CUDA events around
`--reps` calls queued behind a device-side spin, as chip_smoke.py times.
Needs a CUDA device and nvcc; imports no JAX.
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
_BWD_LAUNCH = "  capture_bwd_kernel<D, kPrecise><<<"
_FINISH = "  if constexpr (kQ) {\n    const long chunks"
_ROWS64 = "  capture_rows64_kernel<kQ, kPrecise><<<"
_KEYS64 = "  capture_keys64_kernel<kPrecise><<<"
_ROWS_FULL = ("      mbar_wait(&my_full[i % ST], (i / ST) & 1);\n"
              "      const bf16* kst = my_ks + (i % ST) * KTILE;\n")
_KEYS_EMPTY = "    if (it >= ST) mbar_wait(&empty[st], (it / ST - 1) & 1);\n"
_KEYS_FULL = "    mbar_wait(&full[st], (it / ST) & 1);\n    float s[32];"
_KEYS_TX = "    mbar_expect_tx(&full[st], kC6Tile * 2 + kC6GT * 4);"
_KEYS_G = "    for (int cb = 0; cb < kC6KB / 32; ++cb)\n      tma_load_2d(Gs + st * kC6GT"
VARIANTS = {  # name: [(file, old, new)]
    "kernel": [],
    "no_g": [
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
    # the d-64 rows and keys passes
    "rows_only": [("attn_capture.cu", _KEYS64, "  if (true) return 0;\n" + _KEYS64)],
    "keys_only": [("attn_capture.cu", _ROWS64, "  if (false) " + _ROWS64.strip())],
    "rows_wg3": [("attn_capture.cu", "constexpr int kC6RowWG = 2; ", "constexpr int kC6RowWG = 3; "),
                 ("attn_capture.cu", "constexpr int kC6RowKeys = 128; ", "constexpr int kC6RowKeys = 64;  ")],
    # mutation checks: a wait of the d-64 passes dropped (the result must be wrong)
    "mut_rows_full": [("attn_capture.cu", _ROWS_FULL, _ROWS_FULL.split("\n")[1] + "\n")],
    "mut_keys_empty": [("attn_capture.cu", _KEYS_EMPTY, "")],
    "mut_keys_full": [("attn_capture.cu", _KEYS_FULL, _KEYS_FULL.split("\n")[1])],
    "keys_no_g": [("attn_capture.cu", _KEYS_TX, _KEYS_TX.replace("kC6GT * 4", "(it < ST) * kC6GT * 4")),
                  ("attn_capture.cu", _KEYS_G, _KEYS_G.replace("cb < kC6KB / 32", "cb < (it < ST ? kC6KB / 32 : 0)"))],
}
_PARENT_KEYS = "  capture_bwd_keys_kernel<D, kQ><<<"
T = 500
# (label, B, H, K1 x or None for K2, D, launches per step, total_heads)
CASES = (("K1", 8, 8, 16, 160, 3, 8), ("K1", 8, 8, 32, 80, 1, 8), ("K2", 8, 8, None, 160, 3, 8),
         ("K2", 8, 8, None, 80, 1, 8))
CASES_D64 = (("K1@sd21", 4, 20, 24, 64, 3, 20), ("K1@sdxl", 2, 20, 32, 64, 3, 20),
             ("K1@sdxl_tp", 2, 10, 32, 64, 3, 20), ("K2@sd21", 4, 20, None, 64, 3, 20))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="a checkout of an earlier commit to time beside")
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--variant", action="append", default=[], metavar="NAME=DIR",
                        help="also time the kernels of another csrc directory (same entry points)")
    parser.add_argument("--d64", action="store_true", help="the SD-2.x / SDXL d-64 shapes")
    parser.add_argument("--cuts", help="comma-separated variants to time (default: all)")
    parser.add_argument("--precise", action="store_true", help="the capture_fp32_bwd kernels")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("capture_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from stablekeypoints_tpu_torch.kernels import _build, attn_capture
    from stablekeypoints_tpu_torch.kernels._common import stream_handle
    from stablekeypoints_tpu_torch.ops.resize import resize_matrix

    cuts = set(args.cuts.split(",")) | {"kernel"} if args.cuts else set(VARIANTS)
    variants = {n: (CSRC, subs) for n, subs in VARIANTS.items() if n in cuts}
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

    sfx = "_precise" if args.precise else ""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, B, H, x, d, count, total in CASES_D64 if args.d64 else CASES:
        scale = d ** -0.5
        k = randn(B, T, H, d)
        n = 128 * 128 if x else 96 * 96
        g = torch.randn((B, n, T), generator=gen, device="cuda") * 1e-3
        lse, c = (torch.empty((B, H, n), device="cuda") for _ in range(2))
        acc = torch.empty((B, H, n, d), device="cuda")
        dk = torch.empty_like(k)
        if x:
            tt, ww = randn(B, H, 128, x, d), resize_matrix(x, 128, "bicubic", bf, "cuda")
            q, out = torch.empty((B, H, n, d), dtype=bf, device="cuda"), torch.empty_like(tt)
            shape = f"tt[{B},{H},128,{x},{d}]"
            want = attn_capture.capture_fused_bwd_plain(tt, ww, k, g, scale, args.precise, total)
        else:
            q = randn(B, H, n, d)
            out = torch.empty_like(q)
            shape = f"q[{B},{H},{n},{d}]"
            want = attn_capture.capture_bwd_plain(q, k, g, scale, args.precise, total)
        want = [w.float() for w in want]
        floor = 2 * B * H * n * T / (16 * sms * 1.98e9) * 1e3

        def rel(got, ref):
            return ((got.float() - ref).abs().max() / ref.abs().max()).item()

        for name, lib in libs.items():
            if x:
                fn = getattr(lib, "skp_capture_bwd" + sfx)
                if name in old_abi:
                    ptrs, ints = [p(a) for a in (tt, ww, k, g, lse, c, out, dk)], [B, H, 128, x, 128, T, d]
                else:
                    ptrs = [p(a) for a in (tt, ww, k, g, q, lse, c, acc, out, dk)]
                    ints = [B, H, 128, x, 128, T, T, d]
            else:
                fn = getattr(lib, "skp_capture_q_bwd" + sfx)
                if name in old_abi:
                    ptrs, ints = [p(a) for a in (q, k, g, lse, c, out, dk)], [B, H, n, T, d]
                else:
                    ptrs, ints = [p(a) for a in (q, k, g, lse, c, acc, out, dk)], [B, H, n, T, T, d]
            # total_heads last: an entry built before it took that argument
            # ignores the trailing integer
            fn.argtypes = [P] * len(ptrs) + [I] * len(ints) + [F, P, I]
            fn.restype = I

            def call(fn=fn, ptrs=ptrs, ints=ints):
                assert fn(*ptrs, *ints, scale, stream_handle(), total) == 0

            ms = device_ms(torch, call, args.reps)
            extra = ""
            if name in ("kernel", "parent") or name not in VARIANTS or name.startswith("mut_"):
                extra = f"  err dt/dq {rel(out, want[0]):.2e} dk {rel(dk, want[1]):.2e}"
            print(f"{label} bwd{sfx} {shape} x{count} {name:<13} {ms:.4f} ms{extra}"
                  f"  ex2 floor {floor:.3f} ms", flush=True)
        del q, out, acc, g, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
