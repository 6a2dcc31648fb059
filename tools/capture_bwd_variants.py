"""Where the K1/K2 capture backward's time goes: time ablated copies of the
PyTorch port's capture backward CUDA kernels on one NVIDIA GPU.

    python3 tools/capture_bwd_variants.py [--parent DIR] [--reps 10] [--d64] [--cuts A,B]
        [--precise] [--tp] [--x24] [--tokens]

Each variant is `stablekeypoints_tpu_torch/kernels/csrc/` with one part
changed by a text substitution, built with nvcc into its own library
(`attn_capture.cu`) under build/capture_bwd_variants/ (all builds in
parallel) and timed at the shapes one SD-1.5 512^2 training step gives the
backward (batch 8, 500 tokens; K1 at the 128^2 capture, d 160 x3 and d 80
x1; K2 at a 96^2 one), bf16; with --tp at a tensor-parallel rank's heads (4
of 8); with --d64 at the d-64 shapes of SD-2.1 768^2 and SDXL 1024^2
training steps (K1 at 20 heads, SD-2.1 batch 4, SDXL 2; SDXL's
tensor-parallel rank, 10 of 20 heads; K2 at SD-2.1's 96^2 step); with
--precise the capture_fp32_bwd entry points; --x24 adds K1 at SD-1.5
768^2's up_1 (X 24, where the rows pass reads tt from device memory);
--tokens adds the step's shapes at 1000 tokens (K1 and K2; the rows pass on
clusters of two blocks) and K1 at a 256^2 capture (four 64-column tiles a
row), the mutation checks left out (a parent that refuses them prints
"refused"):

  kernel        the kernels as committed
  no_exp        every exponential replaced by a multiply
  rows_only     the rows pass alone (no keys pass, no sums)
  keys_only     the keys pass and the sums alone
  no_dt         K1: the rows pass's dt products and stores skipped (its
                bf16(dq) staging kept)
  keys_no_g     keys-pass g tiles copied for the first ring stages only
  x_nodq        past 512 tokens: the rows pass's partial dq neither stored
                for the cluster nor summed (its dq or dt products skipped),
                the exchange's waits kept
  x_nowait      past 512 tokens: the rows pass's three waits for the other
                blocks of its cluster dropped (statistics, partial dq
                written, partial dq read)
  mut_*         mutation checks, each one wait dropped (their results must
                be wrong): mut_rows_full the rows pass's k-tile wait,
                mut_keys_empty the keys pass's refill wait for a free stage,
                mut_keys_full the keys pass's wait for a tile's q and g
                (at d 160 it hung the first case: leave it out of --cuts)
  parent        with --parent DIR: DIR/stablekeypoints_tpu_torch/kernels/csrc
                as it is (an earlier commit's kernels with the same entry
                points, for a same-card comparison)
  NAME          with --variant NAME=DIR: the csrc directory DIR as it is

--cuts A,B times only those variants (with `kernel`): a cut is a text
substitution into the kernel's source and fails the build where the source
no longer has that text. A variant's time against the kernel's bounds what
its part costs while the rest stays. Only `kernel` and `parent` compute the
right result; their dk and dt (dq) are held to the plain version (largest
difference over the plain gradient's largest magnitude), and so are the
mutation checks'; `kernel` and `parent` also say whether two launches are
bitwise equal. Each row prints the exponential floor (3*B*H*N*T ex2, one
in each sweep of the rows pass and one in the keys pass, at 16 a clock per
SM at 1.98 GHz). Times are device times: CUDA events around
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
_ROWS = "  rows_kernel<<<"
_ROWS_CL = "const int e = launch_clustered(rows_kernel,"
_KEYS = "  capture_keys_kernel<D, kPrecise><<<"
_DT = "        for (int jc = warp; jc < D / 8; jc += 4) {"
_ROWS_FULL = ("      mbar_wait(&my_full[i % ST], (i / ST) & 1);\n"
              "      const bf16* kst = my_ks + (i % ST) * KTILE;\n")
_KEYS_EMPTY = "    if (it >= ST) mbar_wait(&empty[st], (it / ST - 1) & 1);\n"
_KEYS_FULL = "    mbar_wait(&full[st], (it / ST) & 1);\n    float s[32];"
_KEYS_TX = "    mbar_expect_tx(&full[st], TILE * 2 + GT * 4);"
_KEYS_G = "    for (int cb = 0; cb < KB / 32; ++cb)\n      tma_load_2d(Gs + st * GT"
VARIANTS = {  # name: [(file, old, new)]
    "kernel": [],
    "no_exp": [("common.cuh", 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                "y = x * 0.999f;")],
    "rows_only": [("attn_capture.cu", _KEYS, "  if (true) return 0;\n" + _KEYS)],
    "keys_only": [("attn_capture.cu", _ROWS, "  if (false) " + _ROWS.strip()),
                  ("attn_capture.cu", _ROWS_CL, _ROWS_CL.replace("= ", "= true ? 0 : "))],
    "no_dt": [("attn_capture.cu", _DT, _DT.replace("jc < D / 8", "jc < 0 * D"))],
    "keys_no_g": [("attn_capture.cu", _KEYS_TX, _KEYS_TX.replace("GT * 4", "(it < ST) * GT * 4")),
                  ("attn_capture.cu", _KEYS_G, _KEYS_G.replace("cb < KB / 32", "cb < (it < ST ? KB / 32 : 0)"))],
    "x_nodq": [("attn_capture.cu", "part[C::part_at(8 * jj + 2 * t + e, row0 + 8 * r)] = dq[4 * jj + 2 * r + e];",
                "(void)0;"),
               ("attn_capture.cu", "jc < D / 8; jc += ncl", "jc < 0 * D; jc += ncl"),
               ("attn_capture.cu", "jc < D / 8; jc += 4 * ncl", "jc < 0 * D; jc += 4 * ncl")],
    "x_nowait": [("attn_capture.cu", "mbar_wait_cluster(&stat_full[2 * wg + (j & 1)], (j >> 1) & 1);", ""),
                 ("attn_capture.cu", "mbar_wait_cluster(&part_full[wg], j & 1);", ""),
                 ("attn_capture.cu", "mbar_wait_cluster(&part_empty[wg], j & 1);", "")],
    # mutation checks: a wait of the passes dropped (the result must be wrong)
    "mut_rows_full": [("attn_capture.cu", _ROWS_FULL, _ROWS_FULL.split("\n")[1] + "\n")],
    "mut_keys_empty": [("attn_capture.cu", _KEYS_EMPTY, "")],
    "mut_keys_full": [("attn_capture.cu", _KEYS_FULL, _KEYS_FULL.split("\n")[1])],
}
T = 500
# (label, B, H, K1 x or None for K2, D, launches per step, total_heads[,
# tokens, K1's capture res])
CASES = (("K1", 8, 8, 16, 160, 3, 8), ("K1", 8, 8, 32, 80, 1, 8), ("K2", 8, 8, None, 160, 3, 8),
         ("K2", 8, 8, None, 80, 1, 8))
CASES_TOKENS = (("K1@t1000", 8, 8, 16, 160, 3, 8, 1000, 128), ("K1@t1000", 8, 8, 32, 80, 1, 8, 1000, 128),
                ("K2@t1000", 8, 8, None, 160, 3, 8, 1000, 128), ("K1@p256", 8, 8, 16, 160, 3, 8, T, 256),
                ("K1@p256", 8, 8, 32, 80, 1, 8, T, 256))
# up_1 of a 768^2 step (X 24: K1's rows pass reads tt from device memory)
CASES_X24 = (("K1", 8, 8, 24, 160, 3, 8),)
CASES_TP = tuple((label + "@tp", b, 4, x, d, count, 8) for label, b, _, x, d, count, _ in CASES)
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
    parser.add_argument("--tp", action="store_true", help="SD-1.5 at a tensor-parallel rank's heads")
    parser.add_argument("--x24", action="store_true", help="also K1 at SD-1.5 768^2's up_1 (X 24)")
    parser.add_argument("--tokens", action="store_true",
                        help="also 1000 tokens (K1, K2) and K1 at a 256^2 capture")
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
    if args.parent:
        variants["parent"] = (os.path.join(args.parent, "stablekeypoints_tpu_torch", "kernels", "csrc"), [])
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
    cases = CASES_D64 if args.d64 else CASES_TP if args.tp else CASES
    for label, B, H, x, d, count, total, *more in (cases + (CASES_X24 if args.x24 else ())
                                                   + (CASES_TOKENS if args.tokens else ())):
        t, res = more or (T, 128)
        scale = d ** -0.5
        k = randn(B, t, H, d)
        n = res * res if x else 96 * 96
        g = torch.randn((B, n, t), generator=gen, device="cuda") * 1e-3
        lse, c = (torch.empty((B, H, n), device="cuda") for _ in range(2))
        acc = torch.empty((B, H, n, d), device="cuda")
        dk = torch.empty_like(k)
        if x:
            tt, ww = randn(B, H, res, x, d), resize_matrix(x, res, "bicubic", bf, "cuda")
            q, out = torch.empty((B, H, n, d), dtype=bf, device="cuda"), torch.empty_like(tt)
            shape = f"tt[{B},{H},{res},{x},{d}] T {t}"
            want = attn_capture.capture_fused_bwd_plain(tt, ww, k, g, scale, args.precise, total)
        else:
            q = randn(B, H, n, d)
            out = torch.empty_like(q)
            shape = f"q[{B},{H},{n},{d}] T {t}"
            want = attn_capture.capture_bwd_plain(q, k, g, scale, args.precise, total)
        want = [w.float() for w in want]
        floor = 3 * B * H * n * t / (16 * sms * 1.98e9) * 1e3

        def rel(got, ref):
            return ((got.float() - ref).abs().max() / ref.abs().max()).item()

        gk, ldg = attn_capture.g_rows(g)
        kept = {}
        for name, lib in libs.items():
            if more and name.startswith("mut_"):  # a dropped wait may hang a cluster
                continue
            if x:
                fn = getattr(lib, "skp_capture_bwd" + sfx)
                ptrs = [p(a) for a in (tt, ww, k, gk, q, lse, c, acc, out, dk)]
                ints = [B, H, res, x, res, t, ldg, d]
            else:
                fn = getattr(lib, "skp_capture_q_bwd" + sfx)
                ptrs, ints = [p(a) for a in (q, k, gk, lse, c, acc, out, dk)], [B, H, n, t, ldg, d]
            fn.argtypes = [P] * len(ptrs) + [I] * len(ints) + [F, P, I]
            fn.restype = I

            def call(fn=fn, ptrs=ptrs, ints=ints):
                assert fn(*ptrs, *ints, scale, stream_handle(), total) == 0

            rc = fn(*ptrs, *ints, scale, stream_handle(), total)
            if rc != 0:  # a tree whose kernels do not take this shape
                print(f"{label} bwd{sfx} {shape} x{count} {name:<13} refused ({rc})", flush=True)
                continue
            ms = device_ms(torch, call, args.reps)
            extra = ""
            if name in ("kernel", "parent") or name not in VARIANTS or name.startswith("mut_"):
                extra = f"  err dt/dq {rel(out, want[0]):.2e} dk {rel(dk, want[1]):.2e}"
            if name in ("kernel", "parent") or name not in VARIANTS:
                first = (out.clone(), dk.clone())
                call()
                torch.cuda.synchronize()
                same = torch.equal(first[0], out) and torch.equal(first[1], dk)
                extra += f"  two launches bitwise equal: {same}"
                if name in ("kernel", "parent"):
                    kept[name] = first
                if name == "parent" and "kernel" in kept:
                    extra += ("  bitwise the kernel's: " +
                              str(all(torch.equal(a, b) for a, b in zip(kept["kernel"], first))))
                del first
            print(f"{label} bwd{sfx} {shape} x{count} {name:<13} {ms:.4f} ms{extra}"
                  f"  ex2 floor {floor:.3f} ms", flush=True)
        del q, out, acc, g, gk, want, kept
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
