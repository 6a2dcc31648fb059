"""Where K7's time goes: time ablated copies of the PyTorch port's fused
GroupNorm + SiLU + 3x3 conv CUDA kernel on one NVIDIA GPU, and read clock
stamps of its waits.

    python3 tools/gn_conv_variants.py [--size 512|768|1024] [--parent DIR] [--variant NAME=DIR]
                                      [--cuts no_mma,...] [--reps 10] [--stamps] [--unfused]

Each variant is `stablekeypoints_tpu_torch/kernels/csrc/` with one part
changed by a text substitution, built with nvcc into its own library
(`gn_conv.cu`) under build/gn_conv_variants/ (all builds in parallel) and
timed at the 10 shapes one VAE encode gives K7 (10 views, bf16, with the
residual where the encoder adds one): SD-1.5 at 512^2, or with --size the
same levels scaled to SD-2.x's 768^2 or SDXL's 1024^2:

  kernel     the kernel as committed
  no_norm    the GN affine + SiLU arithmetic skipped (its loads and stores stay)
  no_mma     the tensor-core products skipped (loads, normalize, epilogue)
  no_wcopy   weight tiles copied for each block's first tile only
  no_patch   raw patches copied for the first two chunks only
  no_store   the epilogue's bias, residual and output stores skipped
  tw64       W 96 in tiles 64 columns wide (a quarter of the columns
             padding) in place of the 128-channel kernel's 32-column tiles or the 8 x 8
             blocks of the 256-channel kernel
  bn128      tiles of 128 output channels at every Cout (256 where Cout allows)
  parent     with --parent DIR: DIR/stablekeypoints_tpu_torch/kernels/csrc
             as it is (an earlier commit's kernel, for a same-card
             comparison), and parent_<cut> for each cut its text admits
  NAME       with --variant NAME=DIR: the csrc directory DIR as it is
  unfused    with --unfused: the path K7 replaces, K6's apply + cuDNN's conv
             with bias (+ the residual add), less K6's coefficient launch
             (K7 takes the coefficients as inputs), as chip_smoke.py times it

A cut's text is looked up in the current design's substitutions first,
then in the previous design's (the kernel before the TMA-store
epilogue), so one table serves the kernel and a --parent tree; a cut that
neither matches is skipped with a note. --cuts limits the cuts built (of
the kernel and the parent) to those named.

--stamps adds `stamps` (and `parent_stamps`) builds: clock64() read around
each wait of each role, summed a warp in shared memory and copied to a
device array at the kernel's end (never in the committed kernel). One
launch a shape is read back and printed in clocks a tap: for the product
warps the patch `pfull` wait, the weight stage's `full` wait, the product
issue, the product wait (`wgmma_wait1`; at TW < 64, where the products are
synchronous, issue and wait together), the stage `release` path, the
tile-end drain, the epilogue and everything else (`other`); for the patch
warpgroup its `pempty` wait, the raw-patch copy issue, the coefficient
loads, the wait for its copies and the normalize. `total` is a warp's
clocks from its start to its end over its taps. The last lines weight each
shape by its launches in an encode.

A variant's time against the kernel's bounds what its part costs while the
rest stays. Only `kernel`, `parent`, `stamps` and other whole trees compute
the right result: each row prints its error against the plain version.
Times are device times: CUDA events around `--reps` calls queued behind a
device-side spin, as chip_smoke.py times. The last column sums each variant
over the 20 launches of one encode. Needs a CUDA device and nvcc; imports
no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys

from variant_build import build, card, device_ms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "stablekeypoints_tpu_torch", "kernels", "csrc")
OUT = os.path.join(REPO, "build", "gn_conv_variants")

# the same cuts in the previous design's text (before the TMA-store epilogue)
PARENT_VARIANTS = {
    "no_norm": [("gn_conv.cu", "  __nv_bfloat162 t = *reinterpret_cast<__nv_bfloat162*>(&v);\n",
                 "  return v;\n  __nv_bfloat162 t = *reinterpret_cast<__nv_bfloat162*>(&v);\n")],
    "no_mma": [("gn_conv.cu", "              gc_mma_ss<BN>(acc[j], da,",
                "              if (W < 0) gc_mma_ss<BN>(acc[j], da,")],
    "no_wcopy": [("gn_conv.cu", "    mbar_expect_tx(&full[st], WT * 2);\n",
                  "    if (nt.k > 0) {\n      mbar_arrive(&full[st]);\n      return;\n    }\n"
                  "    mbar_expect_tx(&full[st], WT * 2);\n")],
    "no_patch": [("gn_conv.cu", "        cp_async16(buf + (cg * NP + q) * 8,",
                  "        if (C < 2) cp_async16(buf + (cg * NP + q) * 8,")],
    "no_store": [("gn_conv.cu", "    // epilogue: round, + bias (bf16), + residual (bf16), store\n",
                  "    if (W > 0) continue;\n")],
    "tw64": [("gn_conv.cu", "  if (W % 64 == 0) return", "  if (W >= 64) return")],
    "bn128": [("gn_conv.cu", "  if (Cout % 256 == 0)\n", "  if (Cout < 0)\n")],
}
CUTS = ("no_norm", "no_mma", "no_wcopy", "no_patch", "no_store", "tw64", "bn128")
VARIANTS = {  # name: [(file, old, new)], the current design's text
    # the same texts in both kernels (256- and 128-channel tiles): each cut
    # applies to both
    **{cut: PARENT_VARIANTS[cut] for cut in ("no_norm", "no_wcopy", "tw64", "bn128")},
    "no_mma": [("gn_conv.cu", "            gc_mma_ss<BN>(acc[j], da,",
                "            if (W < 0) gc_mma_ss<BN>(acc[j], da,")],
    "no_patch": [("gn_conv.cu", "      if (i_n < tiles) fetch(tile_at(i_n), c_n);\n",
                  "      if (i_n < tiles && C < 1) fetch(tile_at(i_n), c_n);\n"),
                 *PARENT_VARIANTS["no_patch"]],
    "no_store": [("gn_conv.cu", "    mbar_wait(&sfull[wg], k & 1);\n",
                  "    mbar_wait(&sfull[wg], k & 1);\n    if (W > 0) continue;\n"),
                 ("gn_conv.cu", "    if (with_res) {\n      mbar_expect_tx(&sfull[wg]",
                  "    if (with_res && W < 0) {\n      mbar_expect_tx(&sfull[wg]"),
                 *PARENT_VARIANTS["no_store"]],
}

# The stamped build. GC_MARK(k) adds the clocks since the previous mark to
# slot k of this warp (lane 0, 12 slots a warp in 640 bytes of shared memory
# past the kernel's own); GC_WRITE() copies them to
# skp_gc_stamps[block][warp][0..11] with slot 9 its clocks from start to end.
# Slot 8 counts taps (products) or chunks (patches).
STAMP_DECLS = (
    "__device__ unsigned skp_gc_stamps[1024 * 12 * 16];\n"
    "#define GC_MARK(k) do { const long long n_ = clock64(); "
    "if (lane == 0) gc_st[k] += unsigned(n_ - gc_last); gc_last = n_; } while (0)\n"
    "#define GC_COUNT() do { if (lane == 0) gc_st[8] += 1; } while (0)\n"
    "#define GC_WRITE() do { if (lane == 0) { gc_st[9] = unsigned(clock64() - gc_t0); "
    "for (int k_ = 0; k_ < 12; ++k_) "
    "skp_gc_stamps[(blockIdx.x * 12 + tid / 32) * 16 + k_] = gc_st[k_]; } } while (0)\n")
STAMP_INIT = ("  unsigned* gc_st = reinterpret_cast<unsigned*>(smem + (Cfg::smem + 15) / 16 * 16)"
              " + (tid / 32) * 12;\n"
              "  if (lane == 0)\n    for (int k_ = 0; k_ < 12; ++k_) gc_st[k_] = 0;\n"
              "  long long gc_t0 = clock64(), gc_last = gc_t0;\n")
STAMP_READER = (
    "// the stamps of the last launch into host (bytes), or zeroed (host null)\n"
    "extern \"C\" int skp_gn_conv_stamps(void* host, int bytes) {\n"
    "  void* dev = nullptr;\n"
    "  cudaError_t e = cudaGetSymbolAddress(&dev, skp::skp_gc_stamps);\n"
    "  if (e == cudaSuccess) e = host ? cudaMemcpy(host, dev, bytes, cudaMemcpyDeviceToHost)\n"
    "                                 : cudaMemset(dev, 0, bytes);\n"
    "  return (int)e;\n}\n\n")
STAMP_LAUNCH = [
    ("gn_conv.cu", "cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::smem);",
     "cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::smem + 640);"),
    ("gn_conv.cu", "<<<grid, kGcThreads, C::smem, stream>>>",
     "<<<grid, kGcThreads, C::smem + 640, stream>>>"),
    ("gn_conv.cu", "extern \"C\" int skp_gn_conv(", STAMP_READER + "extern \"C\" int skp_gn_conv("),
]
# product slots: 0 other, 1 pfull, 2 full, 3 issue, 4 wait, 5 release, 6 drain,
# 7 epilogue, 10 the staging's turn-around inside the walk (stage_in); patch
# slots: 0 other, 1 pempty, 2 copy (cp.async, or the register loads' issue),
# 3 coef, 4 cpwait (the copies' wait; the register loads' shows in norm), 5 norm
# (the parent's in place; the current design's in registers), 6 store (the
# current design's buffer writes)
PRODUCT_SLOTS = {0: "other", 1: "pfull", 2: "full", 3: "issue", 4: "wait", 5: "release",
                 6: "drain", 7: "epi", 10: "stage"}
PATCH_SLOTS = {0: "other", 1: "pempty", 2: "copy", 3: "coef", 4: "cpwait", 5: "norm",
               6: "store"}
# the marks in the previous design's text (before the TMA-store epilogue)
PARENT_STAMPS = [
    ("gn_conv.cu", "constexpr int kGcMmaWarps = 8;", STAMP_DECLS + "constexpr int kGcMmaWarps = 8;"),
    ("gn_conv.cu", "  const int taps = 9 * chunks;  // a tile's walk\n",
     "  const int taps = 9 * chunks;  // a tile's walk\n" + STAMP_INIT),
    ("gn_conv.cu", "      if (C >= NB) mbar_wait(&pempty[C % NB], (C / NB + 1) & 1);\n",
     "      GC_MARK(0);\n      if (C >= NB) mbar_wait(&pempty[C % NB], (C / NB + 1) & 1);\n"
     "      GC_MARK(1);\n"),
    ("gn_conv.cu", "      cp_async_commit();\n    };\n",
     "      cp_async_commit();\n      GC_MARK(2);\n    };\n"),
    ("gn_conv.cu", "    for (int C = 0; i < tiles; ++C) {\n      const Tile T = tile_at(i);\n",
     "    for (int C = 0; i < tiles; ++C) {\n      GC_MARK(0);\n      const Tile T = tile_at(i);\n"),
    ("gn_conv.cu", "        cb[e] = __floats2bfloat162_rn(gb[at + 2 * e], gb[at + 2 * e + 1]);\n"
                   "      }\n",
     "        cb[e] = __floats2bfloat162_rn(gb[at + 2 * e], gb[at + 2 * e + 1]);\n"
     "      }\n      GC_MARK(3);\n"),
    ("gn_conv.cu", "        cp_async_wait_all();\n      }\n",
     "        cp_async_wait_all();\n      }\n      GC_MARK(4);\n"),
    ("gn_conv.cu", "      mbar_arrive(&pfull[C % NB]);\n",
     "      mbar_arrive(&pfull[C % NB]);\n      GC_MARK(5);\n      GC_COUNT();\n"),
    ("gn_conv.cu", "      c = c_n;\n    }\n    return;\n",
     "      c = c_n;\n    }\n    GC_MARK(0);\n    GC_WRITE();\n    return;\n"),
    ("gn_conv.cu", "  int G = 0;\n", "  int G = 0;\n  GC_MARK(0);\n"),
    ("gn_conv.cu", "      mbar_wait(&pfull[C % NB], (C / NB) & 1);\n",
     "      GC_MARK(0);\n      mbar_wait(&pfull[C % NB], (C / NB) & 1);\n      GC_MARK(1);\n"),
    ("gn_conv.cu", "        mbar_wait(&full[G % R], (G / R) & 1);\n",
     "        GC_MARK(0);\n        mbar_wait(&full[G % R], (G / R) & 1);\n        GC_MARK(2);\n"
     "        GC_COUNT();\n"),
    ("gn_conv.cu", "          wgmma_wait1();\n", "          GC_MARK(3);\n          wgmma_wait1();\n"),
    ("gn_conv.cu", "        if (c > 0 || tap > 0) release(G - 1);  // the tile's previous tap\n",
     "        GC_MARK(4);\n        if (c > 0 || tap > 0) release(G - 1);  // the tile's previous tap\n"
     "        GC_MARK(5);\n"),
    ("gn_conv.cu", "    wgmma_wait0();\n#pragma unroll\n    for (int j = 0; j < RS; ++j) reg_fence(acc[j]);\n"
                   "    release(G - 1);\n    if (lane == 0) mbar_arrive(&pempty[(C - 1) % NB]);\n",
     "    GC_MARK(0);\n    wgmma_wait0();\n#pragma unroll\n    for (int j = 0; j < RS; ++j) reg_fence(acc[j]);\n"
     "    release(G - 1);\n    if (lane == 0) mbar_arrive(&pempty[(C - 1) % NB]);\n    GC_MARK(6);\n"),
    ("gn_conv.cu", "    for (int j = 0; j < RS; ++j) reg_fence(acc[j]);\n  }\n}\n",
     "    for (int j = 0; j < RS; ++j) reg_fence(acc[j]);\n    GC_MARK(7);\n  }\n  GC_MARK(0);\n"
     "  GC_WRITE();\n}\n"),
] + STAMP_LAUNCH
# the marks in the current design's text
STAMPS = [
    PARENT_STAMPS[0], PARENT_STAMPS[1],  # the declarations, the slots
    ("gn_conv.cu", "    for (int C = 0; i < tiles; ++C) {\n      const int i_n",
     "    for (int C = 0; i < tiles; ++C) {\n      GC_MARK(0);\n      const int i_n"),
    ("gn_conv.cu", "          raw[k] = uint4{0, 0, 0, 0};\n        }\n      }\n",
     "          raw[k] = uint4{0, 0, 0, 0};\n        }\n      }\n      GC_MARK(5);\n"),
    ("gn_conv.cu", "      if (C >= NB) mbar_wait(&pempty[C % NB], (C / NB + 1) & 1);\n",
     "      if (C >= NB) mbar_wait(&pempty[C % NB], (C / NB + 1) & 1);\n      GC_MARK(1);\n"),
    ("gn_conv.cu", "      mbar_arrive(&pfull[C % NB]);\n",
     "      mbar_arrive(&pfull[C % NB]);\n      GC_MARK(6);\n      GC_COUNT();\n"),
    ("gn_conv.cu", "      if (i_n < tiles) fetch(tile_at(i_n), c_n);\n",
     "      if (i_n < tiles) fetch(tile_at(i_n), c_n);\n      GC_MARK(2);\n"),
    PARENT_STAMPS[8],  # the patch warpgroup's end
    PARENT_STAMPS[9], PARENT_STAMPS[10], PARENT_STAMPS[11],  # the products' start, pfull, full
    ("gn_conv.cu", "        wgmma_wait1();\n", "        GC_MARK(3);\n        wgmma_wait1();\n        GC_MARK(4);\n"),
    ("gn_conv.cu", "        if (c > 0 || tap > 0) release(G - 1);  // the tile's previous tap\n",
     "        if (c > 0 || tap > 0) release(G - 1);  // the tile's previous tap\n        GC_MARK(5);\n"),
    ("gn_conv.cu", "        if (c * 9 + tap == stage_at && lead) stage_in(T);\n",
     "        GC_MARK(0);\n        if (c * 9 + tap == stage_at && lead) stage_in(T);\n"
     "        GC_MARK(10);\n"),
    ("gn_conv.cu", "    wgmma_wait0();\n#pragma unroll\n    for (int j = 0; j < RS; ++j) reg_fence(acc[j]);\n"
                   "    release(G - 1);\n    if (lead) mbar_arrive(&pempty[(C - 1) % NB]);\n",
     "    GC_MARK(0);\n    wgmma_wait0();\n#pragma unroll\n    for (int j = 0; j < RS; ++j) reg_fence(acc[j]);\n"
     "    release(G - 1);\n    if (lead) mbar_arrive(&pempty[(C - 1) % NB]);\n    GC_MARK(6);\n"),
    ("gn_conv.cu", "      bulk_commit();\n    }\n", "      bulk_commit();\n    }\n    GC_MARK(7);\n"),
    ("gn_conv.cu", "  if (lead) bulk_wait_read<0>();  // the staging stays",
     "  GC_MARK(0);\n  GC_WRITE();\n  if (lead) bulk_wait_read<0>();  // the staging stays"),
] + STAMP_LAUNCH

# (H = W, Cin, Cout, residual, launches per encode), as chip_smoke.GN_CONV_SHAPES
SHAPES = ((512, 128, 128, False, 2), (512, 128, 128, True, 2), (256, 128, 256, False, 1),
          (256, 256, 256, False, 1), (256, 256, 256, True, 2), (128, 256, 512, False, 1),
          (128, 512, 512, False, 1), (128, 512, 512, True, 2), (64, 512, 512, False, 4),
          (64, 512, 512, True, 4))


def _subs_for(text: str, *options):
    """The first of `options` (lists of substitutions) whose every old text
    is in `text`, or None."""
    for subs in options:
        if subs and all(old in text for _, old, _ in subs):
            return subs
    return None


def _grid(b: int, hw: int, cout: int, sms: int) -> int:
    """The kernel's persistent grid at [b, hw, hw] -> cout (its launcher's
    tile geometry)."""
    bn = 256 if cout % 256 == 0 else 128
    tw = 64 if hw % 64 == 0 else (32 if hw >= 32 else 16)
    th = 32768 // bn // tw
    tiles = -(-hw // th) * -(-hw // tw) * (cout // bn) * b
    return min(tiles, sms)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="a checkout of an earlier commit to time beside")
    parser.add_argument("--variant", action="append", default=[], metavar="NAME=DIR",
                        help="also time the kernel of another csrc directory (same entry point)")
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--size", type=int, default=512, choices=(512, 768, 1024),
                        help="the encode's image size (levels scaled from 512^2)")
    parser.add_argument("--cuts", default=",".join(CUTS),
                        help="comma-separated cuts to build (empty: none)")
    parser.add_argument("--stamps", action="store_true", help="also the stamped builds")
    parser.add_argument("--unfused", action="store_true", help="also time the unfused path")
    args = parser.parse_args()
    cuts = [c for c in args.cuts.split(",") if c]

    import torch

    if not torch.cuda.is_available():
        print("gn_conv_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import torch.nn.functional as F

    from stablekeypoints_tpu_torch.kernels import _build, gn_conv, groupnorm
    from stablekeypoints_tpu_torch.kernels._common import ptr, stream_handle

    trees = {"": CSRC}
    if args.parent:
        trees["parent_"] = os.path.join(args.parent, "stablekeypoints_tpu_torch", "kernels", "csrc")
    variants = {}
    for prefix, tree in trees.items():
        with open(os.path.join(tree, "gn_conv.cu")) as f:
            text = f.read()
        variants[prefix + "kernel" if not prefix else "parent"] = (tree, [])
        for cut in cuts + (["stamps"] if args.stamps else []):
            subs = (_subs_for(text, STAMPS, PARENT_STAMPS) if cut == "stamps"
                    else _subs_for(text, VARIANTS.get(cut), PARENT_VARIANTS.get(cut)))
            if subs is None:
                print(f"[build] {prefix}{cut}: its text is not in {tree}/gn_conv.cu: skipped",
                      flush=True)
            else:
                variants[prefix + cut] = (tree, subs)
    for spec in args.variant:
        name, _, path = spec.partition("=")
        variants[name] = (os.path.abspath(path), [])
    built = build(_build._nvcc_path(), OUT, variants, ("gn_conv",))
    libs = {n: ls["gn_conv"] for n, ls in built.items()}
    print(card())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    totals = {n: 0.0 for n in list(libs) + (["unfused"] if args.unfused else [])}
    stamp_sums = {n: [0.0] * 32 for n in libs if n.endswith("stamps")}
    for hw, cin, cout, with_res, count in SHAPES:
        b, hw = 10, hw * args.size // 512
        x = (torch.randn((b, hw, hw, cin), generator=gen, device="cuda") * 1.5 + 0.3).to(bf)
        gw, gb = torch.ones(cin, device="cuda"), torch.zeros(cin, device="cuda")
        m, a, bc = groupnorm.gn_affine_coeffs(x, gw, gb, 32, 1e-6)
        w = torch.randn((cout, 3, 3, cin), generator=gen, device="cuda") * (9 * cin) ** -0.5
        w = w.to(bf)
        bias = (torch.randn(cout, generator=gen, device="cuda") * 0.1).to(bf)
        res = torch.randn((b, hw, hw, cout), generator=gen, device="cuda").to(bf) if with_res else None
        want = gn_conv.fused_gn_silu_conv3x3_plain(x, m, a, bc, w.permute(1, 2, 3, 0), bias,
                                                   res).float()
        label = f"x[{b},{hw},{hw},{cin}]->{cout}{' +res' if with_res else ''}"
        for name, lib in libs.items():
            out = torch.zeros((b, hw, hw, cout), device="cuda", dtype=bf)
            fn = lib.skp_gn_conv
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def run(fn=fn, out=out):
                rc = fn(ptr(x), ptr(m), ptr(a), ptr(bc), ptr(w), ptr(bias),
                        None if res is None else ptr(res), ptr(out), b, hw, hw, cin, cout,
                        stream_handle())
                assert rc == 0, rc

            ms = device_ms(torch, run, args.reps)
            err = ((out.float() - want).abs().max() / want.abs().max()).item()
            totals[name] += count * ms
            print(f"{label:<26} x{count} {name:<16} {ms:.4f} ms  max abs err / max {err:.2e}",
                  flush=True)
            if name in stamp_sums:
                print(_stamp_line(torch, lib, run, _grid(b, hw, cout, sms), count,
                                  stamp_sums[name]), flush=True)
        if args.unfused:
            weight = w.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)

            def unfused():
                y = groupnorm.fused_group_norm(x, gw, gb, 32, 1e-6, "silu").permute(0, 3, 1, 2)
                y = F.conv2d(y, weight, bias, padding=1).permute(0, 2, 3, 1)
                return y if res is None else res + y

            ms = max(device_ms(torch, unfused, args.reps) - device_ms(
                torch, lambda: groupnorm.gn_affine_coeffs(x, gw, gb, 32, 1e-6), args.reps), 0.0)
            totals["unfused"] += count * ms
            print(f"{label:<26} x{count} {'unfused':<16} {ms:.4f} ms", flush=True)
        del x, out, want, res
        torch.cuda.empty_cache()
    for name, ms in totals.items():
        print(f"all 20 launches {name:<16} {ms:.3f} ms", flush=True)
    for name, s in stamp_sums.items():
        print(f"all 20 launches {name:<16} clocks a tap, weighted by launches: "
              + _stamp_text(s[:16], s[16:]), flush=True)
    return 0


def _stamp_line(torch, lib, run, grid: int, count: int, sums: list) -> str:
    """One stamped launch: its clocks a tap by role and slot (added, times
    `count`, into `sums`: products' slots then patches')."""
    import numpy as np

    fn = lib.skp_gn_conv_stamps
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    nbytes = grid * 12 * 16 * 4
    assert fn(None, nbytes) == 0
    run()
    torch.cuda.synchronize()
    host = np.zeros(grid * 12 * 16, dtype=np.uint32)
    assert fn(host.ctypes.data, nbytes) == 0
    st = host.reshape(grid, 12, 16).astype(np.float64)
    prod = st[:, :8].sum(axis=(0, 1))   # the two product warpgroups
    patch = st[:, 8:].sum(axis=(0, 1))  # the patch warpgroup
    patch[8] *= 9  # chunks -> taps
    for i in range(16):
        sums[i] += count * prod[i]
        sums[16 + i] += count * patch[i]
    return "    stamps: " + _stamp_text(prod, patch)


def _stamp_text(prod, patch) -> str:
    pt = max(prod[8], 1.0)
    ct = max(patch[8], 1.0)
    p = " ".join(f"{n} {prod[i] / pt:.0f}" for i, n in PRODUCT_SLOTS.items())
    q = " ".join(f"{n} {patch[i] / ct:.0f}" for i, n in PATCH_SLOTS.items())
    return f"products {p} total {prod[9] / pt:.0f} | patch {q} total {patch[9] / ct:.0f}"


if __name__ == "__main__":
    sys.exit(main())
