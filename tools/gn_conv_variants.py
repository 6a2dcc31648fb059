"""Where K7's time goes: time ablated copies of the PyTorch port's fused
GroupNorm + SiLU + 3x3 conv CUDA kernel on one NVIDIA GPU.

    python3 tools/gn_conv_variants.py [--size 512|768|1024] [--parent DIR] [--variant NAME=DIR]
                                      [--cuts no_mma,...] [--reps 10]

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
  tw64       W 96 in two tiles 64 columns wide (A read by wgmma, a quarter
             of the columns padding) in place of three of 32
  bn128      tiles of 128 output channels at every Cout (256 where Cout allows)
  parent     with --parent DIR: DIR/stablekeypoints_tpu_torch/kernels/csrc
             as it is (an earlier commit's kernel, for a same-card
             comparison), and parent_<cut> for each cut of the previous
             design (thread 0 refilling the weight ring once all 8 product
             warps released a stage) that the parent's text admits
  NAME       with --variant NAME=DIR: the csrc directory DIR as it is

--cuts limits the cuts built (of the kernel and the parent) to those named.

A variant's time against the kernel's bounds what its part costs while the
rest stays. Only `kernel`, `parent` and other whole trees compute the right
result: each row prints its error against the plain version. Times are
device times: CUDA events around `--reps` calls queued behind a device-side
spin, as chip_smoke.py times. The last column sums each variant over the
20 launches of one encode. Needs a CUDA device and nvcc; imports no JAX.
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
VARIANTS = {  # name: [(file, old, new)]
    "kernel": [],
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
# the same cuts in the kernel of --parent where its text has them (the
# previous design), as parent_<name>
PARENT_VARIANTS = {
    "no_norm": VARIANTS["no_norm"],
    "no_mma": [("gn_conv.cu", "              wgmma_m64n128k16_ss(acc[j], da,",
                "              if (W < 0) wgmma_m64n128k16_ss(acc[j], da,")],
    "no_wcopy": [("gn_conv.cu", "    mbar_expect_tx(&full[st], WT * 2);\n",
                  "    if (G >= R) {\n      mbar_arrive(&full[st]);\n      return;\n    }\n"
                  "    mbar_expect_tx(&full[st], WT * 2);\n")],
    "no_patch": VARIANTS["no_patch"],
    "no_store": VARIANTS["no_store"],
}
# (H = W, Cin, Cout, residual, launches per encode), as chip_smoke.GN_CONV_SHAPES
SHAPES = ((512, 128, 128, False, 2), (512, 128, 128, True, 2), (256, 128, 256, False, 1),
          (256, 256, 256, False, 1), (256, 256, 256, True, 2), (128, 256, 512, False, 1),
          (128, 512, 512, False, 1), (128, 512, 512, True, 2), (64, 512, 512, False, 4),
          (64, 512, 512, True, 4))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="a checkout of an earlier commit to time beside")
    parser.add_argument("--variant", action="append", default=[], metavar="NAME=DIR",
                        help="also time the kernel of another csrc directory (same entry point)")
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--size", type=int, default=512, choices=(512, 768, 1024),
                        help="the encode's image size (levels scaled from 512^2)")
    parser.add_argument("--cuts", default=",".join(n for n in VARIANTS if n != "kernel"),
                        help="comma-separated cuts to build (empty: none)")
    args = parser.parse_args()
    cuts = set(filter(None, args.cuts.split(",")))

    import torch

    if not torch.cuda.is_available():
        print("gn_conv_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from stablekeypoints_tpu_torch.kernels import _build, gn_conv, groupnorm
    from stablekeypoints_tpu_torch.kernels._common import ptr, stream_handle

    variants = {n: (CSRC, subs) for n, subs in VARIANTS.items() if n == "kernel" or n in cuts}
    if args.parent:
        pdir = os.path.join(args.parent, "stablekeypoints_tpu_torch", "kernels", "csrc")
        variants["parent"] = (pdir, [])
        with open(os.path.join(pdir, "gn_conv.cu")) as f:
            ptext = f.read()
        for name, subs in PARENT_VARIANTS.items():
            if name in cuts and all(old in ptext for _, old, _ in subs):
                variants[f"parent_{name}"] = (pdir, subs)
    for spec in args.variant:
        name, _, path = spec.partition("=")
        variants[name] = (os.path.abspath(path), [])
    built = build(_build._nvcc_path(), OUT, variants, ("gn_conv",))
    libs = {n: ls["gn_conv"] for n, ls in built.items()}
    print(card())
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    totals = {n: 0.0 for n in libs}
    for hw, cin, cout, with_res, count in SHAPES:
        b, hw = 10, hw * args.size // 512
        x = (torch.randn((b, hw, hw, cin), generator=gen, device="cuda") * 1.5 + 0.3).to(bf)
        m, a, bc = groupnorm.gn_affine_coeffs(x, torch.ones(cin, device="cuda"),
                                              torch.zeros(cin, device="cuda"), 32, 1e-6)
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
            print(f"{label:<26} x{count} {name:<10} {ms:.4f} ms  max abs err / max {err:.2e}",
                  flush=True)
        del x, out, want, res
        torch.cuda.empty_cache()
    for name, ms in totals.items():
        print(f"all 20 launches {name:<10} {ms:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
