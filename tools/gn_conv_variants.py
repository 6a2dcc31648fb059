"""Where K7's time goes: time ablated copies of the PyTorch port's fused
GroupNorm + SiLU + 3x3 conv CUDA kernel on one NVIDIA GPU.

    python3 tools/gn_conv_variants.py [--parent DIR] [--variant NAME=DIR] [--reps 10]

Each variant is `stablekeypoints_tpu_torch/kernels/csrc/` with one part
changed by a text substitution, built with nvcc into its own library
(`gn_conv.cu`) under build/gn_conv_variants/ (all builds in parallel) and
timed at the 10 shapes one SD-1.5 512^2 VAE encode gives K7 (10 views,
bf16, with the residual where the encoder adds one):

  kernel     the kernel as committed
  no_norm    the GN affine + SiLU arithmetic skipped (its loads and stores stay)
  no_mma     the tensor-core products skipped (loads, normalize, epilogue)
  no_wcopy   weight tiles copied for the first ring stages only
  no_patch   raw patches copied for the first two chunks only
  parent     with --parent DIR: DIR/stablekeypoints_tpu_torch/kernels/csrc
             as it is (an earlier commit's kernel, for a same-card
             comparison), and parent_<cut> for each cut above that the
             parent's text admits
  NAME       with --variant NAME=DIR: the csrc directory DIR as it is

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
    "no_mma": [("gn_conv.cu", "              wgmma_m64n128k16_ss(acc[j], da,",
                "              if (W < 0) wgmma_m64n128k16_ss(acc[j], da,")],
    "no_wcopy": [("gn_conv.cu", "    mbar_expect_tx(&full[st], WT * 2);\n",
                  "    if (G >= R) {\n      mbar_arrive(&full[st]);\n      return;\n    }\n"
                  "    mbar_expect_tx(&full[st], WT * 2);\n")],
    "no_patch": [("gn_conv.cu", "        cp_async16(buf + (cg * NP + q) * 8,",
                  "        if (C < 2) cp_async16(buf + (cg * NP + q) * 8,")],
}
# the same cuts in the kernel of --parent where its text has them (the
# cp.async design before the weight ring), as parent_<name>
PARENT_VARIANTS = {
    "no_norm": VARIANTS["no_norm"],
    "no_mma": [("gn_conv.cu", "wgmma_m64n128k16_ss(acc, smem_desc(",
                "if (W < 0) wgmma_m64n128k16_ss(acc, smem_desc(")],
    "no_wcopy": [("gn_conv.cu", "      cp_async16(Ws + ((S & 1) * 3 + dx) * kGcWT",
                  "      if (S < 2) cp_async16(Ws + ((S & 1) * 3 + dx) * kGcWT")],
    "no_patch": [("gn_conv.cu", "      cp_async16(dst + (j * NP + q) * 8,",
                  "      if (C < 2) cp_async16(dst + (j * NP + q) * 8,")],
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
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("gn_conv_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from stablekeypoints_tpu_torch.kernels import _build, gn_conv, groupnorm
    from stablekeypoints_tpu_torch.kernels._common import ptr, stream_handle

    variants = {n: (CSRC, subs) for n, subs in VARIANTS.items()}
    if args.parent:
        pdir = os.path.join(args.parent, "stablekeypoints_tpu_torch", "kernels", "csrc")
        variants["parent"] = (pdir, [])
        with open(os.path.join(pdir, "gn_conv.cu")) as f:
            ptext = f.read()
        for name, subs in PARENT_VARIANTS.items():
            if all(old in ptext for _, old, _ in subs):
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
        b = 10
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
