"""Where the VAE's d-512 attention time goes: time ablated copies of the
PyTorch port's `flash_wide_kernel` (`csrc/flash.cu`) on one NVIDIA GPU.

    python3 tools/wide_attn_variants.py [--parent DIR] [--variant NAME=DIR] [--reps 20]

Each variant is `stablekeypoints_tpu_torch/kernels/csrc/` with one part
changed by a text substitution, built with nvcc into its own `flash.cu`
library under build/wide_attn_variants/ (all builds in parallel) and timed
at the shape one SD-1.5 512^2 detect pass (10 views) gives the kernel, q, k,
v [10, 4096, 1, 512] bf16:

  kernel      the kernel as committed
  no_exp      every exponential replaced by a multiply
  no_kv_copy  k and v copied for the first key tile only (the producer
              then completes each stage's barrier without a copy)
  qk_1of32    q . k^T with one of its 32 k-steps (the scores still formed)
  pv_1of4     p . v with one of its 4 k-steps
  parent      with --parent DIR: DIR/stablekeypoints_tpu_torch/kernels/csrc
              as it is (an earlier commit's kernel, for a same-card
              comparison)
  NAME        with --variant NAME=DIR: the csrc directory DIR as it is

A variant's time against the kernel's bounds what its part costs while the
rest stays. Only `kernel`, `parent` and the `--variant` builds compute the
right result; each variant's largest difference from `kernel` is printed. Times are device
times: CUDA events around `--reps` calls queued behind a device-side spin,
as chip_smoke.py times. Needs a CUDA device and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys

from variant_build import build, card, device_ms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "stablekeypoints_tpu_torch", "kernels", "csrc")
OUT = os.path.join(REPO, "build", "wide_attn_variants")
_LOAD_K = "        load(Ks, &tk, j * BK, k_full);"
_LOAD_V = "        load(Vs, &tv, j * BK, v_full);"
VARIANTS = {  # name: [(file, old, new)]
    "kernel": [],
    "no_exp": [("common.cuh", 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                "y = x * 0.999f;")],
    "no_kv_copy": [  # past the first tile: the stage's barrier completed without a copy
        ("flash.cu", _LOAD_K, "        if (j == 0) load(Ks, &tk, 0, k_full); else mbar_arrive(k_full);"),
        ("flash.cu", _LOAD_V, "        if (j == 0) load(Vs, &tv, 0, v_full); else mbar_arrive(v_full);"),
    ],
    "qk_1of32": [("flash.cu", "    for (int ks = 0; ks < D / 16; ++ks)\n      wgmma_m64n32k16_ss(",
                  "    for (int ks = 0; ks < 1; ++ks)\n      wgmma_m64n32k16_ss(")],
    "pv_1of4": [("flash.cu", "    for (int kk = 0; kk < BK / 16; ++kk)\n      wgmma_m64n256k16_ss_tb(",
                 "    for (int kk = 0; kk < 1; ++kk)\n      wgmma_m64n256k16_ss_tb(")],
}
B, N, D = 10, 4096, 512


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="a checkout of an earlier commit to time beside")
    parser.add_argument("--variant", action="append", default=[], metavar="NAME=DIR",
                        help="also time the kernel of another csrc directory (same entry point)")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("wide_attn_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from stablekeypoints_tpu_torch.kernels import _build
    from stablekeypoints_tpu_torch.kernels._common import stream_handle

    variants = {n: (CSRC, subs) for n, subs in VARIANTS.items()}
    if args.parent:
        variants["parent"] = (os.path.join(args.parent, "stablekeypoints_tpu_torch", "kernels",
                                           "csrc"), [])
    for spec in args.variant:
        name, _, path = spec.partition("=")
        variants[name] = (os.path.abspath(path), [])
    libs = build(_build._nvcc_path(), OUT, variants, ("flash",))
    print(card())
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((B, N, 1, D), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    scale = D ** -0.5
    P = ctypes.c_void_p
    ref = None
    for name in variants:
        fwd, out = libs[name]["flash"].skp_flash_fwd, torch.empty_like(q)
        fwd.argtypes = [P] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, P]
        fwd.restype = ctypes.c_int
        ptrs = [P(x.data_ptr()) for x in (q, k, v, out)] + [None]

        def call(fwd=fwd, ptrs=ptrs):
            assert fwd(*ptrs, B, N, N, 1, D, scale, stream_handle()) == 0

        ms = device_ms(torch, call, args.reps)
        ref = out.float() if ref is None else ref
        err = (out.float() - ref).abs().max().item()
        print(f"d512 fwd q[{B},{N},1,{D}] {name:<11} {ms:.4f} ms  max diff from kernel {err:.2e}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
