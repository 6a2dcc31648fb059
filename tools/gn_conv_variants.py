"""Where K7's time goes: time ablated copies of the PyTorch port's fused
GroupNorm + SiLU + 3x3 conv CUDA kernel on one NVIDIA GPU.

    python3 tools/gn_conv_variants.py [--reps 10]

Each variant is `stablekeypoints_tpu_torch/kernels/csrc/gn_conv.cu` with one
part cut out by a text substitution, built with nvcc into its own library
under build/gn_conv_variants/ (all builds in parallel) and timed with CUDA
events at three SD-1.5 512^2 VAE-encoder shapes (10 views, bf16, no
residual):

  kernel     the kernel as committed
  no_norm    the GN affine + SiLU skipped (the raw patch is convolved)
  no_mma     the tensor-core products skipped (loads, normalize, epilogue)

A variant's time against the kernel's bounds what its part costs when the
rest stays. Only `kernel` computes the right result: its error against the
plain version is printed beside its time. Needs a CUDA device and nvcc;
imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "stablekeypoints_tpu_torch", "kernels", "csrc")
OUT = os.path.join(REPO, "build", "gn_conv_variants")
VARIANTS = {
    "kernel": [],
    "no_norm": [("for (int e = 0; e < 4; ++e) v[e] = gn_silu2(v[e], cm[e], ca[e], cb[e]);", "")],
    "no_mma": [("wgmma_m64n128k16_ss(acc, smem_desc(",
                "if (W < 0) wgmma_m64n128k16_ss(acc, smem_desc(")],
}
SHAPES = ((512, 128, 128), (128, 512, 512), (64, 512, 512))  # (H = W, Cin, Cout)


def build(nvcc: str) -> dict:
    with open(os.path.join(CSRC, "gn_conv.cu")) as f:
        src = f.read()
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not found in gn_conv.cu")
            text = text.replace(old, new)
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        shutil.copy(os.path.join(CSRC, "common.cuh"), d)
        with open(os.path.join(d, "gn_conv.cu"), "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-o", os.path.join(d, "lib.so"), os.path.join(d, "gn_conv.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(os.path.join(OUT, name, "lib.so"))
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("gn_conv_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from stablekeypoints_tpu_torch.kernels import _build, gn_conv, groupnorm
    from stablekeypoints_tpu_torch.kernels._common import ptr, stream_handle

    libs = build(_build._nvcc_path())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    for hw, cin, cout in SHAPES:
        b = 10
        x = (torch.randn((b, hw, hw, cin), generator=gen, device="cuda") * 1.5 + 0.3).to(bf)
        m, a, bc = groupnorm.gn_affine_coeffs(x, torch.ones(cin, device="cuda"),
                                              torch.zeros(cin, device="cuda"), 32, 1e-6)
        w = torch.randn((cout, 3, 3, cin), generator=gen, device="cuda") * (9 * cin) ** -0.5
        w = w.to(bf)
        bias = torch.zeros(cout, device="cuda", dtype=bf)
        want = gn_conv.fused_gn_silu_conv3x3_plain(x, m, a, bc, w.permute(1, 2, 3, 0), bias).float()
        for name, lib in libs.items():
            out = torch.zeros((b, hw, hw, cout), device="cuda", dtype=bf)
            fn = lib.skp_gn_conv
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def run(fn=fn, out=out):
                rc = fn(ptr(x), ptr(m), ptr(a), ptr(bc), ptr(w), ptr(bias), None, ptr(out), b,
                        hw, hw, cin, cout, stream_handle())
                assert rc == 0, rc

            run()
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                run()
            end.record()
            torch.cuda.synchronize()
            err = ((out.float() - want).abs().max() / want.abs().max()).item()
            ms = start.elapsed_time(end) / args.reps
            print(f"x[{b},{hw},{hw},{cin}]->{cout} {name:<8} {ms:.3f} ms  "
                  f"max abs err / max {err:.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
