"""Where K3/K4/K5's time goes: time ablated copies of the PyTorch port's
attention CUDA kernels, forward and backward, on one NVIDIA GPU.

    python3 tools/attention_variants.py [--parent DIR] [--reps 20] [--d64] [--variants A,B]

Each variant is `stablekeypoints_tpu_torch/kernels/csrc/` with one part
changed by a text substitution, built with nvcc into its own libraries
(`flash.cu`, `cross_attn.cu`) under build/attention_variants/ (all builds
in parallel) and timed at the shapes one SD-1.5 512^2 detect pass (10 views)
and one training step (batch 8) give the kernels, bf16; with --d64 at the
d-64 shapes of SD-2.1 768^2 and SDXL 1024^2 (a detect pass of 10 views, a
training step of batch 4):

  kernel       the kernels as committed
  no_exp       every exponential replaced by a multiply
  no_kv_copy   K4/K5 forward: k and v copied for the first ring's worth of
               tiles only
  no_softmax   K4/K5 forward: the softmax of every tile but the first skipped
  wgs_swap     the four-warpgroup forward (d 40 and 80, and K3's backward
               statistics): four warpgroups (256 query rows) per block at
               d 40 and two at d 64 and 80, the other way round
  no_qdo_copy  backward: q and dO copied for the first ring's worth of query
               tiles only
  no_dq_reduce backward: the dq bulk reduce-add skipped
  no_pingpong  d-64 K4/K5 forward: the two consumer warpgroups issue their
               products without taking turns
  fwd_stages3  d-64 K4/K5 forward: three-stage k and v rings (two as
               committed)
  no_persist   d-64 K4/K5 forward: one block an item (128 query rows of one
               (b, h)) in place of one persistent block an SM
  bwd_stages2  d-64 backward: a two-stage q / dO ring (four as committed)
  no_split     d-64 backward: no key block's query tiles split over blocks
  parent       with --parent DIR: DIR/stablekeypoints_tpu_torch/kernels/csrc
               as it is (an earlier commit's kernels, for a same-card
               comparison)

A variant's time against the kernel's bounds what its part costs while the
rest stays. no_exp, no_kv_copy, no_softmax, no_qdo_copy and no_dq_reduce
leave work out and compute a wrong result; the others compute the right
one. Each forward variant's largest difference from `kernel` is printed.
Times are device times: CUDA events around `--reps` calls queued behind a
device-side spin, as chip_smoke.py times. Needs a CUDA device and nvcc;
imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys

from variant_build import build, card, device_ms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "stablekeypoints_tpu_torch", "kernels", "csrc")
OUT = os.path.join(REPO, "build", "attention_variants")
_ADVANCE = """    if (st + kAhead < steps) issue(st + kAhead);
    mbar_wait(&full[st % C::STAGES], (st / C::STAGES) & 1);"""
_BWD_ISSUE = """    if (it + kBwdStages - 1 < tiles) issue(it + kBwdStages - 1);"""
_BWD_WAIT = """    mbar_wait(&full[st], (it / kBwdStages) & 1);"""
# the d-64 forward: the producer's copies, the consumers' waits, the grid
_WS_LOAD = """          if (j >= S) mbar_wait(&k_empty[st], (j / S - 1) & 1);  // that stage's scores done
          load(Kst + st * C::TILE, &tk, jt * BK, &k_full[st]);
          if (j >= S) mbar_wait(&v_empty[st], (j / S - 1) & 1);  // its p . v done
          load(Vst + st * C::TILE, &tv, jt * BK, &v_full[st]);"""
_WS_WAIT = """  auto wait_full = [&](uint64_t* full, int j) { mbar_wait(&full[j % S], (j / S) & 1); };"""
_WS_GRID = "attn_fwd_ws_kernel<D><<<items < sms ? items : sms, kFwdWsThreads, C::bytes, stream>>>("
VARIANTS = {  # name: [(file, old, new)]
    "kernel": [],
    "no_exp": [("common.cuh", 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                "y = x * 0.999f;")],
    "no_kv_copy": [("attn_fwd.cuh", _ADVANCE, """    if (st + kAhead < steps && st + kAhead < C::STAGES) issue(st + kAhead);
    if (st < C::STAGES) mbar_wait(&full[st % C::STAGES], (st / C::STAGES) & 1);"""),
                   ("attn_fwd.cuh", _WS_LOAD, """          if (j < S) load(Kst + st * C::TILE, &tk, jt * BK, &k_full[st]);
          if (j < S) load(Vst + st * C::TILE, &tv, jt * BK, &v_full[st]);"""),
                   ("attn_fwd.cuh", _WS_WAIT, _WS_WAIT.replace("{ mbar_wait", "{ if (j < S) mbar_wait"))],
    "no_softmax": [("attn_fwd.cuh", "    softmax(s, st, alpha);  // the exponentials overlap p.v",
                    "    alpha[0] = alpha[1] = 1.f;"),
                   ("attn_fwd.cuh", "      softmax(jt, alpha);  // the exponentials overlap p . v",
                    "      alpha[0] = alpha[1] = 1.f;")],
    "wgs_swap": [("attn_fwd.cuh", "static constexpr int WGS = D <= 40 || D > 80 ? 2 : 4;",
                  "static constexpr int WGS = D <= 40 ? 4 : 2;")],
    "no_qdo_copy": [("attn_bwd.cuh", _BWD_ISSUE, """    if (it + kBwdStages - 1 < tiles && it < 1) issue(it + kBwdStages - 1);"""),
                    ("attn_bwd.cuh", _BWD_WAIT, "    if (it < kBwdStages) " + _BWD_WAIT.strip()),
                    ("attn_bwd.cuh", "      if (lane == 0) {  // q and dO, a box each (rows past N arrive as zeros)",
                     "      if (lane == 0 && it < S) {  // q and dO: the first S tiles only")],
    "no_dq_reduce": [("attn_bwd.cuh",
                      "      bulk_reduce_add_f32(dq_acc + ((bh * NH + c0 / DC) * N + q0) * DC, Dq,\n"
                      "                          min(kBwdBQ, N - q0) * DC * 4);",
                      ""),
                     ("attn_bwd.cuh",
                      "      bulk_reduce_add_f32(dq_acc + (bh * N + q0) * D, Dq, min(BQ, N - q0) * D * 4);",
                      "")],
    "no_pingpong": [("attn_fwd.cuh", "constexpr bool kFwdWsPingPong = true;",
                     "constexpr bool kFwdWsPingPong = false;")],
    "fwd_stages3": [("attn_fwd.cuh", "constexpr int kFwdWsStages = 2;", "constexpr int kFwdWsStages = 3;")],
    "no_persist": [("attn_fwd.cuh", _WS_GRID, _WS_GRID.replace("items < sms ? items : sms", "items"))],
    "bwd_stages2": [("attn_bwd.cuh", "constexpr int kBwdWsStages = 4;", "constexpr int kBwdWsStages = 2;")],
    "no_split": [("attn_bwd.cuh", "  for (int z = 2; z <= 8 && z <= tiles; ++z)",
                  "  for (int z = 2; z <= 1 && z <= tiles; ++z)")],
}
SOURCES = ("flash", "cross_attn")
B_FWD, T = 10, 500
# (source, label, N, M, heads, D): K4 at down_0 (d 40) and down_1/up_2 (d 80),
# K5, K3; a training step's batch
CASES = (("flash", "K4", 4096, 4096, 8, 40), ("flash", "K4", 1024, 1024, 8, 80),
         ("flash", "K5", 1024, T, 8, 80), ("cross_attn", "K3", 4096, T, 8, 40))
B_BWD = 8
# --d64: SD-2.1's 96^2 K4, SDXL's 32^2 K4 and K5, SDXL's 64^2 K3 (learned tokens
# and the guidance's 77)
CASES_D64 = (("flash", "K4", 9216, 9216, 5, 64), ("flash", "K4", 1024, 1024, 20, 64),
             ("flash", "K5", 1024, T, 20, 64), ("cross_attn", "K3", 4096, T, 10, 64),
             ("cross_attn", "K3", 4096, 77, 10, 64))
B_BWD_D64 = 4


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="a checkout of an earlier commit to time beside")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--d64", action="store_true", help="the SD-2.1 / SDXL d-64 shapes")
    parser.add_argument("--variants", default="",
                        help="comma-separated variant names (default: all); kernel always")
    args = parser.parse_args()
    cases, b_bwd = (CASES_D64, B_BWD_D64) if args.d64 else (CASES, B_BWD)

    import torch

    if not torch.cuda.is_available():
        print("attention_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from stablekeypoints_tpu_torch.kernels import _build
    from stablekeypoints_tpu_torch.kernels._common import stream_handle
    from stablekeypoints_tpu_torch.kernels.flash import bwd_scratch

    keep = set(filter(None, args.variants.split(","))) | {"kernel"}
    variants = {n: (CSRC, subs) for n, subs in VARIANTS.items()
                if len(keep) == 1 or n in keep}
    if args.parent:
        variants["parent"] = (os.path.join(args.parent, "stablekeypoints_tpu_torch", "kernels",
                                           "csrc"), [])
    libs = build(_build._nvcc_path(), OUT, variants, SOURCES)
    print(card())
    gen = torch.Generator(device="cuda").manual_seed(0)
    P = ctypes.c_void_p

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    for src, label, n, m, h, d in cases:
        scale = d ** -0.5
        q, k, v = randn(B_FWD, n, h, d), randn(B_FWD, m, h, d), randn(B_FWD, m, h, d)
        ref = None
        for name in variants:
            lib, out = libs[name][src], torch.empty_like(q)
            fwd = lib.skp_flash_fwd if src == "flash" else lib.skp_cross_fwd
            ptrs = [P(x.data_ptr()) for x in (q, k, v, out)] + ([None] if src == "flash" else [])
            fwd.argtypes = [P] * len(ptrs) + [ctypes.c_int] * 5 + [ctypes.c_float, P]
            fwd.restype = ctypes.c_int

            def call(fwd=fwd, ptrs=ptrs):
                assert fwd(*ptrs, B_FWD, n, m, h, d, scale, stream_handle()) == 0

            ms = device_ms(torch, call, args.reps)
            ref = out.float() if ref is None else ref
            err = (out.float() - ref).abs().max().item()
            print(f"{label} fwd q[{B_FWD},{n},{h},{d}] kv {m} {name:<13} {ms:.4f} ms  "
                  f"max diff from kernel {err:.2e}", flush=True)
        q, k, v, do = (randn(b_bwd, r, h, d) for r in (n, m, m, n))
        for name in variants:
            lib = libs[name][src]
            lse, di = (torch.empty((b_bwd, h, n), device="cuda") for _ in range(2))
            acc = [torch.empty((b_bwd, h, n, d), device="cuda")]
            # the d-64 backward's query split (an earlier tree's kernels take none)
            splits = []
            if hasattr(lib, "skp_attn_bwd_splits"):
                z, part = bwd_scratch(lib, q, k)
                acc.append(part)
                splits = [z]
            grads = [torch.empty_like(x) for x in (q, k, v)]
            if src == "flash":
                o = torch.empty_like(q)
                fl = lib.skp_flash_fwd
                fl.argtypes = [P] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, P]
                assert fl(*[P(x.data_ptr()) for x in (q, k, v, o, lse)], b_bwd, n, m, h, d, scale,
                          stream_handle()) == 0
                tensors, bwd = [q, k, v, o, do, lse, di, *acc, *grads], lib.skp_flash_bwd
            else:
                tensors, bwd = [q, k, v, do, lse, di, *acc, *grads], lib.skp_cross_bwd
            ints = [b_bwd, n, m, h, d, *splits]
            bwd.argtypes = [P] * len(tensors) + [ctypes.c_int] * len(ints) + [ctypes.c_float, P]
            bwd.restype = ctypes.c_int

            def call(bwd=bwd, ptrs=[P(x.data_ptr()) for x in tensors], ints=ints):
                assert bwd(*ptrs, *ints, scale, stream_handle()) == 0

            ms = device_ms(torch, call, args.reps)
            print(f"{label} bwd q[{b_bwd},{n},{h},{d}] kv {m} {name:<13} {ms:.4f} ms"
                  + (f"  (query split {splits[0]})" if splits else ""), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
