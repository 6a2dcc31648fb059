"""Where K3/K4/K5's time goes: time ablated copies of the PyTorch port's
attention CUDA kernels, forward and backward, on one NVIDIA GPU.

    python3 tools/attention_variants.py [--parent DIR] [--reps 20] [--d64 | --d160 | --clusters]
        [--variants A,B] [--cases 0,2] [--no-forward]
    python3 tools/attention_variants.py --mutations [--d64 | --emulate] [--variants mut_a,mut_b]

Each variant is `stablekeypoints_tpu_torch/kernels/csrc/` with one part
changed by a text substitution, built with nvcc into its own libraries
(`flash.cu`, `cross_attn.cu`) under build/attention_variants/ (all builds
in parallel) and timed at the shapes one SD-1.5 512^2 detect pass (10 views)
and one training step (batch 8) give the kernels, bf16; with --d64 at the
d-64 shapes of SD-2.1 768^2 and SDXL 1024^2 (a detect pass of 10 views, a
training step of batch 4); with --d160 at K3's d-160 shapes of SD-1.5 at
1536^2 (a guided forward's 2 images at 500 and 77 tokens, the backward at
500); with --clusters, the backward alone, at SD-2.1's largest K4 level
from 512^2 to 768^2 (32 to 72 key blocks of 128) and K5 at 77 keys:

  kernel       the kernels as committed
  no_exp       every exponential replaced by a multiply
  no_kv_copy   K4/K5 forward: k and v copied for the first ring's worth of
               tiles only
  no_softmax   K4/K5 forward: the softmax of every tile but the first skipped
  wgs_swap     the four-warpgroup forward (d 40 and 80): four warpgroups
               (256 query rows) per block at d 40 and two at 80, the other
               way round
  no_pingpong  d-64 K4/K5 forward: the two consumer warpgroups issue their
               products without taking turns
  fwd_stages3  d-64 K4/K5 forward: three-stage k and v rings (two as
               committed)
  no_persist   d-64 K4/K5 forward: one block an item (128 query rows of one
               (b, h)) in place of one persistent block an SM
  no_split     the backward's keys pass: no key block's query tiles split
               over blocks
  rows_only    the backward (rows and keys passes): the rows pass alone
  keys_only    ... the keys pass alone (on lse2 and di left unset by K3)
  no_pipe      ... one tile at a time at d 64 and 80 too (no second score
               buffer; one block an SM; the score products' A operand from
               shared memory)
  pipe_d40     ... two tiles at a time at d 40 too (one block an SM)
  no_areg      ... the d-64 score products' A operand (q and dO rows, k and v
               rows) read from shared memory by each product, not held in
               registers
  kq_noxchg    K3's d-64 keys-major pass (attn_kq_kernel): no dq exchange
               between a cluster's blocks (no bulk copies, nothing waits
               for them; the sums read what is there)
  kq_nostage   ... nor the staging of the dq partials
  kq_nostat    ... the tiles' lse2 and di not read (zeros)
  kq_nodq      ... no dq product
  kq_st4       ... a four-stage q / dO ring (three as committed)
  k3f_wg       K3's forward above 256 keys with a producer warpgroup that
               gives its registers to the consumers (setmaxnreg 40 / 232)
  parent       with --parent DIR: DIR/stablekeypoints_tpu_torch/kernels/csrc
               as it is (an earlier commit's kernels, for a same-card
               comparison; a tree whose backward entries take a route
               argument after Z runs its own route)

--cases picks rows of the shape table (indices), --no-forward times the
backward rows alone. --mutations builds copies that each drop one wait and
runs them against the plain version in a fresh process each (each must
fail or not finish, the committed kernel must pass): on the card, or with
--emulate in the CPU emulation of the tests (tests/cuda_emu, g++; no card),
where a TMA or bulk copy lands only when its mbarrier is waited on.

A variant's time against the kernel's bounds what its part costs while the
rest stays. no_exp, no_kv_copy, no_softmax, rows_only and keys_only leave
work out and compute a wrong result; the others compute the right
one. Each forward variant's largest difference from `kernel` is printed.
Times are device times: CUDA events around `--reps` calls queued behind a
device-side spin, as chip_smoke.py times. Needs a CUDA device and nvcc
(--emulate: g++ alone); imports no JAX.
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
_ADVANCE = """    if (st + kAhead < tiles) issue(st + kAhead);
    mbar_wait(&full[st % C::STAGES], (st / C::STAGES) & 1);"""
# the d-64 forward: the producer's copies, the consumers' waits, the grid
_WS_LOAD = """          if (j >= S) mbar_wait(&k_empty[st], (j / S - 1) & 1);  // that stage's scores done
          load(Kst + st * C::TILE, &tk, jt * BK, &k_full[st]);
          if (j >= S) mbar_wait(&v_empty[st], (j / S - 1) & 1);  // its p . v done
          load(Vst + st * C::TILE, &tv, jt * BK, &v_full[st]);"""
_WS_WAIT = """  auto wait_full = [&](uint64_t* full, int j) { mbar_wait(&full[j % S], (j / S) & 1); };"""
_WS_GRID = "attn_fwd_ws_kernel<D><<<items < sms ? items : sms, kFwdWsThreads, C::bytes, stream>>>("
# the first lines of the backward's passes (attn_bwd.cuh)
_ROWS_TOP = "  using C = RkCfg<D>;\n  constexpr int BQ = kRkBQ, KT = kRkKT,"
_KEYS_TOP = "  using C = RkCfg<D>;\n  constexpr int BQ = kRkBQ, QH = kRkQH,"
VARIANTS = {  # name: [(file, old, new)]
    "kernel": [],
    "no_exp": [("common.cuh", 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                "y = x * 0.999f;")],
    "no_kv_copy": [("attn_fwd.cuh", _ADVANCE, """    if (st + kAhead < tiles && st + kAhead < C::STAGES) issue(st + kAhead);
    if (st < C::STAGES) mbar_wait(&full[st % C::STAGES], (st / C::STAGES) & 1);"""),
                   ("attn_fwd.cuh", _WS_LOAD, """          if (j < S) load(Kst + st * C::TILE, &tk, jt * BK, &k_full[st]);
          if (j < S) load(Vst + st * C::TILE, &tv, jt * BK, &v_full[st]);"""),
                   ("attn_fwd.cuh", _WS_WAIT, _WS_WAIT.replace("{ mbar_wait", "{ if (j < S) mbar_wait"))],
    "no_softmax": [("attn_fwd.cuh", "    softmax(s, st, alpha);  // the exponentials overlap p.v",
                    "    alpha[0] = alpha[1] = 1.f;"),
                   ("attn_fwd.cuh", "      softmax(jt, alpha);  // the exponentials overlap p . v",
                    "      alpha[0] = alpha[1] = 1.f;")],
    "wgs_swap": [("attn_fwd.cuh", "static constexpr int WGS = D <= 40 ? 2 : 4;",
                  "static constexpr int WGS = D <= 40 ? 4 : 2;")],
    "no_pingpong": [("attn_fwd.cuh", "constexpr bool kFwdWsPingPong = true;",
                     "constexpr bool kFwdWsPingPong = false;")],
    "fwd_stages3": [("attn_fwd.cuh", "constexpr int kFwdWsStages = 2;", "constexpr int kFwdWsStages = 3;")],
    "no_persist": [("attn_fwd.cuh", _WS_GRID, _WS_GRID.replace("items < sms ? items : sms", "items"))],
    "no_split": [("common.cuh", "  for (int z = 2; z <= max_z && z <= tiles; ++z)",
                  "  for (int z = 2; z <= 1 && z <= tiles; ++z)")],
    "rows_only": [("attn_bwd.cuh", _KEYS_TOP, "  if (N >= 0) return;\n" + _KEYS_TOP)],
    "keys_only": [("attn_bwd.cuh", _ROWS_TOP, "  if (N >= 0) return;\n" + _ROWS_TOP)],
    "no_pipe": [("attn_bwd.cuh", "  static constexpr bool PIPE = D == 64 || D == 80;",
                 "  static constexpr bool PIPE = false;"),
                ("attn_bwd.cuh", "  static constexpr int MINB = D <= 64 && !PIPE ? 2 : 1;",
                 "  static constexpr int MINB = 1;"),
                ("attn_bwd.cuh", "  static constexpr bool AREG = D == 64;", "  static constexpr bool AREG = false;")],
    "pipe_d40": [("attn_bwd.cuh", "  static constexpr bool PIPE = D == 64 || D == 80;",
                  "  static constexpr bool PIPE = D != 160;")],
    "no_areg": [("attn_bwd.cuh", "  static constexpr bool AREG = D == 64;", "  static constexpr bool AREG = false;")],
    # the d-64 keys-major backward (attn_kq_kernel)
    "kq_noxchg": [("attn_bwd.cuh", "          for (int sl = 0; sl < CL; ++sl)\n            bulk_copy_to_cluster(",
                   "          for (int sl = 0; sl < 0; ++sl)\n            bulk_copy_to_cluster("),
                  ("attn_bwd.cuh", "          if (j >= NB) mbar_wait_cluster(&xempty[x], ph ^ 1);", ""),
                  ("attn_bwd.cuh", "        mbar_wait(&xfull[x], (j / NB) & 1);", ""),
                  ("attn_bwd.cuh", "        if (tid < 96 && j + NB < n) {", "        if (tid < 0) {")],
    "kq_nostage": [("attn_bwd.cuh", "          for (int sl = 0; sl < CL; ++sl)\n            bulk_copy_to_cluster(",
                    "          for (int sl = 0; sl < 0; ++sl)\n            bulk_copy_to_cluster("),
                   ("attn_bwd.cuh", "          if (j >= NB) mbar_wait_cluster(&xempty[x], ph ^ 1);", ""),
                   ("attn_bwd.cuh", "        mbar_wait(&xfull[x], (j / NB) & 1);", ""),
                   ("attn_bwd.cuh", "        if (tid < 96 && j + NB < n) {", "        if (tid < 0) {"),
                   ("attn_bwd.cuh", "      if (j >= NB) mbar_wait(&sent[x], ((j / NB) & 1) ^ 1);", ""),
                   ("attn_bwd.cuh", "          *reinterpret_cast<float2*>(at + kq_sw(row, 32 * wg + 8 * jc + 2 * t)) =",
                    "          if (N < 0) *reinterpret_cast<float2*>(at + kq_sw(row, 32 * wg + 8 * jc + 2 * t)) =")],
    "kq_nostat": [("attn_bwd.cuh", "          const bool ok = q0 + r < N;\n          sv[r] = ok ? lse2[bh * N + q0 + r] : 0.f;\n          sv[BQ + r] = ok ? di[bh * N + q0 + r] : 0.f;",
                   "          sv[r] = 0.f;\n          sv[BQ + r] = 0.f;")],
    "kq_nodq": [("attn_bwd.cuh", "        wgmma_m64n32k16_ss_tt(dqa, desc_mnmajor<C::SPL>(ds, 16 * kk, 0), desc_mnmajor<BPL>(Ks, 16 * kk, 4 * wg),\n                              kk > 0);",
                 "        dqa[kk] = 0.f;")],
    # K3's forward: the producer a warpgroup that gives its registers to the
    # consumers (setmaxnreg 40 / 232) above 256 keys
    "k3f_wg": [("cross_attn.cu", "constexpr int kCrossWsThreads = 288;", "constexpr int kCrossWsThreads = 384;"),
               ("cross_attn.cu", "  const bool producer = tid >= 256;",
                "  const bool producer = tid >= 256;\n  if constexpr (TP > 256) {\n    if (producer) setmaxnreg_dec<40>();\n"
                "    else setmaxnreg_inc<232>();\n  }"),
               ("cross_attn.cu", "      if (lane == 0) {  // k and v of (b, h)", "      if (tid == 256) {  // k and v of (b, h)")],
    "kq_st4": [("attn_bwd.cuh", "constexpr int kKqStages = 3;", "constexpr int kKqStages = 4;")],
}
# mutation checks: each drops one wait of K3's d-160 forward or of the rows
# and keys backward (the emulation runs copies and products at once, so it
# cannot see a missing wait); the row must fail against the plain version, or
# hang. (kind, substitutions)
MUTATIONS = {
    "mut_pair_kv": ("fwd", [("cross_attn.cu", "    mbar_wait(kv_full, static_cast<int>(e & 1));", "")]),
    "mut_pair_qfull": ("fwd", [("cross_attn.cu", "      mbar_wait(&q_full[wg], par);", "")]),
    "mut_pair_stat": ("fwd", [("cross_attn.cu", "      mbar_wait_cluster(&x_stat[wg], par);", "")]),
    "mut_pair_out": ("fwd", [("cross_attn.cu", "      mbar_wait_cluster(&x_out[wg], par);", "")]),
    "mut_pair_qempty": ("fwd", [("cross_attn.cu", "        mbar_wait(&q_empty[wg], par);", "")]),
    "mut_pair_seg": ("fwd", [("cross_attn.cu", "      named_bar_sync(3, 256);\n      if (tid == 0) load_kv(s0);",
                              "      if (tid == 0) load_kv(s0);")]),
    "mut_rows_q": ("bwd", [("attn_bwd.cuh", "  mbar_wait(qfull, 0);", "")]),
    "mut_rows_full": ("bwd", [("attn_bwd.cuh", "    mbar_wait(&full[i % ST], (i / ST) & 1);", "")]),
    "mut_rows_empty": ("bwd", [("attn_bwd.cuh", "      mbar_wait(&empty[i % ST], (i / ST) & 1);", "")]),
    "mut_keys_kv": ("bwd", [("attn_bwd.cuh", "  mbar_wait(kvfull, 0);", "")]),
    "mut_keys_full": ("bwd", [("attn_bwd.cuh", "    mbar_wait(&full[j % ST], (j / ST) & 1);", "")]),
    "mut_keys_empty": ("bwd", [("attn_bwd.cuh", "      mbar_wait(&empty[j % ST], (j / ST) & 1);", "")]),
    # the d-64 keys-major pass: its q / dO tile wait, its k / v wait, the dq
    # exchange's landing wait (the summing warps) and its two reuse waits
    # (the sender's, for the receivers' release; the consumers', for the
    # copies to have read the staging buffer)
    "mut_kq_full": ("kq", [("attn_bwd.cuh", "      mbar_wait(&full[st], (j / S) & 1);", "")]),
    "mut_kq_kv": ("kq", [("attn_bwd.cuh", "    mbar_wait(kvfull, 0);\n    load_a_frags", "    load_a_frags")]),
    "mut_kq_xfull": ("kq", [("attn_bwd.cuh", "        mbar_wait(&xfull[x], (j / NB) & 1);", "")]),
    "mut_kq_xempty": ("kq", [("attn_bwd.cuh", "          if (j >= NB) mbar_wait_cluster(&xempty[x], ph ^ 1);", "")]),
    "mut_kq_sent": ("kq", [("attn_bwd.cuh", "      if (j >= NB) mbar_wait(&sent[x], ((j / NB) & 1) ^ 1);", "")]),
}
# one mutation's row in a fresh process (argv: repo, library, kind, b, n, m,
# h, d): its largest error over the plain version's largest magnitude and
# the tolerance, as JSON; a hang is killed by the caller's timeout. kind:
# fwd (K3's forward), bwd (K3's backward) or flash_bwd (K4/K5's, after the
# library's forward)
MUTATION_CHILD = r"""
import ctypes, json, sys
sys.path.insert(0, sys.argv[1])
import torch
from stablekeypoints_tpu_torch.kernels._common import stream_handle
from stablekeypoints_tpu_torch.kernels.cross_attn import cross_attention_bwd_plain, cross_attention_plain
from stablekeypoints_tpu_torch.kernels.flash import attention_bwd_plain, bwd_scratch
lib, kind = ctypes.CDLL(sys.argv[2]), sys.argv[3]
b, n, m, h, d = map(int, sys.argv[4:9])
gen = torch.Generator(device="cuda").manual_seed(0)
q, k, v, do = (torch.randn((b, r, h, d), generator=gen, device="cuda").to(torch.bfloat16) for r in (n, m, m, n))
P, s = ctypes.c_void_p, d ** -0.5
if kind == "fwd":
    got, want, tol = (torch.empty_like(q),), (cross_attention_plain(q, k, v, s),), 2.0**-7
    fn = lib.skp_cross_fwd
    fn.argtypes = [P] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, P]
    rc = fn(*[P(x.data_ptr()) for x in (q, k, v, got[0])], b, n, m, h, d, s, stream_handle())
else:
    got, tol = tuple(torch.empty_like(x) for x in (q, k, v)), 2.0**-6
    lse, di = (torch.empty((b, h, n), device="cuda") for _ in range(2))
    z, part = bwd_scratch(lib, q, k)
    if kind == "bwd":
        want = cross_attention_bwd_plain(q, k, v, do, s)
        fn, ptrs = lib.skp_cross_bwd, (q, k, v, do, lse, di, part, *got)
    else:
        o = torch.empty_like(q)
        fwd = lib.skp_flash_fwd
        fwd.argtypes = [P] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, P]
        assert fwd(*[P(x.data_ptr()) for x in (q, k, v, o, lse)], b, n, m, h, d, s, stream_handle()) == 0
        want = attention_bwd_plain(q, k, v, o, do, s)
        fn, ptrs = lib.skp_flash_bwd, (q, k, v, o, do, lse, di, part, *got)
    fn.argtypes = [P] * len(ptrs) + [ctypes.c_int] * 6 + [ctypes.c_float, P]
    rc = fn(*[P(x.data_ptr()) for x in ptrs], b, n, m, h, d, z, s, stream_handle())
torch.cuda.synchronize()
err = max(((g.float() - w.float()).abs().max() / w.float().abs().max()).item() for g, w in zip(got, want))
print(json.dumps({"rc": rc, "err": err, "tol": tol}))
"""
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
             ("cross_attn", "K3", 4096, 77, 10, 64),
             # SDXL's 64^2 and SD-2.1's 48^2 K4
             ("flash", "K4", 4096, 4096, 10, 64), ("flash", "K4", 2304, 2304, 10, 64))
B_BWD_D64 = 4
# --clusters: SD-2.1's K4 at its 64^2-96^2 levels (512^2 to 768^2 images;
# 32-72 key blocks, 4-9 clusters of at most 8) and K5 at 77 keys (SDXL's
# 32^2 level, --num_tokens 77)
CASES_CLUSTERS = tuple(("flash", "K4", n, n, 5, 64) for n in (4096, 4608, 5184, 6400, 7744, 9216)) + (
    ("flash", "K5", 1024, 77, 20, 64),)
# --d160: K3 at SD-1.5 1536^2's 48^2 1280-channel levels, 2 images
CASES_D160 = (("cross_attn", "K3", 2304, T, 8, 160), ("cross_attn", "K3", 2304, 77, 8, 160))
B_D160 = 2


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="a checkout of an earlier commit to time beside")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--d64", action="store_true", help="the SD-2.1 / SDXL d-64 shapes")
    parser.add_argument("--d160", action="store_true", help="K3 at SD-1.5 1536^2's d-160 shapes")
    parser.add_argument("--clusters", action="store_true",
                        help="the d-64 K4 backward at 32-72 key blocks and K5 at 77 keys")
    parser.add_argument("--cases", default="",
                        help="comma-separated indices of the shape table's rows (default: all)")
    parser.add_argument("--no-forward", action="store_true", help="time the backward rows alone")
    parser.add_argument("--variants", default="",
                        help="comma-separated variant names (default: all); kernel always")
    parser.add_argument("--emulate", action="store_true",
                        help="with --mutations: run them in the CPU emulation (g++; no card)")
    parser.add_argument("--mutations", action="store_true",
                        help="the mutation checks (K3 at d 160; --d64 the d-64 backward; --variants picks some)")
    args = parser.parse_args()
    if args.mutations:
        return mutations(args)
    args.no_forward = args.no_forward or args.clusters
    cases, b_fwd, b_bwd = ((CASES_D64, B_FWD, B_BWD_D64) if args.d64 else
                           (CASES_CLUSTERS, B_FWD, B_BWD_D64) if args.clusters else
                           (CASES_D160, B_D160, B_D160) if args.d160 else (CASES, B_FWD, B_BWD))

    import torch

    if not torch.cuda.is_available():
        print("attention_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from stablekeypoints_tpu_torch.kernels import _build
    from stablekeypoints_tpu_torch.kernels._common import stream_handle
    from stablekeypoints_tpu_torch.kernels.cross_attn import cross_attention_bwd_plain
    from stablekeypoints_tpu_torch.kernels.flash import attention_bwd_plain, attention_plain, bwd_scratch

    def routed_scratch(lib, q, k):
        # a tree whose backward entries take a route argument (kq) after Z and
        # size their scratch themselves: (Z, its route, the scratch)
        dims = (q.shape[0], q.shape[1], k.shape[1], q.shape[2], q.shape[3])
        fn, route, size = lib.skp_attn_bwd_splits, lib.skp_attn_bwd_kq, lib.skp_attn_bwd_scratch
        fn.argtypes = route.argtypes = [ctypes.c_int] * 5
        size.argtypes = [ctypes.c_int] * 7
        fn.restype, route.restype, size.restype = ctypes.c_int, ctypes.c_int, ctypes.c_longlong
        z, kq = fn(*dims), route(*dims)
        return z, kq, torch.empty(size(*dims, z, kq), dtype=torch.float32, device="cuda")

    if args.cases:
        cases = tuple(cases[int(i)] for i in args.cases.split(","))
    keep = set(filter(None, args.variants.split(","))) | {"kernel"}
    variants = {n: (CSRC, subs) for n, subs in VARIANTS.items()
                if len(keep) == 1 or n in keep}
    if args.parent:
        variants["parent"] = (os.path.join(args.parent, "stablekeypoints_tpu_torch", "kernels",
                                           "csrc"), [])
    libs = build(_build._nvcc_path(), OUT, variants, tuple(sorted({c[0] for c in cases})))
    print(card())
    gen = torch.Generator(device="cuda").manual_seed(0)
    P = ctypes.c_void_p

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    for src, label, n, m, h, d in cases:
        scale = d ** -0.5
        q, k, v = randn(b_fwd, n, h, d), randn(b_fwd, m, h, d), randn(b_fwd, m, h, d)
        ref = None
        for name in variants if not args.no_forward else ():
            lib, out = libs[name][src], torch.empty_like(q)
            fwd = lib.skp_flash_fwd if src == "flash" else lib.skp_cross_fwd
            ptrs = [P(x.data_ptr()) for x in (q, k, v, out)] + ([None] if src == "flash" else [])
            fwd.argtypes = [P] * len(ptrs) + [ctypes.c_int] * 5 + [ctypes.c_float, P]
            fwd.restype = ctypes.c_int

            def call(fwd=fwd, ptrs=ptrs):
                assert fwd(*ptrs, b_fwd, n, m, h, d, scale, stream_handle()) == 0

            ms = device_ms(torch, call, args.reps)
            ref = out.float() if ref is None else ref
            err = (out.float() - ref).abs().max().item()
            print(f"{label} fwd q[{b_fwd},{n},{h},{d}] kv {m} {name:<13} {ms:.4f} ms  "
                  f"max diff from kernel {err:.2e}", flush=True)
        if ref is not None:  # the kernel against the plain version
            want = attention_plain(q, k, v, scale).float()
            print(f"{label} fwd q[{b_fwd},{n},{h},{d}] kv {m} kernel against plain "
                  f"{((ref - want).abs().max() / want.abs().max()).item():.2e} of max (tol 2^-7)", flush=True)
            del want
        if args.d160 and m != T:  # no backward row at 77 tokens
            continue
        q, k, v, do = (randn(b_bwd, r, h, d) for r in (n, m, m, n))
        ref = None
        for name in variants:
            lib = libs[name][src]
            lse, di = (torch.empty((b_bwd, h, n), device="cuda") for _ in range(2))
            # an earlier tree's backward entries take an fp32 dq scratch after di
            with open(os.path.join(variants[name][0], "flash.cu")) as f:
                acc = ([torch.empty((b_bwd, h, n, d), device="cuda")]
                       if "void* di, void* dq_acc" in f.read() else [])
            # the backward's query split (an earlier tree's kernels may take
            # none, or a route argument after it)
            splits = []
            if hasattr(lib, "skp_attn_bwd_kq"):
                z, kq, part = routed_scratch(lib, q, k)
                acc.append(part)
                splits = [z, kq]
            elif hasattr(lib, "skp_attn_bwd_splits"):
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
            if ref is None:  # the kernel: against the plain version and against a second launch
                o_kernel = o if src == "flash" else None
                ref = [g.float() for g in grads]
                call()
                torch.cuda.synchronize()
                same = all(torch.equal(g.float(), r) for g, r in zip(grads, ref))
                want = (attention_bwd_plain(q, k, v, o_kernel, do, scale) if src == "flash"
                        else cross_attention_bwd_plain(q, k, v, do, scale))
                plain_err = max(((g - w.float()).abs().max() / w.float().abs().max()).item()
                                for g, w in zip(ref, want))
                del want
                print(f"{label} bwd q[{b_bwd},{n},{h},{d}] kv {m} kernel against plain {plain_err:.2e} "
                      f"of each gradient's max (tol 2^-6), two launches bitwise equal: {same}", flush=True)
            err = max(((g.float() - r).abs().max() / r.abs().max()).item() for g, r in zip(grads, ref))
            print(f"{label} bwd q[{b_bwd},{n},{h},{d}] kv {m} {name:<13} {ms:.4f} ms  "
                  f"max diff from kernel {err:.2e} of each gradient's max"
                  + (f"  (query split {splits[0]}{', keys-major' if splits[1:] == [1] else ''})"
                     if splits else ""), flush=True)
    return 0


# the rows the mutation checks run: (kind, library, b, n, m, h, d); d 160
# K3 at SD-1.5 1536^2, --d64 the SDXL backward shapes of K3 (500 tokens:
# its statistics sweep, then the keys-major pass) and K4 (the two passes)
MUTATION_ROWS = {"fwd": [("fwd", "cross_attn", 2, 2304, T, 8, 160)],
                 "bwd": [("bwd", "cross_attn", 2, 2304, T, 8, 160)], "kq": []}
MUTATION_ROWS_D64 = {"fwd": [], "bwd": [("bwd", "cross_attn", 2, 4096, T, 10, 64),
                                        ("flash_bwd", "flash", 2, 1024, 1024, 20, 64)],
                     "kq": [("bwd", "cross_attn", 2, 4096, T, 10, 64)]}
# --emulate: K3's keys-major pass in the CPU emulation of the kernels
# (tests/cuda_emu), at small shapes: a cluster of 4 covering 500 keys, and
# one of 3 (257 keys) over 5 query tiles, its exchange buffers reused
MUTATION_ROWS_EMU = {"fwd": [], "bwd": [],
                     "kq": [("bwd", "cross_attn", 1, 128, T, 1, 64),
                            ("bwd", "cross_attn", 1, 300, 257, 1, 64)]}
# one row in the emulation (argv: repo, library directory, kind, b, n, m,
# h, d), as MUTATION_CHILD
EMU_CHILD = r"""
import importlib.util, json, os, sys
sys.path[:0] = [sys.argv[1], os.path.join(sys.argv[1], "tests")]
import ctypes, torch
spec = importlib.util.spec_from_file_location("emu", os.path.join(sys.argv[1], "tests", "test_torch_cuda_emulation.py"))
emu = importlib.util.module_from_spec(spec)
spec.loader.exec_module(emu)
from stablekeypoints_tpu_torch.kernels.cross_attn import cross_attention_bwd_plain
from stablekeypoints_tpu_torch.kernels.flash import attention_bwd_plain
src = "flash" if sys.argv[3] == "flash_bwd" else "cross_attn"
libs = {src: ctypes.CDLL(os.path.join(sys.argv[2], src + ".so"))}
b, n, m, h, d = map(int, sys.argv[4:9])
gen = torch.Generator().manual_seed(0)
q, k, v, do = (emu._randn(gen, b, r, h, d) for r in (n, m, m, n))
s = d ** -0.5
got, out = emu._attention_bwd(libs, src, q, k, v, do, s)
want = attention_bwd_plain(q, k, v, out, do, s) if src == "flash" else cross_attention_bwd_plain(q, k, v, do, s)
err = max(((g.float() - w.float()).abs().max() / w.float().abs().max()).item() for g, w in zip(got, want))
print(json.dumps({"rc": 0, "err": err if all(torch.isfinite(g.float()).all() for g in got) else float("nan"),
                  "tol": 2.0**-6}))
"""


def _emulated_build(out_dir: str, csrc: str) -> None:
    """The tests' emulated build of `csrc`'s flash.cu and cross_attn.cu
    (host g++, tests/cuda_emu) into out_dir."""
    import importlib.util
    import subprocess

    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    spec = importlib.util.spec_from_file_location(
        "emu", os.path.join(REPO, "tests", "test_torch_cuda_emulation.py"))
    emu = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emu)
    os.makedirs(out_dir, exist_ok=True)
    emu._emulated_sources(out_dir, csrc)
    for name in SOURCES:
        subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-w", f"-I{out_dir}",
                        f"-I{emu.EMU}", "-o", os.path.join(out_dir, f"{name}.so"),
                        os.path.join(out_dir, f"{name}.cpp")], check=True, capture_output=True)


def mutations(args) -> int:
    """Build each mutation and run its rows in a fresh process each, with a
    time limit: each must fail against the plain version (or not finish);
    the unmutated kernel must pass. On the card (nvcc, all builds at once)
    or, with --emulate, in the CPU emulation (g++), where a TMA or bulk copy
    lands only when its mbarrier is waited on."""
    import json
    import shutil
    import subprocess
    from concurrent.futures import ThreadPoolExecutor

    sys.path.insert(0, REPO)
    keep = set(filter(None, args.variants.split(",")))
    table = MUTATION_ROWS_EMU if args.emulate else MUTATION_ROWS_D64 if args.d64 else MUTATION_ROWS
    chosen = {n: m for n, m in MUTATIONS.items() if (not keep or n in keep) and table[m[0]]}
    variants = {"kernel": (CSRC, [])}
    variants.update({n: (CSRC, subs) for n, (_, subs) in chosen.items()})
    if args.emulate:
        out = os.path.join(OUT, "emulated")

        def one(item):
            name, (src_dir, subs) = item
            d = os.path.join(out, name, "csrc")
            shutil.rmtree(os.path.join(out, name), ignore_errors=True)
            shutil.copytree(src_dir, d)
            for fn, old, new in subs:
                with open(os.path.join(d, fn)) as f:
                    text = f.read()
                if old not in text:
                    raise RuntimeError(f"{name}: {old!r} not found in {fn}")
                with open(os.path.join(d, fn), "w") as f:
                    f.write(text.replace(old, new))
            _emulated_build(os.path.join(out, name), d)

        with ThreadPoolExecutor(4) as pool:
            list(pool.map(one, variants.items()))
        child, limit = EMU_CHILD, 600
        print("the CPU emulation (tests/cuda_emu)")
    else:
        from stablekeypoints_tpu_torch.kernels import _build

        out = OUT
        build(_build._nvcc_path(), OUT, variants, SOURCES)  # each row loads its library in its own process
        child, limit = MUTATION_CHILD, 90
        print(card())
    ok = True
    rows = [("kernel", row) for rows in table.values() for row in rows]
    rows += [(n, row) for n, (kind, _) in chosen.items() for row in table[kind]]
    for name, (kind, src, b, n, m, h, d) in rows:
        lib = os.path.join(out, name) if args.emulate else os.path.join(out, name, f"{src}.so")
        cmd = [sys.executable, "-c", child, REPO, lib, kind] + [str(x) for x in (b, n, m, h, d)]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True, timeout=limit)
            res = json.loads(r.stdout.strip().splitlines()[-1]) if r.returncode == 0 else None
            what = (f"rc {res['rc']}, err {res['err']:.3e} of max (tol {res['tol']:.0e})" if res
                    else f"process failed ({r.returncode}): {r.stderr.strip().splitlines()[-1:]}")
            failed = res is None or res["rc"] != 0 or not res["err"] <= res["tol"]
        except subprocess.TimeoutExpired:
            what, failed = f"hung (killed after {limit} s)", True
        want_fail = name.startswith("mut_")
        ok = ok and failed == want_fail
        verdict = ("fails, as it must" if failed else "PASSES: no check shows this wait") if want_fail \
            else ("passes" if not failed else "FAILS")
        print(f"[mutation] {name:<16} {kind} q[{b},{n},{h},{d}] kv {m}: {what}: {verdict}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
