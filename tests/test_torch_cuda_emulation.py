"""The port's CUDA kernels, run on the CPU, against their plain versions.

There is no GPU and no nvcc on the test machines, so without this the
index math of `stablekeypoints_tpu_torch/kernels/csrc/*.cu` (fragment
layouts, tile offsets, masks, the cp.async double buffers, the cross-warp
exchanges) would be checked only on the card by `chip_smoke.py`. Here each
source is compiled by the host C++ compiler with `tests/cuda_emu/` in place
of the CUDA headers: every CUDA thread of a block is an OS thread,
`__syncthreads` and the warp collectives are barriers, and the inline-PTX
helpers of `common.cuh` (mma.sync m16n8k16 bf16, ldmatrix, cp.async, wgmma
with K-major and MN-major operands, TMA tensor copies and mbarriers, named
barriers, ex2.approx, the cluster primitives: another
block's shared memory, loads, stores, bulk copies and mbarrier arrivals
there, the cluster barrier) are swapped for emulations that follow the PTX ISA's
layouts (`cuda_emu/emu_ops.h`; wgmma and cp.async complete at once; a TMA
or bulk copy counts its bytes when issued but lands only when a wait on
its mbarrier sees the phase complete, so a kernel that reads a tile
without that wait reads NaN or an earlier tile; TMA boxes and wgmma
descriptors in the no-swizzle and the 128-byte swizzle layouts). Blocks run
one at a time, a cluster's blocks (up to 8) at once, each block with its
own shared memory. Unwritten shared memory reads as NaN, a shared-memory
request above the sm_90 limit fails the launch, and a misaligned cp.async,
ldmatrix, descriptor, TMA or bulk copy address aborts. What only the card
can say (the real compiler, timing, a missing wgmma or cp.async wait, races
between warps that the barriers here hide) stays with `chip_smoke.py`.

Tolerances are those `chip_smoke.py` holds the kernels to on the card:
attention outputs within 2^-7 of their largest magnitude (2 bf16 ulps at
the top binade: the kernels sum in another order, and flash rounds
unnormalised p to bf16), capture maps within 1e-4 absolute (fp32 maps of
magnitude <= 1, sums in another order), K7's conv outputs within 2^-6 of
their largest magnitude (one bf16 ulp for the elementwise roundings, one
for a conv sum in another order that lands across a rounding boundary and
carries through the bias and residual adds), GroupNorm coefficients within
2^-7 of each output's largest magnitude (m_q is the mean rounded to bf16:
one ulp) and the scale a within 2e-5 relative (fp32 sums in another
order). Gradients (bf16) within 2^-6 of their largest magnitude: dsim is
rounded to bf16 before the products, from
a p that the kernels compute in another order than the plain version (an
element near a rounding boundary can round the other way), and each
gradient sums hundreds of such terms.
"""

import torch_threads  # noqa: F401  (torch's threads: this xdist worker's share)
import ctypes
import os
import re
import shutil
import subprocess

import pytest
import torch

from stablekeypoints_tpu_torch.kernels import attn_capture, cross_attn, flash, gn_conv
from stablekeypoints_tpu_torch.kernels.groupnorm import _DTYPE_CODES, gn_affine_coeffs_plain
from stablekeypoints_tpu_torch.ops.resize import resize_matrix

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "..", "stablekeypoints_tpu_torch", "kernels", "csrc")
EMU = os.path.join(HERE, "cuda_emu")
SOURCES = ("attn_capture", "cross_attn", "flash", "gn_conv", "groupnorm")
PTX_HELPERS = ("mma_bf16", "load_b", "ldsm_x4", "stsm_x4", "cp_async16", "cp_async_commit",
               "cp_async_wait_all", "cp_async_wait_1", "cp_async_wait", "cp_async4", "wgmma_m64n128k16", "wgmma_m64n128k16_ss",
               "wgmma_m64n256k16", "wgmma_m64n128k16_tb", "wgmma_m64n32k16", "wgmma_m64n32k16_tb",
               "wgmma_m64n40k16_tb", "wgmma_m64n16k16_tb", "wgmma_m64n64k16", "wgmma_m64n64k16_tb", "wgmma_m64n80k16_tb",
               "wgmma_m64n256k16_ss", "wgmma_m64n64k16_ss", "wgmma_m64n40k16_ss_tt", "wgmma_m64n64k16_ss_tt",
               "wgmma_m64n80k16_ss_tt",
               "wgmma_m64n160k16_tb", "wgmma_m64n160k16_ss_tt", "wgmma_m64n32k16_ss",
               "wgmma_m64n256k16_ss_tb", "wgmma_m64n80k16_ss", "wgmma_m64n32k16_ss_tt",
               "named_bar_sync", "named_bar_arrive", "setmaxnreg_inc", "setmaxnreg_dec",
               "reg_fence", "frag_fence", "wgmma_fence", "wgmma_commit",
               "wgmma_wait0", "wgmma_wait1", "fence_proxy_async", "fast_exp2",
               "smem_u32",
               "mbar_init", "mbar_fence_init", "mbar_expect_tx", "mbar_arrive", "mbar_wait",
               "tma_load_4d",
               "tma_load_2d", "tma_store_4d", "cluster_rank", "cluster_map", "st_cluster_f32x2", "ld_cluster_f32",
               "ld_cluster_f32x2",
               "mbar_arrive_cluster", "mbar_wait_cluster", "bulk_copy_to_cluster", "bulk_commit",
               "bulk_wait_read", "cluster_sync")
BF = torch.bfloat16


def _drop_function(src: str, name: str) -> str:
    m = re.search(r"(template <[^>]*>\s*)?__device__ __forceinline__ \w+ " + name + r"\(", src)
    assert m, f"{name} not found in common.cuh"
    depth = 0
    for j in range(src.index("{", m.end()), len(src)):
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        if depth == 0:
            return src[: m.start()] + src[j + 1 :]
    raise AssertionError(f"unbalanced braces after {name}")


def _emulated_sources(out_dir: str, csrc: str = CSRC) -> None:
    """The sources of `csrc` (default: the port's) rewritten for the host
    compiler into `out_dir`: the PTX helpers of common.cuh swapped for
    cuda_emu/emu_ops.h, every launch for emu_launch."""
    with open(os.path.join(csrc, "common.cuh")) as f:
        common = f.read()
    for name in PTX_HELPERS:
        common = _drop_function(common, name)
    anchor = "typedef __nv_bfloat16 bf16;"
    assert anchor in common
    common = common.replace(anchor, anchor + '\n#include "emu_ops.h"')
    files = [(f"{name}.cu", f"{name}.cpp") for name in SOURCES]
    files += [(fn, fn) for fn in sorted(os.listdir(csrc)) if fn.endswith(".cuh")]
    launches = 0
    for src_name, out_name in files:
        if src_name == "common.cuh":
            src = common
        else:
            with open(os.path.join(csrc, src_name)) as f:
                src = f.read()
        src, n = re.subn(r"(\w+(?:<[\w, ]+>)?)<<<(.*?)>>>\((.*?)\);",
                         r"emu_launch(\2, [&] { \1(\3); });", src, flags=re.S)
        # each block's shared memory is its own (a cluster's blocks run at once)
        src = re.sub(r"extern __shared__ __align__\(\d+\) unsigned char smem\[\];",
                     "unsigned char* smem = emu_smem();", src)
        launches += n
        with open(os.path.join(out_dir, out_name), "w") as f:
            f.write(src)
    assert launches >= len(SOURCES), "kernel launches not found"


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = str(tmp_path_factory.mktemp("cuda_emu"))
    _emulated_sources(out)
    procs = {
        name: subprocess.Popen(
            [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-w",
             f"-I{out}", f"-I{EMU}", "-o", os.path.join(out, f"{name}.so"),
             os.path.join(out, f"{name}.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for name in SOURCES
    }
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"{name}.cu did not compile:\n{log}"
    return {name: ctypes.CDLL(os.path.join(out, f"{name}.so")) for name in SOURCES}


# the capture entries' last arguments: scale, stream, total_heads
CAPTURE_TAIL = [ctypes.c_float, ctypes.c_void_p, ctypes.c_int]


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen).to(BF)


def _flash_fwd(libs, q, k, v, out, lse, scale):
    b, n, h, d = q.shape
    fn = libs["flash"].skp_flash_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn(_ptr(q), _ptr(k), _ptr(v), _ptr(out), None if lse is None else _ptr(lse),
              b, n, k.shape[1], h, d, scale, None)


def _assert_grads_close(got, want):
    for g, w in zip(got, want):
        assert torch.isfinite(g.float()).all()
        torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                   atol=2.0**-6 * w.float().abs().max().item())


@pytest.mark.parametrize("source,b,n,m,h,d", [
    ("flash", 1, 128, 128, 2, 40),   # K4 self-attention, d padded to 48
    ("flash", 1, 80, 100, 1, 80),    # K5: kv tail tile masked, ragged query tile
    ("flash", 1, 300, 200, 1, 40),   # 4 key tiles: the 3-stage ring wraps, the
                                     # next tile's scores in flight; an 8-key tail
    ("flash", 1, 64, 77, 1, 40),     # one warpgroup's rows valid, a 77-token kv tail
    ("flash", 2, 100, 45, 1, 512),   # the d-512 kernel: the second warpgroup's keys past 45
                                     # masked, a ragged query tile
    ("flash", 1, 256, 256, 1, 512),  # 4 key tiles: the k and v stages refilled 3 times each
    ("flash", 1, 70, 150, 2, 512),   # 3 key tiles, the last with 22 keys (the second
                                     # warpgroup's all masked); 2 heads; 6 query rows past 64
    ("cross_attn", 1, 200, 100, 2, 40),  # K3: two blocks, the second one ragged
    ("cross_attn", 1, 128, 77, 1, 80),
    ("cross_attn", 1, 256, 100, 1, 40),  # two full blocks, a 100-token kv tail
    ("cross_attn", 1, 136, 200, 1, 80),  # both passes over 4 key tiles (ring wraps)
    # the unconditional context of classifier-free guidance (77 tokens) at the
    # full UNet's cross-attention shapes: K5 at d 80 (32^2), K3 at d 40 (64^2)
    ("flash", 1, 128, 77, 2, 80),
    ("cross_attn", 1, 256, 77, 2, 40),
    # d 64 (SD-2.x / SDXL heads): no padding chunk (DP == D), two warpgroups
    ("flash", 1, 300, 200, 2, 64),     # K4: the ring wraps, an 8-key tail, a ragged query tile
    ("flash", 1, 128, 500, 1, 64),     # K5 at the learned tokens: a 52-key tail tile
    ("flash", 1, 64, 77, 2, 64),       # K5 at the unconditional 77 tokens
    ("cross_attn", 1, 200, 500, 2, 64),  # K3: the second warpgroup's keys 256-499, a ragged tile
    ("cross_attn", 1, 256, 77, 1, 64),   # K3 at 77 tokens: the second warpgroup all masked
    # the d-64 warp-specialized K4/K5 (128-key tiles, two-stage k and v rings, two
    # consumer warpgroups taking turns) and the persistent K3 (key extent from T)
    ("flash", 1, 300, 700, 2, 64),     # 6 key tiles: both rings wrap, a 60-key tail; 44 rows
                                       # past the second 128-row block
    ("flash", 2, 200, 500, 1, 64),     # K5 at 500 tokens: 4 tiles, a 116-key tail; two images
    ("flash", 1, 256, 128, 1, 64),     # one full key tile: the turns with a single tile
    ("flash", 1, 128, 77, 2, 64),      # K5 at 77 tokens: one tile, 51 keys masked
    ("cross_attn", 2, 200, 77, 3, 64),   # extent 80: 24 tiles over 4 blocks (2 "SMs" x 2), each
                                         # walking tiles of two (b, h), warpgroups on their own
                                         # tiles; a ragged tile every (b, h)
    ("cross_attn", 1, 130, 200, 3, 64),  # extent 256: one warpgroup a tile over 200 keys
    ("cross_attn", 2, 136, 500, 2, 64),  # extent 512: 12 tiles over 2 blocks, the query ring
                                         # wrapping, k and v reloaded for a second (b, h)
    ("cross_attn", 1, 100, 5, 2, 64),    # 5 tokens: 75 of the 80 columns masked
    # d 160 (SD-1.5's 1280-channel levels at 1536^2): the persistent kernel at the
    # guidance's 77 tokens; above 80 tokens the cluster of two blocks (cross_pair_kernel:
    # one cluster of the 2 "SMs" walking every tile in rounds of two, the blocks'
    # (max, sum) and partial-output exchanges, k and v reloaded at each (b, h))
    ("cross_attn", 1, 200, 77, 1, 160),  # extent 80, one head, a ragged last tile (8 rows)
    ("cross_attn", 2, 136, 77, 3, 160),  # 3 heads, two images: tiles of 6 (b, h) over 2 "SMs"
    ("cross_attn", 1, 200, 130, 3, 160),  # the second block's keys all masked (its max -inf, its
                                          # partial output zero); 3 (b, h)s of 4 tiles; 56 rows ragged
    ("cross_attn", 1, 136, 500, 1, 160),  # a 12-key tail in the second block; 3 tiles: the last
                                          # round's second warpgroup idle; 8 rows past 128
    ("cross_attn", 2, 70, 500, 3, 160),   # 6 (b, h)s of 2 tiles: k and v reloaded 5 times
    ("cross_attn", 2, 200, 500, 2, 160),  # 16 tiles: the query slots' exchange parities wrap
    ("cross_attn", 1, 100, 257, 2, 160),  # one key in the second block: its max and sum from one
                                          # score
    ("cross_attn", 1, 136, 500, 2, 160),  # 2 (b, h)s of 3 tiles: a reload after a round whose
                                          # second warpgroup idles
    # d 80 on the persistent kernel too (the resident block kernel retired)
    ("cross_attn", 1, 136, 500, 2, 80),   # extent 512: the key split, a ragged tile
    # d 64 at extent 512: the two consumer warpgroups split each tile's keys
    # (0-255, 256-511) and exchange row max, sum and partial output
    ("cross_attn", 1, 136, 300, 2, 64),   # the second half ragged: 44 keys, 212 masked
    ("cross_attn", 2, 200, 257, 1, 64),   # one key past 256: the second half's max and sum
                                          # from one score; two images
    ("cross_attn", 1, 320, 512, 3, 64),   # every key present, 3 heads: 15 tiles over 2 "SMs"
])
def test_attention_kernel_matches_plain(libs, source, b, n, m, h, d):
    gen = torch.Generator().manual_seed(n * m + d)
    q, k, v = _randn(gen, b, n, h, d), _randn(gen, b, m, h, d), _randn(gen, b, m, h, d)
    out = torch.full_like(q, float("nan"))
    scale = d ** -0.5
    if source == "flash":
        assert _flash_fwd(libs, q, k, v, out, None, scale) == 0
    else:
        fn = libs[source].skp_cross_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        assert fn(_ptr(q), _ptr(k), _ptr(v), _ptr(out), b, n, m, h, d, scale, None) == 0
    want = flash.attention_plain(q, k, v, scale).float()
    torch.testing.assert_close(out.float(), want, rtol=0,
                               atol=2.0**-7 * want.abs().max().item())


@pytest.mark.parametrize("b,h,o,x,p,t,d", [
    (1, 2, 2, 16, 128, 100, 160),  # up_1's shape class: 16 -> 128, d 160
    (1, 2, 1, 32, 128, 70, 80),    # up_2's: 32 -> 128, d 80
    (2, 1, 1, 16, 40, 30, 80),     # a ragged column block
    (1, 2, 1, 16, 128, 500, 160),  # the detect token count: the second warpgroup's last
                                   # stage ragged (keys 384-499 of 512)
    (1, 3, 1, 32, 96, 77, 80),     # 3 heads (first, middle, last), a full and a ragged
                                   # 64-row tile, 77 tokens (odd: scalar stores)
    (1, 1, 2, 16, 40, 300, 160),   # one head (first = last), keys past 256 in the second
                                   # warpgroup, two output rows
    # d 64: one 64-column swizzle block a head (CB = 1, no partial block)
    (1, 20, 1, 24, 64, 77, 64),    # SD-2.1's up_1: 20 heads (head-parity buffers wrap ten
                                   # times), X 24 (the second 16-row x-step ragged)
    (1, 20, 2, 32, 64, 500, 64),   # SDXL's up_0: 20 heads, X 32, 500 tokens, two output rows
    (1, 3, 1, 24, 96, 130, 64),    # 3 heads, a full and a ragged 64-row block
    # the d-64 forward's exchange barriers by head parity, per-half statistics
    (1, 1, 2, 24, 40, 300, 64),    # one head (first = last), keys past 256 in the second
                                   # warpgroup's first half, ragged 40-column rows
    (2, 5, 1, 32, 64, 129, 64),    # 5 heads, two images, 129 tokens: the first warpgroup's
                                   # second half one key, the second warpgroup all masked
    # past 512 tokens: a cluster of ceil(T / 512) blocks a 64-row block, each
    # holding an even, balanced key range; every block's (max, sum) of a row
    # read from the others' shared memory, the sum in rank order
    (1, 2, 1, 16, 40, 513, 160),   # a cluster of 2: keys 0-257 and 258-512 (the second
                                   # block's second warpgroup all masked), odd T: scalar stores
    (1, 3, 1, 24, 128, 1000, 64),  # 500 + 500 keys, 3 heads (the parity buffers wrap), X 24,
                                   # two 64-row blocks
    (1, 2, 1, 32, 256, 1500, 80),  # a cluster of 3 (500 keys each), P 256: four 64-row blocks
    (1, 1, 1, 16, 64, 2100, 160),  # a cluster of 5 (420 keys each), one head (first = last)
    (1, 2, 2, 16, 40, 4096, 64),   # a cluster of 8 (512 keys each), two output rows
])
def test_capture_kernel_matches_plain(libs, b, h, o, x, p, t, d):
    gen = torch.Generator().manual_seed(x * p + d)
    tt, k = _randn(gen, b, h, o, x, d), _randn(gen, b, t, h, d)
    ww = resize_matrix(x, p, "bicubic", BF, "cpu")
    out = torch.full((b, o * p, t), float("nan"))
    scale = d ** -0.5
    fn = libs["attn_capture"].skp_capture_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + CAPTURE_TAIL
    fn.restype = ctypes.c_int
    assert fn(_ptr(tt), _ptr(ww), _ptr(k), _ptr(out), b, h, o, x, p, t, d, scale, None, h) == 0
    want = attn_capture.capture_fused_plain(tt, ww, k, scale)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-4)


def test_unsupported_head_dim_is_refused(libs):
    meta = torch.empty(0, dtype=BF)
    q = meta.new_empty(1, 128, 1, 48)
    assert _flash_fwd(libs, q, q, q, q, None, 1.0) == -1
    wide = meta.new_empty(1, 128, 1, 512)  # d 512 has no backward, so no lse
    assert _flash_fwd(libs, wide, wide, wide, wide, torch.empty(1), 1.0) == -1


@pytest.mark.parametrize("source,b,n,m,h,d", [
    ("flash", 1, 128, 128, 2, 40),   # K4 backward, d padded to 48; 2 key blocks
    ("flash", 1, 80, 100, 1, 80),    # K5: kv tail masked, ragged query tile
    ("flash", 1, 150, 200, 1, 40),   # 2 key blocks, 4 key tiles a row block, an 8-key tail
    ("flash", 1, 96, 77, 1, 80),     # a 77-token kv tail at d 80
    ("cross_attn", 1, 200, 100, 2, 40),  # K3: row statistics recomputed
    ("cross_attn", 1, 128, 77, 1, 80),
    ("cross_attn", 1, 130, 100, 1, 80),  # statistics over two blocks, the second ragged
    # d 64 (K4/K5: the rows pass with the forward's statistics given, one sweep,
    # then the keys pass; K3: its statistics sweep, then the keys-major pass): no
    # padding chunk (DP == D)
    ("flash", 1, 150, 200, 2, 64),   # K4: 4 key tiles a row block, a ragged query tile
    ("flash", 1, 96, 500, 1, 64),    # K5 at 500 tokens: 8 key tiles, a 52-key tail
    ("flash", 1, 64, 77, 2, 64),     # K5 at 77 tokens: one row block's second warpgroup empty
    ("cross_attn", 1, 130, 500, 1, 64),  # K3: statistics over 8 key tiles, a ragged query tile
    ("cross_attn", 1, 64, 77, 2, 64),
    ("flash", 1, 300, 300, 1, 64),   # 3 key blocks (the last of 44 keys: its second
                                     # warpgroup all masked), 5 query tiles: the ring wraps
    ("flash", 2, 96, 200, 2, 64),    # 2 key blocks of 128 and 72 keys, two images
    ("flash", 1, 320, 500, 1, 64),   # K5 at 500 tokens: 4 key blocks, a 116-key tail
    ("cross_attn", 1, 200, 77, 2, 64),  # K3 at 77 tokens: keys 64-76 in the second warpgroup
    # the query tiles of a key block split over Z blocks (test_backward_splits):
    # fp32 partial dk, dv summed in order by the finishing pass
    ("flash", 1, 640, 100, 1, 64),      # Z 2: 5 of the 10 query tiles a block, the ring wrapping
    ("cross_attn", 1, 640, 77, 1, 64),  # K3, Z 2
    # key counts past K3's 512
    ("flash", 1, 200, 700, 1, 64),     # 11 key tiles a row block (the ring wrapping 3 times), a
                                       # 60-key tail; a 72-row second row block; 6 key blocks
    ("flash", 1, 1024, 520, 1, 64),    # past 512 keys: 9 key tiles (an 8-key tail); 5 key
                                       # blocks, their 16 query tiles split Z 2
    # d 160: the rows pass (128 query rows a block, k and v streamed twice through a
    # 3-stage ring, dq whole in registers) and the keys pass (128 keys a block, q and
    # dO through a 3-stage ring, Z blocks a key block where "SMs" idle, the fp32
    # partials of dk and dv summed in order): no reduce-adds
    ("cross_attn", 1, 200, 77, 3, 160),  # 2 key tiles (13 keys in the second), 3 heads, a ragged
                                         # last query tile; the keys pass split Z 2
    ("cross_attn", 2, 136, 500, 1, 160),  # 8 key tiles a sweep (the ring wrapping 5 times), a
                                          # 52-key tail; 4 key blocks a (b, h); two images
    ("cross_attn", 1, 200, 500, 2, 160),  # the second row block's second warpgroup 8 rows; the
                                          # last key block's second warpgroup 52 keys
    ("cross_attn", 1, 320, 100, 1, 160),  # one key block, 5 query tiles split Z 2 (3 and 2)
    ("cross_attn", 1, 130, 257, 2, 160),  # one key in the third key block; a 2-row last tile
    # d 40 on the rows and keys passes: depth 48 (columns 40-47 zero in q, dO, k and v)
    ("cross_attn", 1, 300, 500, 1, 40),  # 3 row blocks (a 44-row last), 8 key tiles, 4 key blocks
    ("cross_attn", 1, 640, 100, 1, 40),  # one key block, 10 query tiles split Z 2
    # K3's d-64 keys-major pass (after its statistics sweep): a cluster of C key
    # blocks, each tile's dq summed over the cluster in rank order (bulk copies
    # between the blocks' shared memory)
    ("cross_attn", 1, 128, 500, 2, 64),  # a cluster of 4 covers 500 keys (116 in the last block)
    ("cross_attn", 2, 130, 384, 1, 64),  # a cluster of 3 full blocks, two images, a 2-row last tile
    ("cross_attn", 1, 200, 257, 1, 64),  # one key in the third block; slices of 22, 21 and 21 rows
    ("cross_attn", 2, 96, 200, 2, 64),   # clusters of 2 (32-row slices), two images and heads
    ("cross_attn", 1, 300, 129, 1, 64),  # one key in the second block; 5 query tiles (the ring
                                         # wraps), a 44-row last tile
    ("cross_attn", 1, 640, 100, 1, 64),  # one block (no exchange), 10 query tiles split Z 2
    ("cross_attn", 2, 64, 77, 3, 64),    # one block a (b, h), 6 (b, h)s: dq written at once
])
def test_attention_backward_kernel_matches_plain(libs, source, b, n, m, h, d):
    gen = torch.Generator().manual_seed(n * m + d + 1)
    q, k, v = _randn(gen, b, n, h, d), _randn(gen, b, m, h, d), _randn(gen, b, m, h, d)
    do = _randn(gen, b, n, h, d)
    scale = d ** -0.5
    got, out = _attention_bwd(libs, source, q, k, v, do, scale)
    if source == "flash":
        want = flash.attention_bwd_plain(q, k, v, out, do, scale)
    else:
        want = cross_attn.cross_attention_bwd_plain(q, k, v, do, scale)
    _assert_grads_close(got, want)


def _flash_out(libs, q, k, v, scale):
    b, n, h, _ = q.shape
    out = torch.full_like(q, float("nan"))
    lse = torch.full((b, h, n), float("nan"))
    assert _flash_fwd(libs, q, k, v, out, lse, scale) == 0
    return out, lse


def _attention_bwd(libs, source, q, k, v, do, scale):
    """((dq, dk, dv), the forward's output or None) of K4/K5's (`flash`,
    after its forward) or K3's (`cross_attn`) backward entry, every output
    and scratch NaN before."""
    b, n, h, d = q.shape
    m = k.shape[1]
    dq, dk, dv = (torch.full_like(x, float("nan")) for x in (q, k, v))
    di = torch.full((b, h, n), float("nan"))
    # the keys pass splits a key block's query tiles over `splits` blocks when
    # the grid would leave "SMs" (2 here) idle; fp32 partials of dk, dv in dkv_part
    splits, dkv_part = flash.bwd_scratch(libs[source], q, k)
    dkv_part.fill_(float("nan"))
    if source == "flash":
        out, lse = _flash_out(libs, q, k, v, scale)
        fn = libs["flash"].skp_flash_bwd
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        assert fn(*map(_ptr, (q, k, v, out, do, lse, di, dkv_part, dq, dk, dv)), b, n, m, h, d,
                  splits, scale, None) == 0
    else:
        out, lse = None, torch.full((b, h, n), float("nan"))
        fn = libs["cross_attn"].skp_cross_bwd
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        assert fn(*map(_ptr, (q, k, v, do, lse, di, dkv_part, dq, dk, dv)), b, n, m, h, d, splits,
                  scale, None) == 0
    return (dq, dk, dv), out


@pytest.mark.parametrize("source", ["flash", "cross_attn"])
def test_backward_splits(libs, source):
    """The keys pass of every K3/K4/K5 backward splits a key block's query
    tiles only where the grid would leave SMs idle (2 here), at every head
    dim, K3's and K4/K5's alike."""
    fn = libs[source].skp_attn_bwd_splits
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    assert fn(1, 640, 100, 1, 64) == 2    # one key block, 10 query tiles
    assert fn(1, 300, 300, 1, 64) == 5    # 3 key blocks, 5 tiles: one tile a block
    assert fn(1, 150, 200, 2, 64) == 1    # 4 blocks fill the 2 "SMs" twice
    assert fn(1, 640, 100, 1, 80) == 2    # d 80 and 40 alike
    assert fn(1, 640, 100, 1, 40) == 2
    assert fn(1, 320, 100, 1, 160) == 2   # one key block, 5 tiles
    assert fn(2, 136, 500, 1, 160) == 1   # 8 key blocks fill the 2 "SMs" four times


def _capture_bwd(libs, entry, tt, k, g, scale, ww=None):
    """(dt or dq, dk) of the K1 (`skp_capture_bwd`, tt [B, H, O, X, D] and
    ww) or K2 (`skp_capture_q_bwd`, q [B, H, N, D]) backward entry."""
    b, h, d = tt.shape[0], tt.shape[1], tt.shape[-1]
    t = k.shape[1]
    n = g.shape[1]
    dx, dk = torch.full_like(tt, float("nan")), torch.full_like(k, float("nan"))
    lse, c = torch.full((b, h, n), float("nan")), torch.full((b, h, n), float("nan"))
    dq_acc = torch.full((b, h, n, d), float("nan"))  # scratch: dt and dk partials
    gk, ldg = attn_capture.g_rows(g)
    fn = getattr(libs["attn_capture"], entry)
    fn.restype = ctypes.c_int
    if entry.startswith("skp_capture_bwd"):
        o, x, p = tt.shape[2], tt.shape[3], ww.shape[0]
        q = torch.full((b, h, n, d), float("nan")).to(BF)  # scratch: the upsampled queries
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + CAPTURE_TAIL
        assert fn(*map(_ptr, (tt, ww, k, gk, q, lse, c, dq_acc, dx, dk)), b, h, o, x, p, t, ldg,
                  d, scale, None, h) == 0
    else:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + CAPTURE_TAIL
        assert fn(*map(_ptr, (tt, k, gk, lse, c, dq_acc, dx, dk)), b, h, n, t, ldg, d, scale,
                  None, h) == 0
    return dx, dk


# Every K3/K4/K5 backward and the K1/K2 capture backward writes its
# gradients with no reduce-add or atomic, so they do not depend on the order
# in which the grid's blocks run: the emulation runs each launch's blocks in
# z, y, x order, in reverse and in a seeded permutation, and every gradient
# must be bitwise equal across the three. (The earlier d-64 K3/K4/K5
# backward, whose key blocks added their dq into an fp32 scratch by bulk
# reduce-adds, fails this at the first three K4/K5/K3 shapes, and the
# earlier d-80/160 capture backward, built the same way, at the five capture
# shapes of 500 tokens; at smaller ones the bf16 dq can round its fp32 sums'
# differences away.)
@pytest.mark.parametrize("entry,shape", [
    ("flash", (1, 256, 1024, 2, 64)),      # K4: 8 key blocks, 16 key tiles a row block
    ("flash", (1, 128, 500, 2, 64)),       # K5 at 500 tokens: 4 key blocks, 8 key tiles a row
    ("flash", (1, 640, 100, 1, 64)),       # Z 2: one key block's query tiles split, summed
    ("cross_attn", (1, 256, 500, 2, 64)),  # K3 at d 64, the learned tokens: 4 key blocks
    ("cross_attn", (1, 640, 77, 1, 64)),   # K3 at d 64, Z 2
    ("cross_attn", (1, 300, 500, 1, 40)),  # K3 at d 40
    ("cross_attn", (1, 320, 100, 1, 160)),  # K3 at d 160, Z 2
    ("flash", (1, 256, 1024, 1, 40)),      # K4 at d 40 (SD-1.5's down_0)
    ("flash", (1, 128, 500, 2, 80)),       # K5 at d 80 (SD-1.5's down_1)
    # K3's d-64 keys-major pass: dq summed over a cluster in rank order
    ("cross_attn", (1, 256, 300, 1, 64)),  # a cluster of 3 (slices of 22, 21 and 21 rows)
    ("cross_attn", (1, 128, 200, 2, 64)),  # a cluster of 2, two heads
    ("cross_attn", (1, 640, 100, 1, 64)),  # one block, Z 2
    ("cross_attn", (2, 136, 500, 1, 64)),  # a cluster of 4, two images, 8 rows past 128
    ("skp_capture_bwd", (1, 3, 4, 24, 128, 77, 64)),  # K1 at d 64: dt partials, Z 2
    ("skp_capture_q_bwd", (1, 1, 320, 100, 64)),      # K2 at d 64, Z 2
    # SD-1.5's capture backward at 500 tokens (four key blocks of 128 added
    # into each dq row by the earlier passes): K1 and K2 at d 160 and 80, and
    # the precise K2
    ("skp_capture_bwd", (1, 3, 2, 16, 128, 500, 160)),
    ("skp_capture_bwd", (1, 2, 2, 24, 128, 500, 160)),  # X 24: tt from device memory
    ("skp_capture_bwd", (1, 2, 2, 32, 128, 500, 80)),
    ("skp_capture_q_bwd", (1, 2, 256, 500, 160)),
    ("skp_capture_q_bwd", (1, 2, 256, 500, 80)),
    ("skp_capture_q_bwd_precise", (1, 2, 256, 500, 80)),
    # past 512 tokens (the rows pass over a cluster, dq summed across it in rank
    # order) and past 128 output columns (dt partials of four tiles)
    ("skp_capture_bwd", (1, 2, 1, 16, 128, 1000, 160)),
    ("skp_capture_bwd", (1, 1, 1, 24, 256, 600, 64)),
    ("skp_capture_q_bwd", (1, 2, 100, 1000, 80)),
    ("skp_capture_bwd_precise", (1, 1, 2, 32, 64, 700, 80)),
])
def test_backward_is_independent_of_block_order(libs, entry, shape):
    gen = torch.Generator().manual_seed(sum(shape))
    if entry in ("flash", "cross_attn"):
        b, n, m, h, d = shape
        q, k, v, do = (_randn(gen, b, r, h, d) for r in (n, m, m, n))
        lib = libs[entry]
        run = lambda: _attention_bwd(libs, entry, q, k, v, do, d ** -0.5)[0]  # noqa: E731
    else:
        if entry.startswith("skp_capture_bwd"):
            b, h, o, x, p, t, d = shape
            tt, ww, n = _randn(gen, b, h, o, x, d), resize_matrix(x, p, "bicubic", BF, "cpu"), o * p
        else:
            b, h, n, t, d = shape
            tt, ww = _randn(gen, b, h, n, d), None
        k, g = _randn(gen, b, t, h, d), torch.randn((b, n, t), generator=gen)
        lib = libs["attn_capture"]
        run = lambda: _capture_bwd(libs, entry, tt, k, g, d ** -0.5, ww)  # noqa: E731
    lib.emu_set_block_order.argtypes = [ctypes.c_int, ctypes.c_uint]
    runs = []
    try:
        for order in (0, 1, 2):  # z, y, x; reversed; a permutation from seed 1
            lib.emu_set_block_order(order, 1)
            runs.append(run())
    finally:
        lib.emu_set_block_order(0, 0)
    for got in runs:
        assert all(torch.isfinite(x.float()).all() for x in got)
    for other in runs[1:]:
        for x, y in zip(runs[0], other):
            assert torch.equal(x, y), f"{entry} {shape}: a gradient depends on the block order"


@pytest.mark.parametrize("b,h,o,x,p,t,d", [
    (1, 2, 2, 16, 128, 100, 160),  # up_1's shape class: 16 -> 128, d 160
    (1, 2, 1, 32, 128, 70, 80),    # up_2's: 32 -> 128, d 80
    (2, 1, 2, 16, 40, 30, 80),     # a ragged row of 40 columns, keys in one tile
    (1, 1, 3, 16, 40, 130, 80),    # 130 tokens: 3 key tiles (the statistics ring wraps),
                                   # 3 key blocks into one dq, a ragged tile per row
    (1, 2, 2, 32, 96, 77, 160),    # 96 columns: a full and a ragged tile per row, 77 tokens
    # d 64: CB = 1 (q, k tiles exactly one swizzle block), H 20
    (1, 20, 1, 24, 64, 77, 64),    # SD-2.1's up_1: 20 heads, X 24 (a ragged second x-step)
    (1, 20, 1, 32, 128, 130, 64),  # SDXL's up_0: 20 heads, X 32, 3 key tiles and blocks
    (2, 2, 2, 24, 40, 500, 64),    # two images, ragged 40-column rows, 500 tokens
    # the d-64 rows pass (warpgroup w the heads w, w + 2, ...) and keys pass
    # (test_capture_backward_splits: Z blocks a (b, h), dk partials summed in order)
    (1, 3, 4, 24, 128, 77, 64),    # 3 heads (the second warpgroup one), 8 tiles of two per
                                   # row (dt partials summed), Z 2 dividing the tiles
    (1, 1, 5, 32, 64, 100, 64),    # one head (the second warpgroup idle), 5 tiles of one
                                   # row each (bf16 dt directly), Z 2 not dividing them
    (1, 5, 2, 24, 96, 300, 64),    # 5 heads, 96-column rows (a 32-row second tile), two key
                                   # blocks of 256 (the second 44 keys: three warpgroups masked)
    # the same passes at d 80 and 160 (64-key ring tiles, split 64 + 16 /
    # 128 + 32 columns; at d 160 two keys-pass warpgroups and dt staged 16
    # columns at a time)
    (1, 3, 2, 16, 128, 500, 160),  # SD-1.5's up_1 class at 500 tokens: 3 heads (the second
                                   # warpgroup one), dt partials, four key blocks of 128
    (1, 1, 3, 32, 100, 77, 160),   # X 32 at d 160, one head (the second warpgroup idle),
                                   # 100-column rows (a 36-row second tile)
    (1, 3, 2, 32, 128, 500, 80),   # up_2's class at 500 tokens, 3 heads, two key blocks of 256
    (1, 1, 5, 16, 64, 100, 160),   # 5 tiles of one row each over Z 2 keys-pass blocks
    (1, 1, 5, 32, 64, 130, 80),    # d 80, Z 2, 130 tokens (the last of 3 key tiles ragged)
    # d 160 past 448 tokens with X > 16 (SD-1.5's up_1 at 768^2 / 1024^2):
    # no tt buffers beside the g rows, tt's fragments read from device memory
    (1, 3, 2, 24, 128, 500, 160),  # X 24 (a ragged second x-step), 3 heads, dt partials
    (1, 1, 2, 32, 100, 449, 160),  # X 32, the first token count past the buffers' room
    # more than two 64-column tiles an output row: dt partials of 4 and 8 tiles
    # summed in order
    (1, 2, 1, 24, 256, 1000, 64),  # P 256 (with a cluster of 2 in the rows pass)
    (1, 1, 1, 16, 512, 100, 80),   # P 512: 8 tiles a row
    (1, 1, 2, 24, 256, 300, 160),  # P 256 at d 160, X 24 (tt from device memory past 448 tokens
                                   # is not reached: 300 tokens), two output rows
    # past 512 tokens: the rows pass over a cluster of ceil(T / 512) blocks, each
    # holding the g rows of its keys; the row statistics and then the partial dq
    # combined across the cluster in rank order (block r summing dq's 8-column
    # chunks r, r + ncl, ... into its dt columns)
    (1, 2, 1, 16, 128, 600, 160),  # 300 + 300 keys, dt partials of two tiles
    (1, 3, 1, 32, 64, 1000, 80),   # 3 heads (the second warpgroup one), bf16 dt directly
    (1, 1, 2, 16, 256, 513, 80),   # 258 + 255 keys: 5 and 4 key tiles (the blocks' sweeps differ
                                   # in length), P 256
    (1, 2, 1, 24, 128, 1000, 160),  # X 24 at 500 keys a block: tt from device memory
    (1, 1, 1, 32, 100, 2100, 160),  # a cluster of 5 (420 keys each: dq's 20 chunks 4 a block)
])
def test_capture_backward_kernel_matches_plain(libs, b, h, o, x, p, t, d):
    gen = torch.Generator().manual_seed(x * p + d + 1)
    tt, k = _randn(gen, b, h, o, x, d), _randn(gen, b, t, h, d)
    ww = resize_matrix(x, p, "bicubic", BF, "cpu")
    g = torch.randn((b, o * p, t), generator=gen)
    scale = d ** -0.5
    _assert_grads_close(_capture_bwd(libs, "skp_capture_bwd", tt, k, g, scale, ww),
                        attn_capture.capture_fused_bwd_plain(tt, ww, k, g, scale))


def test_capture_backward_splits(libs):
    """The keys pass splits a (b, h)'s query tiles over Z blocks only where
    the grid of ceil(T / KB) x H x B blocks (KB keys a block: 256, at d 160
    128) leaves "SMs" (2 here) idle, as far as the scratch holds the fp32
    partials."""
    fn = libs["attn_capture"].skp_capture_bwd_splits
    fn.argtypes = [ctypes.c_int] * 8
    fn.restype = ctypes.c_int
    assert fn(1, 3, 4, 24, 128, 77, 64, 0) == 2    # 3 blocks, 8 tiles
    assert fn(1, 1, 5, 32, 64, 100, 64, 0) == 2    # 1 block, 5 tiles: 3 and 2
    assert fn(1, 1, 1, 0, 320, 100, 64, 1) == 2    # K2: 5 tiles
    assert fn(1, 20, 1, 24, 64, 77, 64, 0) == 1    # 20 blocks fill the 2 "SMs" ten times
    assert fn(1, 1, 1, 32, 64, 500, 64, 0) == 1    # one tile: nothing to split
    assert fn(1, 1, 5, 16, 64, 100, 160, 0) == 2   # d 160: 1 block, 5 tiles
    assert fn(1, 3, 4, 24, 128, 77, 160, 0) == 2   # 3 blocks, 8 tiles
    assert fn(1, 1, 5, 32, 64, 130, 80, 0) == 2    # d 80: 1 block (256 keys), 5 tiles
    assert fn(1, 1, 1, 0, 320, 100, 80, 1) == 2    # K2 at d 80
    assert fn(1, 20, 1, 24, 64, 77, 80, 0) == 1    # 20 blocks
    assert fn(1, 8, 1, 16, 64, 500, 160, 0) == 1   # 4 key blocks x 8 heads
    assert fn(1, 3, 4, 24, 128, 77, 40, 0) == -1   # no capture kernel at d 40
    # past 512 tokens: 8 key blocks (d 160, 1000 tokens) and 16 (d 64, 4096)
    # fill the 2 "SMs" four and eight times over: no split
    assert fn(1, 1, 2, 16, 128, 1000, 160, 0) == 1
    assert fn(1, 1, 1, 0, 640, 4096, 64, 1) == 1
    assert fn(1, 1, 1, 32, 256, 1000, 80, 0) == 1  # 4 key blocks, 4 tiles: 2 waves either way


def _unrounded_capture_bwd(q, k, g, scale, precise):
    """The plain backward in float64 before its final roundings: (dq [B, H,
    N, D], dk [B, T, H, D]) from the queries as the kernels hold them (bf16),
    dsim rounded to bf16 unless `precise`."""
    h = q.shape[1]
    qf, kf = q.double(), k.double()
    p = torch.softmax(torch.einsum("bhnd,bthd->bhnt", qf, kf) * scale, dim=-1)
    t1 = g.double()[:, None] * (1.0 / h) * p
    dsim = (t1 - p * t1.sum(-1, keepdim=True)) * scale
    if not precise:
        dsim = dsim.to(BF).double()
    return (torch.einsum("bhnt,bthd->bhnd", dsim, kf),
            torch.einsum("bhnt,bhnd->bthd", dsim, qf))


def _mean_err(got, want):
    return ((got.double() - want).abs().mean() / want.abs().mean()).item()


# capture_fp32_bwd: the precise backward (dsim as bf16 hi + lo through both
# products) against the plain version with precise=True, within 2^-7 of each
# gradient's largest magnitude: one bf16 ulp at the top binade, as the final
# roundings to bf16 (and K1's bf16(dq) inside dt) of values that differ in
# their last fp32 bits can fall on either side. And measured against the
# plain arithmetic before its final roundings (float64), its mean error is
# below the default kernel's, whose bf16 dsim adds its own.
@pytest.mark.parametrize("b,h,o,x,p,t,d", [
    (2, 1, 2, 16, 40, 30, 80),    # ragged 40-column rows, keys in one tile
    (1, 2, 1, 32, 128, 70, 80),   # up_2's shape class: 32 -> 128, d 80
    (1, 20, 1, 24, 64, 77, 64),   # SD-2.1's up_1: 20 heads, X 24, d 64
    (2, 2, 2, 24, 40, 500, 64),   # 500 tokens: the two sweeps over every 16-key step
    (1, 3, 4, 24, 128, 77, 64),   # the d-64 keys pass split (Z 2), dt partials summed
    (1, 3, 2, 16, 128, 130, 160), # d 160: 3 heads, dt partials, 3 key tiles
    (1, 2, 2, 24, 128, 500, 160), # d 160, X 24 at 500 tokens: tt from device memory
    (1, 1, 5, 32, 64, 77, 80),    # d 80: Z 2, one head
    (1, 2, 1, 16, 128, 1000, 160),  # past 512 tokens: a cluster of 2 in the rows pass
    (1, 1, 1, 24, 256, 100, 64),  # P 256: dt partials of four tiles
])
def test_precise_capture_backward_kernel_matches_plain(libs, b, h, o, x, p, t, d):
    gen = torch.Generator().manual_seed(x * p + d + 2)
    tt, k = _randn(gen, b, h, o, x, d), _randn(gen, b, t, h, d)
    ww = resize_matrix(x, p, "bicubic", BF, "cpu")
    g = torch.randn((b, o * p, t), generator=gen)
    scale = d ** -0.5
    n = o * p
    gk, ldg = attn_capture.g_rows(g)
    out = {}
    for entry in ("skp_capture_bwd_precise", "skp_capture_bwd"):
        dt, dk = torch.full_like(tt, float("nan")), torch.full_like(k, float("nan"))
        q = torch.full((b, h, n, d), float("nan")).to(BF)
        lse, c = torch.full((b, h, n), float("nan")), torch.full((b, h, n), float("nan"))
        dq_acc = torch.full((b, h, n, d), float("nan"))
        fn = getattr(libs["attn_capture"], entry)
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + CAPTURE_TAIL
        fn.restype = ctypes.c_int
        assert fn(*map(_ptr, (tt, ww, k, gk, q, lse, c, dq_acc, dt, dk)), b, h, o, x, p, t, ldg,
                  d, scale, None, h) == 0
        out[entry] = (dt, dk)
    dt, dk = out["skp_capture_bwd_precise"]
    want = attn_capture.capture_fused_bwd_plain(tt, ww, k, g, scale, precise=True)
    for got, w in zip((dt, dk), want):
        assert torch.isfinite(got.float()).all()
        torch.testing.assert_close(got.float(), w.float(), rtol=0,
                                   atol=2.0**-7 * w.float().abs().max().item())
    q_up = torch.einsum("Px,bkOxd->bkOPd", ww.float(), tt.float()).to(BF).reshape(b, h, n, d)
    dk_ref = _unrounded_capture_bwd(q_up, k, g, scale, precise=True)[1]
    assert _mean_err(dk, dk_ref) < _mean_err(out["skp_capture_bwd"][1], dk_ref)


@pytest.mark.parametrize("b,h,n,t,d", [
    (1, 2, 200, 70, 80),    # a ragged last query tile (8 rows)
    (1, 20, 100, 77, 64),   # d 64, 20 heads, a 36-row last tile
    (1, 1, 320, 100, 64),   # d 64: 5 tiles split over Z 2 blocks (3 and 2)
    (1, 3, 150, 500, 160),  # d 160: 3 heads, a 22-row last tile, 500 tokens
    (1, 1, 320, 100, 80),   # d 80: Z 2
    (1, 2, 100, 600, 80),   # past 512 tokens: a cluster of 2 in the rows pass
])
def test_precise_unfused_capture_backward_kernel_matches_plain(libs, b, h, n, t, d):
    gen = torch.Generator().manual_seed(n * t + d + 2)
    q, k = _randn(gen, b, h, n, d), _randn(gen, b, t, h, d)
    g = torch.randn((b, n, t), generator=gen)
    scale = d ** -0.5
    gk, ldg = attn_capture.g_rows(g)
    out = {}
    for entry in ("skp_capture_q_bwd_precise", "skp_capture_q_bwd"):
        dq, dk = torch.full_like(q, float("nan")), torch.full_like(k, float("nan"))
        lse, c = torch.full((b, h, n), float("nan")), torch.full((b, h, n), float("nan"))
        dq_acc = torch.full((b, h, n, d), float("nan"))
        fn = getattr(libs["attn_capture"], entry)
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + CAPTURE_TAIL
        fn.restype = ctypes.c_int
        assert fn(*map(_ptr, (q, k, gk, lse, c, dq_acc, dq, dk)), b, h, n, t, ldg, d, scale,
                  None, h) == 0
        out[entry] = (dq, dk)
    want = attn_capture.capture_bwd_plain(q, k, g, scale, precise=True)
    for got, w in zip(out["skp_capture_q_bwd_precise"], want):
        assert torch.isfinite(got.float()).all()
        torch.testing.assert_close(got.float(), w.float(), rtol=0,
                                   atol=2.0**-7 * w.float().abs().max().item())
    ref = _unrounded_capture_bwd(q, k, g, scale, precise=True)
    for got, base, r in zip(out["skp_capture_q_bwd_precise"], out["skp_capture_q_bwd"], ref):
        assert _mean_err(got, r) < _mean_err(base, r)


def test_capture_kernels_refuse_past_their_limits(libs):
    """Up to 4096 tokens (clusters of up to 8 blocks of 512) and 512 output
    columns in K1's backward; one more of either is refused (-1) before any
    pointer is read."""
    lib = libs["attn_capture"]
    fwd, qfwd, bwd = lib.skp_capture_fwd, lib.skp_capture_q_fwd, lib.skp_capture_bwd
    fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + CAPTURE_TAIL
    qfwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + CAPTURE_TAIL
    bwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + CAPTURE_TAIL
    for fn in (fwd, qfwd, bwd):
        fn.restype = ctypes.c_int
    assert fwd(*([None] * 4), 1, 1, 1, 16, 40, 4097, 160, 1.0, None, 1) == -1
    assert qfwd(*([None] * 3), 1, 1, 64, 4097, 80, 1.0, None, 1) == -1
    assert bwd(*([None] * 10), 1, 1, 1, 16, 64, 4097, 4100, 160, 1.0, None, 1) == -1
    assert bwd(*([None] * 10), 1, 1, 1, 16, 513, 500, 500, 160, 1.0, None, 1) == -1


def test_capture_backward_refuses_unaligned_g_rows(libs):
    fn = libs["attn_capture"].skp_capture_q_bwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + CAPTURE_TAIL
    fn.restype = ctypes.c_int
    assert fn(*([None] * 8), 1, 1, 64, 30, 30, 80, 1.0, None, 1) == -1  # g rows 30 floats apart


def _gn_conv_inputs(gen, b, h, w, cin, cout):
    x = (torch.randn((b, h, w, cin), generator=gen) * 1.5 + 0.3).to(BF)
    m, a, bb = gn_affine_coeffs_plain(x, torch.randn(cin, generator=gen) * 0.2 + 1.0,
                                      torch.randn(cin, generator=gen) * 0.2, 32, 1e-6)
    kernel = (torch.randn((3, 3, cin, cout), generator=gen) * 0.05).to(BF)
    bias = (torch.randn(cout, generator=gen) * 0.1).to(BF)
    res = torch.randn((b, h, w, cout), generator=gen).to(BF)
    return x, m, a, bb, kernel, bias, res


@pytest.mark.parametrize("b,h,w,cin,cout,with_res", [
    (1, 16, 16, 128, 128, False),  # one 16 x 16 tile: the pad ring on all four sides
    (1, 16, 16, 128, 128, True),
    (1, 12, 40, 128, 256, True),   # W not a multiple of the 32-column span; 2 channel tiles
    (1, 10, 64, 128, 128, False),  # 4-row tiles of 64 columns: halos between row tiles
    (1, 9, 72, 128, 128, True),    # 32-column tiles (W not a multiple of 64), ragged last row
                                   # and column
    (1, 8, 64, 128, 512, True),    # 4 output-channel tiles: 8 tiles over the 2 "SMs", the weight
                                   # ring and the next tile's patch carried across tiles
    (2, 8, 16, 256, 128, False),   # 16-column tiles (A by ldmatrix), 4 chunks, two images
    (1, 8, 64, 256, 128, True),    # the VAE decoder's 256 -> 128 conv1 class with a residual
                                   # of the output width (as conv_shortcut gives conv2)
    (1, 8, 64, 512, 256, False),   # the decoder's 512 -> 256 conv1 class: 8 input chunks
    # 256-channel tiles (gn_conv_kernel): the weight ring refilled by the second product
    # warpgroup to release a stage, taps in flight across chunk ends, the patch written from
    # registers into two buffers, the epilogue through a staging tile (stmatrix, TMA stores
    # drained while the next tile runs, the residual brought in by TMA in the tile's last
    # chunk); 128-channel tiles run the previous design (gn_conv128_kernel)
    (1, 8, 96, 128, 128, True),    # W 96 at 128 channels: three 32-column tiles a row
    (1, 8, 128, 128, 512, True),   # Cout 512 in 64-column rows: 16 tiles over the 2 "SMs"
    (2, 8, 64, 128, 256, True),    # two images, two channel tiles, 4 tiles a block
    (1, 12, 96, 256, 256, False),  # W 96: 8 x 8 blocks, 16-column tiles of 8 rows, 4 chunks
    (2, 8, 64, 64, 256, True),     # one input chunk a tile: the staging turned around 3 taps
                                   # into a 9-tap walk, 4 tiles a block, each tile's residual
                                   # loaded while the previous tile's stores may still read
    (3, 8, 64, 128, 256, False),   # rows of 64, 6 tiles a block: each tile's stores in flight
                                   # while the next tile's taps run, no residual
    (1, 12, 24, 128, 256, True),   # 8 x 8 blocks: the staged store and the residual load
                                   # clipped at both ragged edges, the second column tile's
                                   # right half wholly outside
    (1, 9, 72, 128, 256, True),    # 8 x 8 blocks, 16-column tiles: the last row band ragged
                                   # (rows 8 of 8-15), the last column tile half outside
])
def test_gn_conv_kernel_matches_plain(libs, b, h, w, cin, cout, with_res):
    gen = torch.Generator().manual_seed(h * w + cout)
    x, m, a, bb, kernel, bias, res = _gn_conv_inputs(gen, b, h, w, cin, cout)
    res = res if with_res else None
    out = torch.full((b, h, w, cout), float("nan")).to(BF)
    fn = libs["gn_conv"].skp_gn_conv
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    w_ohwi = kernel.permute(3, 0, 1, 2).contiguous()
    assert fn(*map(_ptr, (x, m, a, bb, w_ohwi, bias)), None if res is None else _ptr(res),
              _ptr(out), b, h, w, cin, cout, None) == 0
    want = gn_conv.fused_gn_silu_conv3x3_plain(x, m, a, bb, kernel, bias, res).float()
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), want, rtol=0, atol=2.0**-6 * want.abs().max().item())


def test_gn_conv_refuses_unaligned_channels(libs):
    fn = libs["gn_conv"].skp_gn_conv
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    assert fn(*([None] * 8), 1, 16, 16, 96, 128, None) == -1


@pytest.mark.parametrize("b,h,n,t,d", [
    (1, 2, 200, 70, 80),    # N not a multiple of the 128-query block
    (2, 1, 144, 100, 160),  # a 12^2 grid, d 160, two key tiles
    (1, 2, 130, 500, 160),  # 500 tokens, a 2-row last tile
    (1, 1, 70, 257, 80),    # one key past 256: the second warpgroup's first key alone
    (1, 20, 144, 77, 64),   # d 64, 20 heads, a 16-row last block, 77 tokens
    (2, 2, 200, 500, 64),   # d 64, 500 tokens, two images
    (1, 3, 100, 257, 64),   # d 64, 3 heads, 257 tokens: the second warpgroup's one key
    # past 512 tokens: clusters of 2, 5 and 2 blocks
    (1, 2, 100, 1000, 80),
    (1, 1, 70, 2100, 64),
    (2, 2, 130, 600, 160),  # two images, a 2-row last block
])
def test_unfused_capture_kernel_matches_plain(libs, b, h, n, t, d):
    gen = torch.Generator().manual_seed(n * t + d)
    q, k = _randn(gen, b, h, n, d), _randn(gen, b, t, h, d)
    out = torch.full((b, n, t), float("nan"))
    scale = d ** -0.5
    fn = libs["attn_capture"].skp_capture_q_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + CAPTURE_TAIL
    fn.restype = ctypes.c_int
    assert fn(_ptr(q), _ptr(k), _ptr(out), b, h, n, t, d, scale, None, h) == 0
    torch.testing.assert_close(out, attn_capture.capture_plain(q, k, scale), rtol=0, atol=1e-4)


@pytest.mark.parametrize("b,h,n,t,d", [
    (1, 2, 200, 70, 80),    # a ragged last query tile (8 rows)
    (2, 1, 144, 100, 160),
    (1, 2, 150, 130, 80),   # 130 tokens: 3 key tiles and blocks; a 22-row last tile
    (1, 1, 100, 77, 160),   # a 36-row last tile, 77 tokens, d 160
    (1, 20, 100, 77, 64),   # d 64, 20 heads, a 36-row last tile
    (1, 2, 150, 500, 64),   # d 64, 500 tokens: 4 key blocks, a 22-row last tile
    (1, 3, 288, 500, 64),   # d 64: 3 heads (a ragged pair), 4.5 tiles (a 32-row last one)
    (1, 1, 320, 100, 64),   # d 64: 5 tiles split over Z 2 blocks (3 and 2)
    # past 512 tokens: the rows pass over clusters of 2, 2, 2 and 8 blocks
    (1, 2, 100, 600, 160),
    (1, 3, 150, 1000, 64),  # 3 heads, a 22-row last tile
    (1, 2, 70, 513, 64),    # 258 + 255 keys: 3 and 2 key tiles
    (1, 1, 64, 4096, 64),   # a cluster of 8: one chunk of dq a block
])
def test_unfused_capture_backward_kernel_matches_plain(libs, b, h, n, t, d):
    gen = torch.Generator().manual_seed(n * t + d + 1)
    q, k = _randn(gen, b, h, n, d), _randn(gen, b, t, h, d)
    g = torch.randn((b, n, t), generator=gen)
    scale = d ** -0.5
    _assert_grads_close(_capture_bwd(libs, "skp_capture_q_bwd", q, k, g, scale),
                        attn_capture.capture_bwd_plain(q, k, g, scale))


# total_heads != H: a tensor-parallel rank's share of the heads (H of
# total_heads), whose partial head-mean the model ranks' all-reduce completes
@pytest.mark.parametrize("entry,b,h,total,n_or_x,t,d", [
    ("skp_capture_fwd", 1, 4, 8, 16, 500, 160),     # SD-1.5's up_1 at 2 ranks, X 16
    ("skp_capture_fwd", 1, 10, 20, 32, 77, 64),     # SDXL's up_0 at 2 ranks, X 32
    ("skp_capture_bwd", 1, 4, 8, 16, 130, 160),
    ("skp_capture_bwd", 1, 10, 20, 24, 77, 64),
    ("skp_capture_q_fwd", 1, 2, 8, 144, 500, 80),   # 2 of 8 heads (4 ranks)
    ("skp_capture_q_bwd", 1, 4, 8, 100, 77, 160),
    ("skp_capture_q_bwd", 1, 3, 5, 150, 70, 64),    # a total the local count does not divide
    ("skp_capture_bwd", 1, 3, 8, 32, 500, 80),      # up_2 at 3 of 8 heads, 500 tokens
    ("skp_capture_bwd", 1, 3, 8, 24, 500, 160),     # up_1 at 768^2 (X 24) at 3 of 8 heads
    ("skp_capture_q_bwd", 1, 3, 8, 130, 130, 160),  # 3 of 8 heads at d 160, a 2-row last tile
])
def test_capture_kernels_partial_head_mean(libs, entry, b, h, total, n_or_x, t, d):
    gen = torch.Generator().manual_seed(h * total + n_or_x + d)
    k = _randn(gen, b, t, h, d)
    scale = d ** -0.5
    fused = "_q_" not in entry
    if fused:  # K1: tt [b, h, 1, X, D] -> 40 output columns of one row
        x, o, p = n_or_x, 1, 40
        tt, ww = _randn(gen, b, h, o, x, d), resize_matrix(n_or_x, 40, "bicubic", BF, "cpu")
        n = o * p
        ints = [b, h, o, x, p, t]
    else:
        n = n_or_x
        q = _randn(gen, b, h, n, d)
        ints = [b, h, n, t]
    fn = getattr(libs["attn_capture"], entry)
    fn.restype = ctypes.c_int
    if entry.endswith("_fwd"):
        out = torch.full((b, n, t), float("nan"))
        ptrs = (tt, ww, k, out) if fused else (q, k, out)
        fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * (len(ints) + 1) + CAPTURE_TAIL
        assert fn(*map(_ptr, ptrs), *ints, d, scale, None, h - 1) == -1  # fewer than given
        assert fn(*map(_ptr, ptrs), *ints, d, scale, None, total) == 0
        want = (attn_capture.capture_fused_plain(tt, ww, k, scale, total) if fused
                else attn_capture.capture_plain(q, k, scale, total))
        torch.testing.assert_close(out, want, rtol=0, atol=1e-4)
        full = (attn_capture.capture_fused_plain(tt, ww, k, scale) if fused
                else attn_capture.capture_plain(q, k, scale))
        torch.testing.assert_close(out * total / h, full, rtol=0, atol=1e-4 * total / h)
        return
    g = torch.randn((b, n, t), generator=gen)
    gk, ldg = attn_capture.g_rows(g)
    lse, c = torch.full((b, h, n), float("nan")), torch.full((b, h, n), float("nan"))
    dq_acc = torch.full((b, h, n, d), float("nan"))
    dk = torch.full_like(k, float("nan"))
    if fused:
        dx = torch.full_like(tt, float("nan"))
        qs = torch.full((b, h, n, d), float("nan")).to(BF)
        ptrs = (tt, ww, k, gk, qs, lse, c, dq_acc, dx, dk)
    else:
        dx = torch.full_like(q, float("nan"))
        ptrs = (q, k, gk, lse, c, dq_acc, dx, dk)
    fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * (len(ints) + 2) + CAPTURE_TAIL
    assert fn(*map(_ptr, ptrs), *ints, ldg, d, scale, None, h - 1) == -1
    assert fn(*map(_ptr, ptrs), *ints, ldg, d, scale, None, total) == 0
    want = (attn_capture.capture_fused_bwd_plain(tt, ww, k, g, scale, total_heads=total) if fused
            else attn_capture.capture_bwd_plain(q, k, g, scale, total_heads=total))
    _assert_grads_close((dx, dk), want)
    # the cotangent read as g / total: the same as g * h / total through H's mean
    g_h = g * (h / total)
    full = (attn_capture.capture_fused_bwd_plain(tt, ww, k, g_h, scale) if fused
            else attn_capture.capture_bwd_plain(q, k, g_h, scale))
    _assert_grads_close((dx, dk), full)


@pytest.mark.parametrize("dtype,b,hw,c,chunks,inputs", [
    (BF, 2, 64, 128, 3, "randn"),        # 3 chunks a batch element: the last-block merge
    (BF, 1, 40, 256, 4, "mean 30"),      # mean 30 / std 0.5: the shifted sums must not cancel
    (BF, 1, 24, 512, 3, "means +-100"),  # per-channel means in [-100, 100)
    (BF, 1, 8, 512, 5, "randn"),         # 5 chunks asked of 8 rows: 4 of 2 rows, each under
                                         # the 4 rows a block's iteration covers
    (BF, 1, 160, 128, 20, "randn"),      # 20 chunks: groups of 8, 8 and 4 merged, then the groups
    (torch.float16, 1, 32, 256, 2, "mean 30"),
    (torch.float32, 2, 48, 128, 3, "means +-100"),  # 4 channels a thread, 2 batch elements
    # the chunk count the wrapper gives the VAE decoder's [1, 512, 512, 256] input (4 blocks
    # an SM on 132 SMs), on 8-row chunks: 66 groups of 8 merged at the second ticket level
    (BF, 1, 528 * 8, 256, 528, "randn"),
])
def test_gn_coeffs_kernel_matches_plain(libs, dtype, b, hw, c, chunks, inputs):
    gen = torch.Generator().manual_seed(hw * c + chunks)
    mean = {"randn": torch.full((c,), 0.3), "mean 30": torch.full((c,), 30.0),
            "means +-100": torch.rand(c, generator=gen) * 200 - 100}[inputs]
    std = 1.5 if inputs == "randn" else 0.5
    x = (torch.randn((b, hw, c), generator=gen) * std + mean).to(dtype)
    scale = (torch.randn(c, generator=gen) * 0.2 + 1.0).to(BF if dtype == BF else torch.float32)
    bias = (torch.randn(c, generator=gen) * 0.2).to(scale.dtype)
    part = torch.full((b, chunks, 2, c), float("nan"))
    counter = torch.zeros(128 * b, dtype=torch.int32)
    fn = libs["groupnorm"].skp_gn_coeffs
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    runs = []
    for _ in range(2):  # the counters are left at 0, and a second launch is bitwise equal
        outs = [torch.full((b, c), float("nan")) for _ in range(3)]
        assert fn(*map(_ptr, (x, scale, bias, part, counter, *outs)), _DTYPE_CODES[dtype],
                  _DTYPE_CODES[scale.dtype], b, hw, c, 32, chunks, 1e-6, None) == 0
        assert not counter.any()
        runs.append(outs)
    assert all(torch.equal(g, h) for g, h in zip(*runs))
    want = gn_affine_coeffs_plain(x, scale, bias, 32, 1e-6)
    for g, w in zip(runs[0], want):  # as chip_smoke.py: 2^-7 of each output's largest magnitude
        torch.testing.assert_close(g, w, rtol=0, atol=2.0**-7 * w.abs().max().item())
    torch.testing.assert_close(runs[0][1], want[1], rtol=2e-5, atol=0)  # the scale a


def test_gn_coeffs_refuses_unsupported_shapes(libs):
    fn = libs["groupnorm"].skp_gn_coeffs
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    args = [None] * 8
    assert fn(*args, 1, 1, 1, 16, 4100, 32, 1, 1e-6, None) == -1  # C not whole 16-byte vectors
    assert fn(*args, 1, 1, 1, 16, 4096, 32, 1, 1e-6, None) == -1  # 512 vectors a row
    assert fn(*args, 1, 1, 1, 16, 144, 32, 1, 1e-6, None) == -1   # C % groups
    assert fn(*args, 3, 1, 1, 16, 128, 32, 1, 1e-6, None) == -1   # no such dtype
