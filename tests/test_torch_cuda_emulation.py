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
barriers, ex2.approx, the bulk reduce-add) are swapped for emulations that
follow the PTX ISA's layouts (`cuda_emu/emu_ops.h`; asynchronous operations
complete at once; TMA boxes and wgmma descriptors in the no-swizzle and the
128-byte swizzle layouts). Unwritten shared memory reads as NaN, a shared-memory
request above the sm_90 limit fails the launch, and a misaligned cp.async,
ldmatrix, descriptor or TMA address aborts. What only the card can say
(the real compiler, timing, a missing wait, races between warps that the
barriers here hide) stays with `chip_smoke.py`.

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
PTX_HELPERS = ("mma_bf16", "load_b", "ldsm_x4", "cp_async16", "cp_async_commit",
               "cp_async_wait_all", "cp_async_wait_1", "cp_async_wait", "cp_async4", "wgmma_m64n128k16", "wgmma_m64n128k16_ss",
               "wgmma_m64n40k16_tb", "wgmma_m64n64k16_tb", "wgmma_m64n80k16_tb",
               "wgmma_m64n256k16_ss", "wgmma_m64n64k16_ss", "wgmma_m64n40k16_ss_tt", "wgmma_m64n64k16_ss_tt",
               "wgmma_m64n80k16_ss_tt",
               "wgmma_m64n160k16_tb", "wgmma_m64n160k16_ss_tt", "wgmma_m64n32k16_ss",
               "wgmma_m64n256k16_ss_tb", "named_bar_sync", "setmaxnreg_inc", "setmaxnreg_dec",
               "reg_fence", "frag_fence", "wgmma_fence", "wgmma_commit",
               "wgmma_wait0", "wgmma_wait1", "fence_proxy_async", "fast_exp2",
               "bulk_reduce_add_f32", "bulk_commit", "bulk_wait_read0", "bulk_wait0", "smem_u32",
               "mbar_init", "mbar_fence_init", "mbar_expect_tx", "mbar_arrive", "mbar_wait",
               "tma_load_4d",
               "tma_load_2d")
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


def _emulated_sources(out_dir: str) -> None:
    with open(os.path.join(CSRC, "common.cuh")) as f:
        common = f.read()
    for name in PTX_HELPERS:
        common = _drop_function(common, name)
    anchor = "typedef __nv_bfloat16 bf16;"
    assert anchor in common
    common = common.replace(anchor, anchor + '\n#include "emu_ops.h"')
    with open(os.path.join(out_dir, "common.cuh"), "w") as f:
        f.write(common)
    files = [(f"{name}.cu", f"{name}.cpp") for name in SOURCES]
    files += [(fn, fn) for fn in sorted(os.listdir(CSRC))
              if fn.endswith(".cuh") and fn != "common.cuh"]
    launches = 0
    for src_name, out_name in files:
        with open(os.path.join(CSRC, src_name)) as f:
            src = f.read()
        src, n = re.subn(r"(\w+(?:<[\w, ]+>)?)<<<(.*?)>>>\((.*?)\);",
                         r"emu_launch(\2, [&] { \1(\3); });", src, flags=re.S)
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
    ("flash", 1, 128, 128, 2, 40),   # K4 backward, d padded to 48; 2 key blocks add into dq
    ("flash", 1, 80, 100, 1, 80),    # K5: kv tail masked, ragged query tile
    ("flash", 1, 150, 200, 1, 40),   # 4 key blocks into one dq, 3 query tiles, an 8-key tail
    ("flash", 1, 96, 77, 1, 80),     # a 77-token kv tail at d 80
    ("cross_attn", 1, 200, 100, 2, 40),  # K3: row statistics recomputed
    ("cross_attn", 1, 128, 77, 1, 80),
    ("cross_attn", 1, 130, 100, 1, 80),  # statistics over two blocks, the second ragged
    # d 64: the m64n64k16 products with b MN-major (dv, dk) and both MN-major (dq)
    ("flash", 1, 150, 200, 2, 64),   # K4: 4 key blocks into one dq, a ragged query tile
    ("flash", 1, 96, 500, 1, 64),    # K5 at 500 tokens: 8 key blocks, a 52-key tail
    ("flash", 1, 64, 77, 2, 64),     # K5 at 77 tokens
    ("cross_attn", 1, 130, 500, 1, 64),  # K3: statistics over 8 key tiles, a ragged query tile
    ("cross_attn", 1, 64, 77, 2, 64),
])
def test_attention_backward_kernel_matches_plain(libs, source, b, n, m, h, d):
    gen = torch.Generator().manual_seed(n * m + d + 1)
    q, k, v = _randn(gen, b, n, h, d), _randn(gen, b, m, h, d), _randn(gen, b, m, h, d)
    do = _randn(gen, b, n, h, d)
    scale = d ** -0.5
    dq, dk, dv = (torch.full_like(x, float("nan")) for x in (q, k, v))
    lse = torch.full((b, h, n), float("nan"))
    di = torch.full((b, h, n), float("nan"))
    dq_acc = torch.full((b, h, n, d), float("nan"))  # the kernels zero it before adding
    if source == "flash":
        out = torch.full_like(q, float("nan"))
        assert _flash_fwd(libs, q, k, v, out, lse, scale) == 0
        fn = libs["flash"].skp_flash_bwd
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        assert fn(*map(_ptr, (q, k, v, out, do, lse, di, dq_acc, dq, dk, dv)), b, n, m, h, d,
                  scale, None) == 0
        want = flash.attention_bwd_plain(q, k, v, out, do, scale)
    else:
        fn = libs["cross_attn"].skp_cross_bwd
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        assert fn(*map(_ptr, (q, k, v, do, lse, di, dq_acc, dq, dk, dv)), b, n, m, h, d, scale,
                  None) == 0
        want = cross_attn.cross_attention_bwd_plain(q, k, v, do, scale)
    _assert_grads_close((dq, dk, dv), want)


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
])
def test_capture_backward_kernel_matches_plain(libs, b, h, o, x, p, t, d):
    gen = torch.Generator().manual_seed(x * p + d + 1)
    tt, k = _randn(gen, b, h, o, x, d), _randn(gen, b, t, h, d)
    ww = resize_matrix(x, p, "bicubic", BF, "cpu")
    g = torch.randn((b, o * p, t), generator=gen)
    scale = d ** -0.5
    dt, dk = torch.full_like(tt, float("nan")), torch.full_like(k, float("nan"))
    n = o * p
    q = torch.full((b, h, n, d), float("nan")).to(BF)  # scratch: the upsampled queries
    lse, c = torch.full((b, h, n), float("nan")), torch.full((b, h, n), float("nan"))
    dq_acc = torch.full((b, h, n, d), float("nan"))  # the statistics pass zeroes it
    gk, ldg = attn_capture.g_rows(g)
    fn = libs["attn_capture"].skp_capture_bwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + CAPTURE_TAIL
    fn.restype = ctypes.c_int
    assert fn(*map(_ptr, (tt, ww, k, gk, q, lse, c, dq_acc, dt, dk)), b, h, o, x, p, t, ldg, d,
              scale, None, h) == 0
    _assert_grads_close((dt, dk), attn_capture.capture_fused_bwd_plain(tt, ww, k, g, scale))


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
    (1, 9, 72, 128, 128, True),    # 64-column tiles (A read by wgmma), ragged last row and column
    (1, 8, 64, 128, 512, True),    # 4 output-channel tiles: 8 tiles over the 2 "SMs", the weight
                                   # ring and the next tile's patch carried across tiles
    (2, 8, 16, 256, 128, False),   # 16-column tiles (A by ldmatrix), 4 chunks, two images
    (1, 8, 64, 256, 128, True),    # the VAE decoder's 256 -> 128 conv1 class with a residual
                                   # of the output width (as conv_shortcut gives conv2)
    (1, 8, 64, 512, 256, False),   # the decoder's 512 -> 256 conv1 class: 8 input chunks
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
])
def test_unfused_capture_backward_kernel_matches_plain(libs, b, h, n, t, d):
    gen = torch.Generator().manual_seed(n * t + d + 1)
    q, k = _randn(gen, b, h, n, d), _randn(gen, b, t, h, d)
    g = torch.randn((b, n, t), generator=gen)
    scale = d ** -0.5
    dq, dk = torch.full_like(q, float("nan")), torch.full_like(k, float("nan"))
    lse, c = torch.full((b, h, n), float("nan")), torch.full((b, h, n), float("nan"))
    dq_acc = torch.full((b, h, n, d), float("nan"))  # the statistics pass zeroes it
    gk, ldg = attn_capture.g_rows(g)
    fn = libs["attn_capture"].skp_capture_q_bwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + CAPTURE_TAIL
    fn.restype = ctypes.c_int
    assert fn(*map(_ptr, (q, k, gk, lse, c, dq_acc, dq, dk)), b, h, n, t, ldg, d, scale,
              None, h) == 0
    _assert_grads_close((dq, dk), attn_capture.capture_bwd_plain(q, k, g, scale))


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
