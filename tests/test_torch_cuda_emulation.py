"""The port's CUDA kernels, run on the CPU, against their plain versions.

There is no GPU and no nvcc on the test machines, so without this the
index math of `stablekeypoints_tpu_torch/kernels/csrc/*.cu` (fragment
layouts, tile offsets, masks, the cp.async double buffers, the cross-warp
exchanges) would be checked only on the card by `chip_smoke.py`. Here each
source is compiled by the host C++ compiler with `tests/cuda_emu/` in place
of the CUDA headers: every CUDA thread of a block is an OS thread,
`__syncthreads` and the warp collectives are barriers, and the inline-PTX
helpers of `common.cuh` (mma.sync m16n8k16 bf16, ldmatrix.x2.trans,
cp.async) are swapped for emulations that follow the PTX ISA's fragment
layouts (`cuda_emu/emu_ops.h`). Unwritten shared memory reads as NaN, a
shared-memory request above the sm_90 limit fails the launch, and a
misaligned cp.async or ldmatrix address aborts. What only the card can say
(the real compiler, timing, races between warps that the barriers here
hide) stays with `chip_smoke.py`.

Tolerances are those `chip_smoke.py` holds the kernels to on the card:
attention outputs within 2^-7 of their largest magnitude (2 bf16 ulps at
the top binade: the kernels sum in another order, and flash rounds
unnormalised p to bf16), capture maps within 1e-4 absolute (fp32 maps of
magnitude <= 1, sums in another order). Gradients (bf16) within 2^-6 of
their largest magnitude: dsim is rounded to bf16 before the products, from
a p that the kernels compute in another order than the plain version (an
element near a rounding boundary can round the other way), and each
gradient sums hundreds of such terms.
"""

import ctypes
import os
import re
import shutil
import subprocess

import pytest
import torch

from stablekeypoints_tpu_torch.kernels import attn_capture, cross_attn, flash
from stablekeypoints_tpu_torch.ops.resize import resize_matrix

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "..", "stablekeypoints_tpu_torch", "kernels", "csrc")
EMU = os.path.join(HERE, "cuda_emu")
SOURCES = ("attn_capture", "cross_attn", "flash")
PTX_HELPERS = ("mma_bf16", "load_b", "cp_async16", "cp_async_commit", "cp_async_wait_all")
BF = torch.bfloat16


def _drop_function(src: str, name: str) -> str:
    m = re.search(r"__device__ __forceinline__ void " + name + r"\(", src)
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
    for src_name, out_name in files:
        with open(os.path.join(CSRC, src_name)) as f:
            src = f.read()
        src, n = re.subn(r"(\w+(?:<\w+>)?)<<<(.*?)>>>\((.*?)\);",
                         r"emu_launch(\2, [&] { \1(\3); });", src, flags=re.S)
        assert n >= 1 or src_name.endswith(".cuh"), f"no kernel launch found in {src_name}"
        with open(os.path.join(out_dir, out_name), "w") as f:
            f.write(src)


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
    ("flash", 2, 100, 45, 1, 512),   # the d-512 kernel: a key half fully masked
    ("cross_attn", 1, 200, 100, 2, 40),  # K3: two query tiles in one block
    ("cross_attn", 1, 128, 77, 1, 80),
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
])
def test_capture_kernel_matches_plain(libs, b, h, o, x, p, t, d):
    gen = torch.Generator().manual_seed(x * p + d)
    tt, k = _randn(gen, b, h, o, x, d), _randn(gen, b, t, h, d)
    ww = resize_matrix(x, p, "bicubic", BF, "cpu")
    out = torch.full((b, o * p, t), float("nan"))
    scale = d ** -0.5
    fn = libs["attn_capture"].skp_capture_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    assert fn(_ptr(tt), _ptr(ww), _ptr(k), _ptr(out), b, h, o, x, p, t, d, scale, None) == 0
    want = attn_capture.capture_fused_plain(tt, ww, k, scale)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-4)


def test_unsupported_head_dim_is_refused(libs):
    meta = torch.empty(0, dtype=BF)
    q = meta.new_empty(1, 128, 1, 48)
    assert _flash_fwd(libs, q, q, q, q, None, 1.0) == -1
    wide = meta.new_empty(1, 128, 1, 512)  # d 512 has no backward, so no lse
    assert _flash_fwd(libs, wide, wide, wide, wide, torch.empty(1), 1.0) == -1


@pytest.mark.parametrize("source,b,n,m,h,d", [
    ("flash", 1, 128, 128, 2, 40),   # K4 backward, d padded to 48
    ("flash", 1, 80, 100, 1, 80),    # K5: kv tail masked, ragged query tile
    ("cross_attn", 1, 200, 100, 2, 40),  # K3: row statistics recomputed
    ("cross_attn", 1, 128, 77, 1, 80),
])
def test_attention_backward_kernel_matches_plain(libs, source, b, n, m, h, d):
    gen = torch.Generator().manual_seed(n * m + d + 1)
    q, k, v = _randn(gen, b, n, h, d), _randn(gen, b, m, h, d), _randn(gen, b, m, h, d)
    do = _randn(gen, b, n, h, d)
    scale = d ** -0.5
    dq, dk, dv = (torch.full_like(x, float("nan")) for x in (q, k, v))
    lse = torch.full((b, h, n), float("nan"))
    di = torch.full((b, h, n), float("nan"))
    if source == "flash":
        out = torch.full_like(q, float("nan"))
        assert _flash_fwd(libs, q, k, v, out, lse, scale) == 0
        fn = libs["flash"].skp_flash_bwd
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        assert fn(*map(_ptr, (q, k, v, out, do, lse, di, dq, dk, dv)), b, n, m, h, d, scale,
                  None) == 0
        want = flash.attention_bwd_plain(q, k, v, out, do, scale)
    else:
        fn = libs["cross_attn"].skp_cross_bwd
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        assert fn(*map(_ptr, (q, k, v, do, lse, di, dq, dk, dv)), b, n, m, h, d, scale,
                  None) == 0
        want = cross_attn.cross_attention_bwd_plain(q, k, v, do, scale)
    _assert_grads_close((dq, dk, dv), want)


@pytest.mark.parametrize("b,h,o,x,p,t,d", [
    (1, 2, 2, 16, 128, 100, 160),  # up_1's shape class: 16 -> 128, d 160
    (1, 2, 1, 32, 128, 70, 80),    # up_2's: 32 -> 128, d 80
    (2, 1, 2, 16, 40, 30, 80),     # a ragged row of 40 columns, keys in one tile
])
def test_capture_backward_kernel_matches_plain(libs, b, h, o, x, p, t, d):
    gen = torch.Generator().manual_seed(x * p + d + 1)
    tt, k = _randn(gen, b, h, o, x, d), _randn(gen, b, t, h, d)
    ww = resize_matrix(x, p, "bicubic", BF, "cpu")
    g = torch.randn((b, o * p, t), generator=gen)
    scale = d ** -0.5
    dt, dk = torch.full_like(tt, float("nan")), torch.full_like(k, float("nan"))
    lse, c = torch.full((b, h, o * p), float("nan")), torch.full((b, h, o * p), float("nan"))
    fn = libs["attn_capture"].skp_capture_bwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    assert fn(*map(_ptr, (tt, ww, k, g, lse, c, dt, dk)), b, h, o, x, p, t, d, scale,
              None) == 0
    _assert_grads_close((dt, dk), attn_capture.capture_fused_bwd_plain(tt, ww, k, g, scale))
