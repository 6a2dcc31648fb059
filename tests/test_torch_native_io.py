"""The port's native JPEG decoder (`utils/native.py`) and its routing
(`data/base.py`), the cases of tests/test_native_io.py against the port,
and two more: the port's decode of the same JPEG bytes is bitwise the JAX
module's (one C++ source, one libjpeg), and two processes that build the
library at once leave one loadable library and no temporary file.

The comparison loads the JAX module's library from a build directory of
its own (the module's SKT_NATIVE_BUILD_DIR, set before the module's first
load in the test, its load state reset and restored afterwards): that
module compiles straight into its shared build path, with no temporary
file, so a test process that loaded it while another test process was
writing it there got no library. A regression case starts two processes
that build the JAX module's library into one fresh directory at once,
while the comparison loads its own."""

import torch_threads  # noqa: F401  (torch's threads: this xdist worker's share)
import io
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
from PIL import Image

from stablekeypoints_tpu_torch.data import base
from stablekeypoints_tpu_torch.utils import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _needs_the_library():
    if not native.available():
        pytest.skip("g++ or libjpeg unavailable: the native decoder cannot be built")
    yield
    base.set_native_io("auto")


def _jpeg_bytes(arr: np.ndarray, quality: int = 95) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def test_decode_resize_jpeg_roundtrip():
    ys, xs = np.mgrid[0:64, 0:48].astype(np.float32)  # smooth: small JPEG loss
    img = np.stack([127 + 100 * np.sin(ys / 9), 127 + 100 * np.cos(xs / 7),
                    np.full_like(ys, 60)], axis=-1).astype(np.uint8)
    out = native.decode_resize_jpeg(_jpeg_bytes(img), 64, 48)
    assert out is not None and out.shape == (64, 48, 3)
    np.testing.assert_allclose(out, img.astype(np.float32) / 255.0, atol=0.05)


def test_resize_matches_torch_bilinear():
    import torch
    import torch.nn.functional as F

    img = np.random.default_rng(1).integers(0, 255, size=(37, 53, 3), dtype=np.uint8)
    out = native.resize_normalize(img, 64, 64)
    assert out is not None
    t = torch.from_numpy(img.astype(np.float32) / 255.0).permute(2, 0, 1)[None]
    ref = F.interpolate(t, size=(64, 64), mode="bilinear", align_corners=False)
    np.testing.assert_allclose(out, ref[0].permute(1, 2, 0).numpy(), atol=2e-3)


def test_decode_invalid_returns_none():
    assert native.decode_resize_jpeg(b"not a jpeg", 8, 8) is None


def test_load_image_rgb_fast_jpeg(tmp_path):
    p = str(tmp_path / "x.jpg")
    Image.fromarray(np.full((40, 40, 3), 128, np.uint8)).save(p, quality=95)
    out = base.load_image_rgb_fast(p, 32)
    assert out.shape == (32, 32, 3)
    np.testing.assert_allclose(out, 128 / 255.0, atol=0.02)


def test_native_io_auto_bit_equal_to_pil(tmp_path):
    """auto routes a target-sized JPEG through the native decoder, bitwise
    the PIL path's pixels (libjpeg's output / 255 on both)."""
    img = np.random.default_rng(2).integers(0, 255, size=(64, 64, 3), dtype=np.uint8)
    p = str(tmp_path / "at_size.jpg")
    Image.fromarray(img).save(p, quality=90)
    base.set_native_io("off")
    pil = base.load_image_rgb(p, 64)
    base.set_native_io("auto")
    calls = []
    decode = native.decode_resize_jpeg
    native.decode_resize_jpeg = lambda *a: calls.append(a[1:]) or decode(*a)
    try:
        nat = base.load_image_rgb(p, 64)
    finally:
        native.decode_resize_jpeg = decode
    assert calls == [(64, 64)]  # the native decoder ran
    assert np.array_equal(pil, nat)


def test_native_io_auto_resize_uses_pil(tmp_path):
    """auto keeps PIL's resize for a JPEG not at the target size."""
    img = np.random.default_rng(3).integers(0, 255, size=(96, 96, 3), dtype=np.uint8)
    p = str(tmp_path / "resize.jpg")
    Image.fromarray(img).save(p, quality=90)
    base.set_native_io("auto")
    auto = base.load_image_rgb(p, 64)
    base.set_native_io("off")
    assert np.array_equal(auto, base.load_image_rgb(p, 64))
    base.set_native_io("on")  # the native resize: other pixels
    assert not np.array_equal(auto, base.load_image_rgb(p, 64))


def test_native_io_mode_validation():
    with pytest.raises(ValueError):
        base.set_native_io("fast")


def test_load_image_rgb_fast_png_falls_back(tmp_path):
    p = str(tmp_path / "x.png")
    Image.fromarray(np.full((40, 40, 3), 64, np.uint8)).save(p)
    out = base.load_image_rgb_fast(p, 32)
    assert out.shape == (32, 32, 3)
    np.testing.assert_allclose(out, 64 / 255.0, atol=0.01)


@pytest.fixture(scope="module")
def jax_build_dir(tmp_path_factory):
    """A build directory for the JAX module's library, private to this
    module's process."""
    return str(tmp_path_factory.mktemp("jax_native_build"))


@pytest.fixture
def jax_native(monkeypatch, jax_build_dir):
    """The JAX module, loading its library from `jax_build_dir` (never from
    its shared native/build/), its load state reset for this test and
    restored after it."""
    from stablekeypoints_tpu.utils import native as jax_native

    monkeypatch.setenv("SKT_NATIVE_BUILD_DIR", jax_build_dir)
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_tried", False)
    return jax_native


def _assert_decodes_equal(jax_native, size):
    img = np.random.default_rng(4).integers(0, 255, size=(*size, 3), dtype=np.uint8)
    data = _jpeg_bytes(img, quality=85)
    got, want = native.decode_resize_jpeg(data, 64, 64), jax_native.decode_resize_jpeg(data, 64, 64)
    assert got is not None and want is not None
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    assert np.array_equal(native.resize_normalize(img, 64, 64),
                          jax_native.resize_normalize(img, 64, 64))


@pytest.mark.parametrize("size", [(48, 64), (64, 64), (200, 120)])
def test_decode_bitwise_equal_to_jax_module(jax_native, jax_build_dir, size):
    """Downscaled, at size and upscaled to 64^2: the port's decode of the
    same bytes is the JAX module's, bit for bit; so is the resize alone."""
    _assert_decodes_equal(jax_native, size)
    assert os.listdir(jax_build_dir) == ["libskt_image_io.so"]


_JAX_BUILD_CHILD = textwrap.dedent("""
    from stablekeypoints_tpu.utils import native
    print(native.load_library() is not None)
""")


def test_jax_module_builders_do_not_reach_the_comparison(jax_native, tmp_path):
    """Two processes build the JAX module's library into one fresh shared
    directory at once (the race that left a test process without one); the
    comparison, loading from its own directory meanwhile, gets a library
    and decodes bitwise equal. The builders' own outcome is not asserted:
    either may lose that race."""
    shared = tmp_path / "shared_build"
    env = dict(os.environ, PYTHONPATH=REPO, SKT_NATIVE_BUILD_DIR=str(shared))
    procs = [subprocess.Popen([sys.executable, "-c", _JAX_BUILD_CHILD], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=REPO, env=env)
             for _ in range(2)]
    try:
        assert jax_native.load_library() is not None
        _assert_decodes_equal(jax_native, (48, 64))
    finally:
        outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs


_BUILD_CHILD = textwrap.dedent("""
    import sys
    from stablekeypoints_tpu_torch.utils import native
    native._HERE = sys.argv[1]  # the build directory is <_HERE>/_native_build
    path = native._build(native._find_src())
    lib = native.load_library()
    assert path is not None and lib is not None, path
    print(path)
""")


def test_two_processes_building_at_once_leave_one_library(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_CHILD, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=REPO, env=env) for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out + err
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    built = os.listdir(tmp_path / "_native_build")
    assert built == [os.path.basename(paths.pop())], built  # no temporary file is left
