"""ctypes bindings for the native JPEG decoder (the JAX package's
`utils/native.py`, the same C++ source: `native/image_io.cpp` at the repo
root, or `stablekeypoints_tpu_torch/_native_src/image_io.cpp` in an
installed wheel).

The shared library is built on first use with `g++ ... -ljpeg` into
`utils/_native_build/` (listed in `.gitignore`; `~/.cache/
stablekeypoints_tpu_torch` where the package directory is not writable),
named by a hash of the source and the flags and written through a temporary
file renamed into place, so processes that build at once (test workers,
data-parallel ranks) leave one loadable library. Without a compiler or
libjpeg, `load_library` returns None and callers decode with PIL. The
decoder runs on the host and releases the GIL, so the loader's prefetch
threads decode in parallel.

Build eagerly:  python -m stablekeypoints_tpu_torch.utils.native --build
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

__all__ = ["available", "decode_resize_jpeg", "load_library", "resize_normalize"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG_DIR = os.path.dirname(_HERE)
_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")


def _find_src() -> Optional[str]:
    for path in (os.path.join(os.path.dirname(_PKG_DIR), "native", "image_io.cpp"),
                 os.path.join(_PKG_DIR, "_native_src", "image_io.cpp")):
        if os.path.exists(path):
            return path
    return None


def _build(src: str) -> Optional[str]:
    """Compile `src` (once per source and flags); the library's path, or
    None when no build directory is writable or the compiler fails."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(" ".join(_FLAGS).encode() + f.read()).hexdigest()[:16]
    name = f"libskt_image_io-{digest}.so"
    for build_dir in (os.path.join(_HERE, "_native_build"),
                      os.path.join(os.path.expanduser("~"), ".cache", "stablekeypoints_tpu_torch")):
        lib_path = os.path.join(build_dir, name)
        if os.path.exists(lib_path):
            return lib_path
        tmp = f"{lib_path}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            os.makedirs(build_dir, exist_ok=True)
            subprocess.run(["g++", *_FLAGS, src, "-o", tmp, "-ljpeg"], check=True,
                           capture_output=True, timeout=120)
            os.replace(tmp, lib_path)
            return lib_path
        except (subprocess.SubprocessError, OSError):
            if os.path.exists(tmp):
                os.remove(tmp)
    return None


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def load_library() -> Optional[ctypes.CDLL]:
    """The loaded library, built on the first call; None when it cannot be
    built or loaded (then every call after returns None at once)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        src = _find_src()
        lib_path = _build(src) if src is not None else None
        if lib_path is None:
            return None
        try:
            lib = ctypes.CDLL(lib_path)
        except OSError:
            return None
        lib.skt_decode_resize_jpeg.restype = ctypes.c_int
        lib.skt_decode_resize_jpeg.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.skt_resize_normalize.restype = ctypes.c_int
        lib.skt_resize_normalize.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return load_library() is not None


def decode_resize_jpeg(data: bytes, out_h: int, out_w: int) -> Optional[np.ndarray]:
    """JPEG bytes -> [out_h, out_w, 3] float32 in [0, 1] (bilinear with
    torch's align_corners=False and no antialias where the size differs),
    or None when the bytes do not decode or there is no library."""
    lib = load_library()
    if lib is None:
        return None
    out = np.empty((out_h, out_w, 3), np.float32)
    rc = lib.skt_decode_resize_jpeg(data, len(data), out_h, out_w,
                                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out if rc == 0 else None


def resize_normalize(rgb: np.ndarray, out_h: int, out_w: int) -> Optional[np.ndarray]:
    """uint8 [H, W, 3] -> float32 [out_h, out_w, 3] in [0, 1], torch bilinear
    (align_corners=False, no antialias), or None without the library."""
    lib = load_library()
    if lib is None:
        return None
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] uint8, got {rgb.shape}")
    out = np.empty((out_h, out_w, 3), np.float32)
    rc = lib.skt_resize_normalize(rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                  rgb.shape[0], rgb.shape[1], out_h, out_w,
                                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out if rc == 0 else None


if __name__ == "__main__":  # python -m stablekeypoints_tpu_torch.utils.native --build
    import argparse

    ap = argparse.ArgumentParser(description="Build the native JPEG decoder now.")
    ap.add_argument("--build", action="store_true", help="build eagerly (the default action)")
    ap.parse_args()
    source = _find_src()
    if source is None:
        raise SystemExit("native/image_io.cpp not found (repo root or the package's _native_src/)")
    built = _build(source)
    if built is None:
        raise SystemExit(f"build failed (g++ or libjpeg missing?) for {source}")
    print(f"built {built} from {source}; loadable={load_library() is not None}")
