"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into its own
shared library with a plain C interface and loaded with `ctypes`; no
PyTorch headers are compiled, so a build takes seconds. `build_all()`
starts one `nvcc` per source at once. Libraries go to `kernels/_build/`
(listed in `.gitignore`), named by a hash of the sources and flags, so an
edited source is rebuilt and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["SOURCES", "build_all", "load"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD = os.path.join(_HERE, "_build")
SOURCES = ("attn_capture", "cross_attn", "flash", "gn_conv", "groupnorm")
_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def _target(name: str) -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for fn in sorted(os.listdir(_CSRC)):
        if fn.endswith(".cuh") or fn == f"{name}.cu":
            with open(os.path.join(_CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return os.path.join(_BUILD, f"{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp path, target) or None
    when the library is already built."""
    target = _target(name)
    if os.path.exists(target):
        return None
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    cmd = [_nvcc_path(), *_FLAGS, "-o", tmp, os.path.join(_CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, target = started
    log, _ = proc.communicate()
    with open(target + ".log", "w") as f:
        f.write(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
    os.replace(tmp, target)


def build_all() -> dict[str, str]:
    """Compile every source not yet built, all nvcc processes in parallel.
    Returns {name: ptxas log} for the sources built by this call."""
    with _lock:
        started = {n: _start(n) for n in SOURCES}
        for n, s in started.items():
            _finish(n, s)
        logs = {}
        for n, s in started.items():
            if s is not None:
                with open(s[2] + ".log") as f:
                    logs[n] = f.read()
        return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(_target(name))
            _libs[name] = lib
        return lib
