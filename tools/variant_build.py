"""What the kernel ablation tools (`tools/*_variants.py`) share: build copies
of a csrc tree, each with text substitutions, and time a call on the device.

Needs nvcc and a CUDA device at call time; imports no JAX.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time


def build(nvcc: str, out_dir: str, variants: dict, sources: tuple) -> dict:
    """Build every source of every variant, all nvcc processes at once.

    `variants` maps a name to (csrc directory, [(file, old, new), ...]): the
    directory is copied to out_dir/name and each `old` replaced by `new`
    (an `old` that is not found is an error). Returns {name: {source: CDLL}}
    for the `sources` (file names without `.cu`); ptxas's report of each
    build is kept beside it (`<source>.ptxas.log`) and its performance
    warnings are printed. A variant built before from the same files and
    substitutions (out_dir/name/.key) is loaded as it is.
    """
    procs = {}
    for name, (src_dir, subs) in variants.items():
        d = os.path.join(out_dir, name)
        key = hashlib.sha256(repr((sources, subs)).encode())
        for fn in sorted(os.listdir(src_dir)):
            with open(os.path.join(src_dir, fn), "rb") as f:
                key.update(fn.encode() + f.read())
        key_path = os.path.join(d, ".key")
        if os.path.exists(key_path) and open(key_path).read() == key.hexdigest() and all(
                os.path.exists(os.path.join(d, f"{src}.so")) for src in sources):
            continue
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(src_dir, d)
        for fn, old, new in subs:
            with open(os.path.join(d, fn)) as f:
                text = f.read()
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not found in {fn}")
            with open(os.path.join(d, fn), "w") as f:
                f.write(text.replace(old, new))
        with open(key_path, "w") as f:
            f.write(key.hexdigest())
        for src in sources:
            procs[name, src] = subprocess.Popen(
                [nvcc, "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
                 "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", os.path.join(d, f"{src}.so"),
                 os.path.join(d, f"{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs: dict = {}
    for (name, src), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} {src}.cu:\n{log}")
        with open(os.path.join(out_dir, name, f"{src}.ptxas.log"), "w") as f:
            f.write(log)
        for line in log.splitlines():  # ptxas's performance warnings (wgmma serialized)
            if "Performance Loss" in line:
                print(f"[build] {name} {src}: {line.strip()[:200]}", flush=True)
    for name in variants:
        for src in sources:
            libs.setdefault(name, {})[src] = ctypes.CDLL(os.path.join(out_dir, name, f"{src}.so"))
    return libs


def device_ms(torch, fn, reps: int) -> float:
    """Device ms per call of `fn`: CUDA events around `reps` calls queued
    behind a device-side spin long enough to hide the host's launches."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * reps * host_s + 1e-3) * 2.2e9))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
