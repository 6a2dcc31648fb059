"""Checks shared by the kernel wrappers.

A wrapper takes its kernel's plain PyTorch version only for CPU tensors.
For CUDA tensors it launches the kernel or raises: the checks below reject
what the kernels do not take (dtype, layout, alignment) before any pointer
reaches them. The attention kernels (K1, K3, K4/K5) have backward kernels
and run inside `torch.autograd.Function`s (`models/layers.py`), so their
wrappers pass `allow_grad=True`; a forward-only kernel (K6) rejects inputs
that require grad.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["check_kernel_inputs", "check_launch", "ptr", "stream_handle"]


def check_kernel_inputs(name: str, *tensors: torch.Tensor, dtype=torch.bfloat16,
                        allow_grad: bool = False) -> None:
    device = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{name}: all inputs must be on one CUDA device, got {t.device}")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{name}: kernel takes {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel takes contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: kernel needs 16-byte aligned tensors")
        if t.requires_grad and not allow_grad:
            raise RuntimeError(
                f"{name}: the kernel is forward-only; run under torch.no_grad()"
            )


def stream_handle() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def check_launch(name: str, err: int) -> None:
    if err == -1:
        raise NotImplementedError(f"{name}: the kernel refused the shape")
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {err}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
