"""Stage artifacts on disk: `.npy` (native) plus `.pt` (torch export).

The same artifact layout as the JAX package writes, so a folder saved by
either side loads in the other.
"""

from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["save_artifact", "load_artifact"]


def save_artifact(save_folder: str, name: str, array) -> str:
    os.makedirs(save_folder, exist_ok=True)
    arr = np.asarray(array)
    npy_path = os.path.join(save_folder, f"{name}.npy")
    np.save(npy_path, arr)
    torch.save(torch.from_numpy(arr.copy()), os.path.join(save_folder, f"{name}.pt"))
    return npy_path


def load_artifact(save_folder: str, name: str) -> np.ndarray:
    npy_path = os.path.join(save_folder, f"{name}.npy")
    if os.path.exists(npy_path):
        return np.load(npy_path)
    pt_path = os.path.join(save_folder, f"{name}.pt")
    if os.path.exists(pt_path):
        t = torch.load(pt_path, map_location="cpu", weights_only=True)
        if isinstance(t, torch.Tensor):
            # a saved leaf embedding may still require grad
            return t.detach().numpy()
        arr = np.asarray(t)
        if arr.dtype == object:
            raise TypeError(
                f"{pt_path} does not contain a tensor/array (got "
                f"{type(t).__name__}); extract the right entry before loading"
            )
        return arr
    raise FileNotFoundError(f"artifact {name} not found in {save_folder}")
