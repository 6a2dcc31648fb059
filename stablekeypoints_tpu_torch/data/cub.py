"""CUB aligned, AutoLink-format cub.h5 (the JAX package's `data/cub.py`;
reference datasets/cub.py:36-98).

{train,test}_{img,kp,vis}: images uint8 CHW resized to image_size, kpts
in [0, 1] stored (x, y) and swapped to (y, x). Splits: train and
train_reg read train_*, test reads test_*.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["CUBAligned"]


class CUBAligned:
    def __init__(self, data_root: str, split: str = "train", image_size: int = 512):
        import h5py

        prefix = "test" if split == "test" else "train"
        path = os.path.join(os.path.expanduser(data_root), "cub.h5")
        with h5py.File(path, "r") as hf:
            self.imgs = np.asarray(hf[f"{prefix}_img"])  # [N, C, H, W] uint8
            self.kpts = np.asarray(hf[f"{prefix}_kp"], np.float32)
            self.vis = np.asarray(hf[f"{prefix}_vis"], np.float32)
        self.image_size = image_size

    def __len__(self) -> int:
        return self.imgs.shape[0]

    def __getitem__(self, idx: int) -> dict:
        from PIL import Image

        img = np.transpose(self.imgs[idx], (1, 2, 0))  # CHW -> HWC
        if img.shape[0] != self.image_size:
            img = np.asarray(
                Image.fromarray(img).resize((self.image_size, self.image_size), Image.BILINEAR)
            )
        return {
            "img": img.astype(np.float32) / 255.0,
            "kpts": self.kpts[idx][:, ::-1].copy(),  # (x, y) -> (y, x)
            "visibility": self.vis[idx],
        }
