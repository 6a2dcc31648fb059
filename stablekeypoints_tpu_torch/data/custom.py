"""Custom dataset: any folder of images, dummy keypoints (the JAX
package's `data/custom.py`; reference datasets/custom_images.py:7-28):
sorted file listing, resize to image_size^2, zero kpts/visibility
placeholders.
"""

from __future__ import annotations

import os

import numpy as np

from stablekeypoints_tpu_torch.data.base import load_image_rgb

__all__ = ["CustomDataset"]

_IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp", ".tif", ".tiff"}


class CustomDataset:
    def __init__(self, data_root: str, image_size: int = 512, num_dummy_kpts: int = 15):
        self.data_root = os.path.expanduser(data_root)
        self.image_size = image_size
        self.num_dummy_kpts = num_dummy_kpts
        self.files = sorted(
            f
            for f in os.listdir(self.data_root)
            if os.path.isfile(os.path.join(self.data_root, f))
            and os.path.splitext(f)[1].lower() in _IMG_EXTS
        )

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> dict:
        img = load_image_rgb(os.path.join(self.data_root, self.files[idx]), self.image_size)
        return {
            "img": img,
            "kpts": np.zeros((self.num_dummy_kpts, 2), np.float32),
            "visibility": np.zeros((self.num_dummy_kpts,), np.float32),
        }
