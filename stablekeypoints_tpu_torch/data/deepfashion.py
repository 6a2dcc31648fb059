"""DeepFashion, AutoLink format: data_{train,test}.csv + .json keypoints
(the JAX package's `data/deepfashion.py`; reference
datasets/deepfashion.py:17-87).

Image list from the csv's second column, 8 keypoints / 256 rolled to
(y, x). The reference normalizes images with mean = std = 0.5, so 'img'
is kept in [-1, 1] here (x * 2 - 1), and the VAE input, img * 2 - 1, sees
the same values as the reference's. Keypoints are unaffected.
"""

from __future__ import annotations

import json
import os

import numpy as np

from stablekeypoints_tpu_torch.data.base import load_image_rgb

__all__ = ["DeepFashion"]


class DeepFashion:
    def __init__(self, data_root: str, split: str = "train", image_size: int = 512):
        self.data_root = os.path.expanduser(data_root)
        self.image_size = image_size
        tag = "test" if split == "test" else "train"
        with open(os.path.join(self.data_root, f"data_{tag}.csv")) as f:
            lines = f.readlines()[1:]
        self.files = [line.split(",")[1].strip() for line in lines]
        self.kpts = None
        if split in ("train_reg", "test"):
            with open(os.path.join(self.data_root, f"data_{tag}.json")) as f:
                kp = json.load(f)
            kp = np.asarray([k["keypoints"] for k in kp], np.float32)
            self.kpts = np.roll(kp, shift=1, axis=-1) / 256.0  # (x, y) -> (y, x), /256

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> dict:
        img = load_image_rgb(os.path.join(self.data_root, "img", self.files[idx]), self.image_size)
        img = img * 2.0 - 1.0  # the reference's Normalize(0.5, 0.5) (deepfashion.py:26)
        k = self.kpts[idx] if self.kpts is not None else np.zeros((8, 2), np.float32)
        return {"img": img, "kpts": k, "visibility": np.ones((k.shape[0],), np.float32)}
