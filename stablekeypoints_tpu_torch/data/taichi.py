"""Taichi, AutoLink format (the JAX package's `data/taichi.py`; reference
datasets/taichi.py:37-119).

train: the image folder under `train/`, with a random horizontal flip
(p = 0.5) drawn from one seeded numpy generator as the JAX adapter draws
it; train_reg/test: pandas-pickled `landmark/taichi_{train,test}_gt.pkl`
frames + `eval_images/taichi-256` images, 18 kpts / 256, (x, y) -> (y, x),
visible where both coordinates are > 0.
"""

from __future__ import annotations

import os

import numpy as np

from stablekeypoints_tpu_torch.data.base import load_image_rgb

__all__ = ["Taichi"]

_IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp"}


class Taichi:
    def __init__(self, data_root: str, split: str = "train", image_size: int = 512, seed: int = 0):
        self.data_root = os.path.expanduser(data_root)
        self.image_size = image_size
        self.split = split
        # the train split flips at random (reference taichi.py:43)
        self.deterministic = split != "train"
        self._rng = np.random.default_rng(seed)
        if split == "train":
            root = os.path.join(self.data_root, "train")
            self.files = []
            for dirpath, _, names in sorted(os.walk(root)):
                for n in sorted(names):
                    if os.path.splitext(n)[1].lower() in _IMG_EXTS:
                        self.files.append(os.path.join(dirpath, n))
        else:
            import pandas

            tag = "test" if split == "test" else "train"
            pkl = os.path.join(self.data_root, "landmark", f"taichi_{tag}_gt.pkl")
            self.pose_file = pandas.read_pickle(pkl)
            self.img_dir = os.path.join(self.data_root, "eval_images", "taichi-256", tag)

    def __len__(self) -> int:
        return len(self.files) if self.split == "train" else len(self.pose_file)

    def __getitem__(self, idx: int) -> dict:
        if self.split == "train":
            img = load_image_rgb(self.files[idx], self.image_size)
            if self._rng.random() < 0.5:  # RandomHorizontalFlip (taichi.py:43)
                img = img[:, ::-1].copy()
            return {
                "img": img,
                "kpts": np.zeros((18, 2), np.float32),
                "visibility": np.zeros((18,), np.float32),
            }
        name = self.pose_file.file_name[idx]
        img = load_image_rgb(os.path.join(self.img_dir, name), self.image_size)
        pose = np.asarray(self.pose_file.value[idx], np.float32) / 256.0
        pose = pose[:, ::-1].copy()  # (x, y) -> (y, x)
        vis = ((pose > 0).sum(axis=1) == 2).astype(np.float32)
        return {"img": img, "kpts": pose, "visibility": vis}
