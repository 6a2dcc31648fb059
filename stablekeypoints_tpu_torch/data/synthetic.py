"""Synthetic keypoint dataset: coloured Gaussian blobs at consistently
ordered, jittered locations on a noisy background; kpts are the blob
centres. Gives training something learnable with no files (the JAX
package's `data/synthetic.py`, sample for sample)."""

from __future__ import annotations

import numpy as np

__all__ = ["SyntheticBlobs"]


class SyntheticBlobs:
    def __init__(self, length: int = 64, image_size: int = 64, num_kpts: int = 4,
                 seed: int = 0, jitter: float = 0.08):
        self.length = length
        self.image_size = image_size
        self.num_kpts = num_kpts
        rng = np.random.default_rng(seed)
        # canonical part layout shared by every "object instance"
        self.base = rng.uniform(0.25, 0.75, size=(num_kpts, 2)).astype(np.float32)
        self.colors = rng.uniform(0.4, 1.0, size=(num_kpts, 3)).astype(np.float32)
        self.jitter = jitter
        self.seed = seed

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.default_rng(self.seed * 100_003 + idx)
        s = self.image_size
        offset = rng.uniform(-self.jitter, self.jitter, size=(1, 2)).astype(np.float32)
        kpts = np.clip(self.base + offset, 0.05, 0.95)
        ys, xs = np.mgrid[0:s, 0:s].astype(np.float32) / s
        img = rng.uniform(0.0, 0.08, size=(s, s, 3)).astype(np.float32)
        sigma = 0.04
        for (ky, kx), c in zip(kpts, self.colors):
            blob = np.exp(-((ys - ky) ** 2 + (xs - kx) ** 2) / (2 * sigma**2))
            img += blob[:, :, None] * c[None, None, :]
        return {
            "img": np.clip(img, 0.0, 1.0),
            "kpts": kpts.astype(np.float32),
            "visibility": np.ones((self.num_kpts,), np.float32),
        }
