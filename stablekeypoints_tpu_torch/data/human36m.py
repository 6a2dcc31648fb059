"""Human3.6M, AutoLink preprocessed layout (the JAX package's
`data/human36m.py`; reference datasets/human36m.py:35-168).

Per-subject `WithBackground` jpgs multiplied by `BackgroudMask` pngs
(bilinear-resized to image_size), 32 2-D keypoints from `Landmarks/*.mat`
(`keypoints_2d`). Subjects: train [1, 5, 6, 7, 8, 9], test [11]; with
--validation train [1, 5, 6, 7, 8], test [9].
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["Human36M"]

_ACTIONS = ["Directions", "Discussion", "Posing", "Waiting", "Greeting", "Walking"]


class Human36M:
    def __init__(self, data_root: str, split: str = "train", validation: bool = False,
                 image_size: int = 512):
        self.data_root = os.path.expanduser(data_root)
        self.image_size = image_size
        self.with_kpts = split in ("train_reg", "test")
        if split == "test":
            subjects = [9] if validation else [11]
        else:
            subjects = [1, 5, 6, 7, 8] if validation else [1, 5, 6, 7, 8, 9]

        self.samples: list[tuple[int, str, str]] = []
        for s in subjects:
            base = os.path.join(self.data_root, f"S{s}", "WithBackground")
            for folder in sorted(os.listdir(base)):
                if any(folder.startswith(a) for a in _ACTIONS):
                    for frame in sorted(os.listdir(os.path.join(base, folder))):
                        self.samples.append((s, folder, frame.split(".")[0]))

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> dict:
        from PIL import Image

        s, folder, frame = self.samples[idx]
        sdir = os.path.join(self.data_root, f"S{s}")
        img = Image.open(os.path.join(sdir, "WithBackground", folder, f"{frame}.jpg")).convert("RGB")
        mask = Image.open(os.path.join(sdir, "BackgroudMask", folder, f"{frame}.png"))

        size = (self.image_size, self.image_size)
        if img.size != size:
            img = img.resize(size, Image.BILINEAR)
        mask = mask.resize(size, Image.BILINEAR)
        img_arr = np.asarray(img, np.float32) / 255.0
        mask_arr = np.asarray(mask, np.float32)
        if mask_arr.ndim == 3:
            mask_arr = mask_arr[..., 0]
        result = img_arr * mask_arr[..., None]

        if self.with_kpts:
            import scipy.io

            kp = scipy.io.loadmat(os.path.join(sdir, "Landmarks", folder, f"{frame}.mat"))[
                "keypoints_2d"
            ].astype(np.float32)
            vis = np.ones((kp.shape[0],), np.float32)
        else:
            kp = np.zeros((32, 2), np.float32)
            vis = np.zeros((32,), np.float32)
        return {"img": result, "kpts": kp, "visibility": vis}
