"""Unaligned Human3.6M: raw image sequences + annot.h5, keypoint-driven
crops (the JAX package's `data/unaligned_human36m.py`; reference
datasets/unaligned_human36m.py:37-238).

Frames from `S{n}/<action>/imageSequence/<camera>/img_*.jpg`, 2-D poses
from the sequence's `annot.h5` matched by (camera, frame); a square crop
around the keypoints with margin 100 and translation jitter 100 (one
seeded numpy generator, drawn as the JAX adapter draws) is resized to
image_size^2 and the keypoints renormalized to the crop
(`crop_and_upsample`, unaligned_human36m.py:37-103), then (x, y) -> (y, x).
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["UnalignedHuman36M", "crop_and_upsample"]

_ACTIONS = ["Directions", "Discussion", "Posing", "Waiting", "Greeting", "Walking"]


def crop_and_upsample(img: np.ndarray, pose: np.ndarray, rng: np.random.Generator,
                      margin: int = 100, jitter: int = 100, target_size: int = 512):
    """Square keypoint bbox + margin + random jitter crop, resized to target.
    img [H, W, 3] float, pose [N, 2] normalized as stored.

    The reference's quirks are kept: the first pose column is scaled by
    the image height and the second by its width, and the output pose is
    divided by 512 after scaling to target size (normalized when
    target_size == 512)."""
    from PIL import Image

    pose = pose.astype(np.float64).copy()
    h, w = img.shape[:2]
    pose[:, 0] *= h
    pose[:, 1] *= w

    x_min, y_min = pose.min(axis=0)
    x_max, y_max = pose.max(axis=0)
    width = x_max - x_min
    height = y_max - y_min
    side = max(width, height)

    margin_x = min(margin, w - side)
    margin_y = min(margin, h - side)
    jx = int(rng.integers(-jitter, jitter))
    jy = int(rng.integers(-jitter, jitter))

    x0 = max(0.0, x_min - (side - width) / 2 - margin_x + jx)
    y0 = max(0.0, y_min - (side - height) / 2 - margin_y + jy)
    x1 = min(float(w), x0 + side + 2 * margin_x)
    y1 = min(float(h), y0 + side + 2 * margin_y)

    cropped = img[int(y0) : int(y1), int(x0) : int(x1)]
    new_pose = pose - np.asarray([[x0, y0]])
    new_pose[:, 1] /= y1 - y0
    new_pose[:, 0] /= x1 - x0

    out = Image.fromarray((np.clip(cropped, 0, 1) * 255).astype(np.uint8)).resize(
        (target_size, target_size), Image.BILINEAR
    )
    out_arr = np.asarray(out, np.float32) / 255.0
    new_pose *= target_size
    return out_arr, (new_pose / 512.0).astype(np.float32)


class UnalignedHuman36M:
    def __init__(self, data_root: str, split: str = "train", image_size: int = 512, seed: int = 0):
        self.data_root = os.path.expanduser(data_root)
        self.image_size = image_size
        self.with_kpts = split in ("train_reg", "test")
        # the keypoint-driven crop jitters at random on the train split
        self.deterministic = split != "train"
        self._rng = np.random.default_rng(seed)
        subjects = [11] if split == "test" else [1, 5, 6, 7, 8, 9]

        self.samples: list[tuple[int, str, str, int]] = []
        for s in subjects:
            sdir = os.path.join(self.data_root, f"S{s}")
            if not os.path.isdir(sdir):
                continue
            for folder in sorted(os.listdir(sdir)):
                if any(folder.startswith(a) for a in _ACTIONS):
                    seq = os.path.join(sdir, folder, "imageSequence")
                    for camera in sorted(os.listdir(seq)):
                        for frame in sorted(os.listdir(os.path.join(seq, camera))):
                            fi = int(frame.split(".")[0].split("_")[1])
                            self.samples.append((s, folder, camera, fi))

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> dict:
        import h5py
        from PIL import Image

        s, folder, camera, fi = self.samples[idx]
        sdir = os.path.join(self.data_root, f"S{s}", folder)
        img = Image.open(os.path.join(sdir, "imageSequence", camera, f"img_{fi:06d}.jpg")).convert("RGB")
        img_arr = np.asarray(img, np.float32) / 255.0

        with h5py.File(os.path.join(sdir, "annot.h5"), "r") as annot:
            match = (np.asarray(annot["camera"]) == int(camera)) & (np.asarray(annot["frame"]) == fi)
            frame_idx = int(np.nonzero(match)[0][0])
            pose = np.asarray(annot["pose/2d"][frame_idx], np.float64)
        pose /= np.asarray(img.size, np.float64)

        img_arr, pose = crop_and_upsample(img_arr, pose, self._rng, target_size=self.image_size)
        pose = pose[:, ::-1].copy()  # (x, y) -> (y, x)
        n = pose.shape[0]
        if self.with_kpts:
            return {"img": img_arr, "kpts": pose, "visibility": np.ones((n,), np.float32)}
        return {
            "img": img_arr,
            "kpts": np.zeros((n, 2), np.float32),
            "visibility": np.zeros((n,), np.float32),
        }
