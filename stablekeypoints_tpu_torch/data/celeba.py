"""CelebA (aligned / wild) with the MAFL train/test splits (the JAX
package's `data/celeba.py`; reference datasets/celeba.py:8-150).

Landmarks from `Anno/list_landmarks_{align_,}celeba.txt`, file lists from
the MAFL training/testing splits, keypoints normalized by the original
image size and swapped to (y, x); the wild variant drops images whose face
bbox covers less than `iou_threshold` of the image area (celeba.py:51-72).
'img' is resized to image_size^2 (bilinear), 'kpts' are 5 x (y, x) in
[0, 1], 'visibility' is all ones.
"""

from __future__ import annotations

import os

import numpy as np

from stablekeypoints_tpu_torch.data.base import load_image_rgb

__all__ = ["CelebA"]


def _image_size(path: str) -> tuple[int, int]:
    """(width, height) from the image header; PIL decodes no pixels for it."""
    from PIL import Image

    with Image.open(path) as im:
        return im.size


class CelebA:
    def __init__(
        self,
        split: str = "train",
        align: bool = True,
        dataset_loc: str = "~",
        max_len: int = -1,
        iou_threshold: float = 0.3,
        image_size: int = 512,
    ):
        self.dataset_loc = os.path.expanduser(dataset_loc)
        self.align = align
        self.max_len = max_len
        self.image_size = image_size

        landmark_file = "list_landmarks_align_celeba.txt" if align else "list_landmarks_celeba.txt"
        with open(os.path.join(self.dataset_loc, "Anno", landmark_file)) as f:
            self.landmarks = f.readlines()

        split_file = "training.txt" if split == "train" else "testing.txt"
        with open(os.path.join(self.dataset_loc, "MAFL", split_file)) as f:
            self.file_names = f.readlines()

        if not align:
            # the bbox filter needs each image's size: header reads on a
            # thread pool, stopping once max_len images are kept
            import concurrent.futures as cf

            with open(os.path.join(self.dataset_loc, "Anno", "list_bbox_celeba.txt")) as f:
                bboxes = f.readlines()[2:]

            def keeps(name: str) -> bool:
                idx = self._local_index(name)
                bbox = [int(x) for x in bboxes[idx].split()[1:]]
                try:
                    width, height = _image_size(self._img_path(idx))
                except OSError:
                    return False  # unreadable image: drop it up front
                return bbox[2] * bbox[3] >= height * width * iou_threshold

            kept = []
            chunk = 4096
            with cf.ThreadPoolExecutor(max_workers=16) as pool:
                for start in range(0, len(self.file_names), chunk):
                    names = self.file_names[start : start + chunk]
                    kept.extend(n for n, k in zip(names, pool.map(keeps, names)) if k)
                    if max_len != -1 and len(kept) >= max_len:
                        break
            self.file_names = kept

    def _local_index(self, file_name: str) -> int:
        return int(file_name.split(".")[0]) - 1  # 1-based names -> 0-based

    def _img_path(self, index: int) -> str:
        if self.align:
            return os.path.join(self.dataset_loc, "Img", "img_align_celeba_png",
                                f"{index + 1:06d}.png")
        return os.path.join(self.dataset_loc, "Img", "img_celeba", f"{index + 1:06d}.jpg")

    def __len__(self) -> int:
        if self.max_len != -1:
            return min(self.max_len, len(self.file_names))
        return len(self.file_names)

    def __getitem__(self, index: int) -> dict:
        local = self._local_index(self.file_names[index])
        path = self._img_path(local)
        width, height = _image_size(path)
        img = load_image_rgb(path, self.image_size)

        parts = self.landmarks[local + 2].split()[1:]  # +2 skips the header lines
        kpts = np.asarray([float(p) for p in parts], np.float32).reshape(5, 2)
        kpts = kpts / np.asarray([width, height], np.float32)
        kpts = kpts[:, ::-1].copy()  # (x, y) -> (y, x)
        return {"img": img, "kpts": kpts, "visibility": np.ones((5,), np.float32)}
