"""CUB-200-2011 with cmr-cachedir annotations, cub_001/002/003/cub_all
(the JAX package's `data/cub_parts.py`; reference
datasets/cub_parts.py:242-441).

.mat annotations from `CUB_200_2011/cachedir/cub/data/{split}_cub_cleaned.mat`,
15 keypoints with visibility, the tight bbox padded by 5% (plus 5% jitter
at train time), squared, cropped with bgval=1, scaled so the longest side
is img_size, a train-time random horizontal mirror with the fixed keypoint
permutation, keypoints normalized to [0, 1] and swapped to (y, x). The
train split draws its jitter and mirror from one seeded numpy generator in
the JAX adapter's order, so both sides draw the same values.
"""

from __future__ import annotations

import os.path as osp

import numpy as np

__all__ = ["CUBParts"]

PADDING_FRAC = 0.05
JITTER_FRAC = 0.05
# cub_parts.py:272: keypoint index permutation under a horizontal flip
KP_PERM = np.array([1, 2, 3, 4, 5, 6, 11, 12, 13, 10, 7, 8, 9, 14, 15]) - 1


def _peturb_bbox(bbox, pf, jf, rng):
    b = [float(c) for c in bbox]
    bw = bbox[2] - bbox[0] + 1
    bh = bbox[3] - bbox[1] + 1
    b[0] -= pf * bw + (1 - 2 * rng.random()) * jf * bw
    b[1] -= pf * bh + (1 - 2 * rng.random()) * jf * bh
    b[2] += pf * bw + (1 - 2 * rng.random()) * jf * bw
    b[3] += pf * bh + (1 - 2 * rng.random()) * jf * bh
    return b


def _square_bbox(bbox):
    b = [int(round(c)) for c in bbox]
    bw = b[2] - b[0] + 1
    bh = b[3] - b[1] + 1
    maxdim = float(max(bw, bh))
    b[0] -= int(round((maxdim - bw) / 2.0))
    b[1] -= int(round((maxdim - bh) / 2.0))
    b[2] = int(b[0] + maxdim - 1)
    b[3] = int(b[1] + maxdim - 1)
    return b


def _crop(img, bbox, bgval):
    b = [int(round(c)) for c in bbox]
    bw, bh = b[2] - b[0] + 1, b[3] - b[1] + 1
    h, w = img.shape[:2]
    nc = img.shape[2] if img.ndim == 3 else 1
    out = np.ones((bh, bw, nc), img.dtype) * bgval
    xs0, xs1 = max(0, b[0]), min(w, b[2] + 1)
    ys0, ys1 = max(0, b[1]), min(h, b[3] + 1)
    xt0 = xs0 - b[0]
    yt0 = ys0 - b[1]
    out[yt0 : yt0 + (ys1 - ys0), xt0 : xt0 + (xs1 - xs0), :] = img[ys0:ys1, xs0:xs1].reshape(
        ys1 - ys0, xs1 - xs0, nc
    )
    return out


class CUBParts:
    def __init__(
        self,
        dataset_root: str = "~",
        split: str = "train",
        single_class: int | None = None,
        image_size: int = 512,
        seed: int = 0,
    ):
        import scipy.io as sio

        self.img_size = image_size
        self.split = split
        # train-time bbox jitter + random mirror: a sample is not a function
        # of its index alone, so no index-keyed latent cache
        self.deterministic = split != "train"
        self._rng = np.random.default_rng(seed)
        data_dir = osp.join(osp.expanduser(dataset_root), "CUB_200_2011")
        cache = osp.join(data_dir, "cachedir", "cub")
        self.img_dir = osp.join(data_dir, "images")
        anno_path = osp.join(cache, "data", f"{split}_cub_cleaned.mat")
        self.anno = sio.loadmat(anno_path, struct_as_record=False, squeeze_me=True)["images"]
        self.labels = [int(self.anno[i].rel_path.split(".")[0]) for i in range(len(self.anno))]
        if single_class is not None:
            keep = [i for i, c in enumerate(self.labels) if c == single_class]
            self.anno = [self.anno[i] for i in keep]
            self.labels = [self.labels[i] for i in keep]

    def __len__(self) -> int:
        return len(self.anno)

    def __getitem__(self, index: int) -> dict:
        import cv2
        from PIL import Image

        data = self.anno[index]
        img = np.asarray(Image.open(osp.join(self.img_dir, str(data.rel_path))))
        if img.ndim == 2:
            img = np.repeat(img[:, :, None], 3, axis=2)

        bbox = np.asarray([data.bbox.x1, data.bbox.y1, data.bbox.x2, data.bbox.y2], float) - 1
        parts = data.parts.T.astype(float)  # [15, 3] (x, y, vis)
        kp = parts.copy()
        vis = kp[:, 2] > 0
        kp[vis, :2] -= 1

        jf = JITTER_FRAC if self.split == "train" else 0.0
        bbox = _square_bbox(_peturb_bbox(bbox, PADDING_FRAC, jf, self._rng))

        img = _crop(img.astype(np.float64), bbox, bgval=1)
        kp[vis, 0] -= bbox[0]
        kp[vis, 1] -= bbox[1]

        scale = self.img_size / float(max(img.shape[0], img.shape[1]))
        new_size = tuple(np.round(np.asarray(img.shape[:2]) * scale).astype(int))
        img = cv2.resize(img, (new_size[1], new_size[0]))
        kp[vis, :2] *= scale

        if self.split == "train" and self._rng.random() > 0.5:
            img = img[:, ::-1, :].copy()
            new_x = img.shape[1] - kp[:, 0] - 1
            kp = np.hstack((new_x[:, None], kp[:, 1:]))[KP_PERM, :]

        h, w = img.shape[:2]
        kp_norm = np.stack([2 * (kp[:, 0] / w) - 1, 2 * (kp[:, 1] / h) - 1, kp[:, 2]]).T
        kp_norm = (kp[:, 2, None] > 0) * kp_norm

        kpts = (kp_norm[:, :2] + 1) / 2
        kpts = kpts[:, ::-1].copy()  # (x, y) -> (y, x)

        # pad to a square image_size (crop and scale bound the long side)
        out = np.zeros((self.img_size, self.img_size, 3), np.float32)
        out[: img.shape[0], : img.shape[1]] = img.astype(np.float32) / 255.0
        return {
            "img": out,
            "kpts": kpts.astype(np.float32),
            "visibility": kp_norm[:, 2].astype(np.float32),
        }
