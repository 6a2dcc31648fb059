"""Stages 3 and 4: precompute keypoints and fit the closed-form regressor
(the JAX package's `pipeline/regressor.py`).

Stage 3 (reference keypoint_regressor.py:111-198): for up to
`max_num_points` training-regression images, the augmented ensemble gives
each image's source keypoints (argmax or soft-argmax of the averaged maps,
normalized by the image size); the ground-truth keypoints and visibility
come with them.

Stage 4 (keypoint_regressor.py:201-273): least squares from the centered,
flattened source coordinates to the centered ground truth: plain pinv,
per-column visibility-filtered pinv, and the Human3.6M variant that
relabels left/right-swapped ground-truth rows while more than 10 samples
prefer the swap. numpy float64, cast to float32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from stablekeypoints_tpu_torch.ops.keypoints import find_max_pixel, pixel_from_weighted_avg
from stablekeypoints_tpu_torch.pipeline.ensemble_loop import ensemble_chunks
from stablekeypoints_tpu_torch.pipeline.metrics import swap_points

__all__ = [
    "extract_keypoints",
    "fit_regressor",
    "precompute_all_keypoints",
    "return_regressor",
    "return_regressor_human36m",
    "return_regressor_visible",
]


def extract_keypoints(maps, strategy: str = "argmax") -> np.ndarray:
    """[k, S, S] maps -> [k, 2] normalized (y, x) keypoints."""
    maps = torch.as_tensor(maps)
    size = maps.shape[-1]
    pts = find_max_pixel(maps) if strategy == "argmax" else pixel_from_weighted_avg(maps)
    return pts.cpu().numpy() / size


def precompute_all_keypoints(runtime, dataset, context, indices, logger=None,
                             generator: Optional[torch.Generator] = None):
    """-> (source [n, k, 2], target [n, K, 2], visibility [n, K] or None)
    over n = min(len(dataset), max_num_points) images in the order numpy's
    default_rng(seed + 4) permutes them, as the JAX package. Thetas and
    noise come from `generator` (default: seeded cfg.seed + 4 on the
    runtime's device), in chunks of `eval_batch_images` images."""
    cfg = runtime.cfg
    n = min(len(dataset), cfg.max_num_points)
    gen = generator or torch.Generator(device=runtime.device).manual_seed(cfg.seed + 4)
    order = np.random.default_rng(cfg.seed + 4).permutation(len(dataset))[:n]

    source, target, visibility = [], [], []
    idx_arr = np.asarray(indices, np.int64)
    m = max(1, cfg.eval_batch_images)
    for ci, (samples, pts) in enumerate(
        ensemble_chunks(runtime, dataset, order, context, idx_arr, gen, m)
    ):
        for s, p in zip(samples, pts):
            source.append(p)
            target.append(np.asarray(s["kpts"], np.float32))
            if "visibility" in s:
                visibility.append(np.asarray(s["visibility"], np.float32))
        if logger is not None and ci % 50 == 0:
            logger.log({"stage": 3, "precomputed": len(source), "total": n})

    vis = np.stack(visibility) if visibility else None
    return np.stack(source), np.stack(target), vis


def return_regressor(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Plain least squares on centered coordinates (keypoint_regressor.py:229-239)."""
    x = x.astype(np.float64) - 0.5
    y = y.astype(np.float64) - 0.5
    return np.linalg.pinv(x.T @ x) @ x.T @ y


def return_regressor_visible(x: np.ndarray, y: np.ndarray, visible: np.ndarray) -> np.ndarray:
    """Per-output-column least squares over the rows where that keypoint is
    visible (keypoint_regressor.py:201-226)."""
    x = x.astype(np.float64) - 0.5
    y = y.astype(np.float64) - 0.5
    w = np.zeros((x.shape[1], y.shape[1]))
    for j in range(y.shape[1]):
        rows = np.where(visible[:, j] == 1)[0]
        xf, yf = x[rows], y[rows, j]
        w[:, j] = np.linalg.pinv(xf.T @ xf) @ xf.T @ yf
    return w


def return_regressor_human36m(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Least squares with iterative left/right relabelling of the ground
    truth (keypoint_regressor.py:242-273): it stops once 10 or fewer rows
    prefer the swap, as the reference."""
    x = x.astype(np.float64) - 0.5
    y = y.astype(np.float64) - 0.5
    xtxxt = np.linalg.inv(x.T @ x) @ x.T
    while True:
        w = xtxxt @ y
        pred = x @ w
        dist = np.linalg.norm((pred - y).reshape(x.shape[0], -1, 2), axis=2).mean(axis=1)
        swapped = swap_points(y.reshape(y.shape[0], -1, 2)).reshape(y.shape[0], -1)
        swapped_dist = np.linalg.norm((pred - swapped).reshape(x.shape[0], -1, 2), axis=2).mean(axis=1)
        should_swap = dist > swapped_dist
        if should_swap.sum() > 10:
            y[should_swap] = swapped[should_swap]
        else:
            break
    return w


def fit_regressor(cfg, source: np.ndarray, target: np.ndarray, visible) -> np.ndarray:
    """The regressor of `cfg.evaluation_method` (reference main.py:265-291)."""
    x = source.reshape(source.shape[0], -1)
    y = target.reshape(target.shape[0], -1)
    if cfg.evaluation_method in ("visible", "mean_average_error"):
        vis2 = np.ones_like(y) if visible is None else np.repeat(visible, 2, axis=1)
        return return_regressor_visible(x, y, vis2).astype(np.float32)
    if cfg.evaluation_method == "orientation_invariant":
        return return_regressor_human36m(x, y).astype(np.float32)
    return return_regressor(x, y).astype(np.float32)
