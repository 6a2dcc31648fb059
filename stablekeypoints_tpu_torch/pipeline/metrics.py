"""Evaluation metrics, the five protocols of the reference's eval.py:374-523
(the JAX package's `pipeline/metrics.py`). Pure numpy on the host in
float64: the per-image math is tiny next to the ensemble that precedes it.
"""

from __future__ import annotations

import numpy as np

__all__ = ["HUMAN36M_SWAPS", "apply_regressor", "compute_metric", "swap_points"]

# eval.py:360-371: left/right correspondences of Human3.6M's 32 keypoints
HUMAN36M_SWAPS = [
    (1, 6), (2, 7), (3, 8), (4, 9), (5, 10),
    (17, 25), (18, 26), (19, 27), (20, 28), (21, 28), (22, 30), (23, 31),
]


def swap_points(points: np.ndarray) -> np.ndarray:
    """Swap left/right keypoints; points [..., N, D] (eval.py:360-371).

    The reference builds the permutation by sequential assignment, so the
    duplicated (21, 28) after (20, 28) overwrites perm[28] with 21; the
    same loop runs here."""
    n = points.shape[-2]
    perm = list(range(n))
    for a, b in HUMAN36M_SWAPS:
        perm[a] = b
        perm[b] = a
    return points[..., perm, :]


def apply_regressor(found: np.ndarray, regressor: np.ndarray) -> np.ndarray:
    """((x - 0.5) @ W) + 0.5 on the flattened coordinates (eval.py:453)."""
    flat = found.reshape(1, -1) - 0.5
    est = flat @ regressor + 0.5
    return est.reshape(-1, 2)


def compute_metric(method: str, estimated: np.ndarray, gt: np.ndarray, visible=None) -> float:
    """One image's scalar metric (eval.py:459-494); estimated, gt [K, 2]
    normalized (y, x)."""
    est, g = estimated.astype(np.float64), gt.astype(np.float64)
    if method in ("mean_average_error", "pck"):
        est = est * 256.0
        g = g * 256.0
    l2 = np.linalg.norm(est - g, axis=-1)

    if method == "inter_eye_distance":
        eye = np.linalg.norm(g[0] - g[1])
        return float(np.mean(l2 / eye))
    if method in ("visible", "mean_average_error"):
        vis = np.ones_like(l2) if visible is None else np.asarray(visible, np.float64)
        val = float((l2 * vis).sum())
        if method == "visible":
            val /= float(vis.sum())
        return val
    if method == "pck":
        return float((l2 < 6.0).mean())
    if method == "orientation_invariant":
        mean = l2.mean()
        swapped = swap_points(est[None])[0]
        swapped_mean = np.linalg.norm(swapped - g, axis=-1).mean()
        return float(min(mean, swapped_mean) * 128.0)
    raise NotImplementedError(f"unknown evaluation method: {method}")
