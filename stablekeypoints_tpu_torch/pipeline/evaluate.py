"""Stage 5: evaluate the regressed keypoints on the test set (the JAX
package's `pipeline/evaluate.py`; reference eval.py:374-523)."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from stablekeypoints_tpu_torch.pipeline.ensemble_loop import ensemble_chunks
from stablekeypoints_tpu_torch.pipeline.metrics import apply_regressor, compute_metric
from stablekeypoints_tpu_torch.pipeline.visualize import save_augmentation_panel
from stablekeypoints_tpu_torch.utils.artifacts import save_artifact

__all__ = ["evaluate"]


def evaluate(runtime, dataset, context, indices, regressor, logger=None,
             generator: Optional[torch.Generator] = None):
    """-> (mean metric, per-image metrics [n]) over the test set in the
    order numpy's default_rng(seed + 5) permutes it; saves `all_errors`
    (and, with cfg.visualize, the first image's `augmentation.png`).
    Thetas and noise come from `generator` (default: seeded cfg.seed + 5
    on the runtime's device)."""
    cfg = runtime.cfg
    idx_arr = np.asarray(indices, np.int64)
    reg = np.asarray(regressor, np.float32)

    order = np.random.default_rng(cfg.seed + 5).permutation(len(dataset))
    if cfg.visualize and len(order) and runtime.mesh.writer:
        # the ensemble's debug panel of the first evaluated image
        # (reference eval.py:268-353, called at eval.py:443-444)
        first = dataset[int(order[0])]
        save_augmentation_panel(runtime, np.asarray(first["img"], np.float32), context, indices,
                                os.path.join(cfg.save_folder, "augmentation.png"))
    gen = generator or torch.Generator(device=runtime.device).manual_seed(cfg.seed + 5)
    all_values = []
    m = max(1, cfg.eval_batch_images)
    n_chunks = -(-len(order) // m)
    for ci, (samples, pts) in enumerate(
        ensemble_chunks(runtime, dataset, order, context, idx_arr, gen, m)
    ):
        for s, found in zip(samples, pts):
            est = apply_regressor(found, reg)
            all_values.append(
                compute_metric(cfg.evaluation_method, est, np.asarray(s["kpts"]), s.get("visibility"))
            )
        if logger is not None and (ci % 100 == 0 or ci + 1 == n_chunks):
            logger.log({"stage": 5, "evaluated": len(all_values),
                        "mean_distance": float(np.mean(all_values))})

    mean_distance = float(np.mean(all_values))
    if runtime.mesh.writer:  # every rank holds the same values
        save_artifact(cfg.save_folder, "all_errors", np.asarray(all_values, np.float32))
    if logger is not None:
        logger.log({"stage": 5, "event": "done", "mean_distance": mean_distance})
    return mean_distance, np.asarray(all_values)
