"""Stage 2: vote for the most consistently selected token indices (the JAX
package's `pipeline/indices.py`, reference keypoint_regressor.py:16-108).

Over `num_indices` training images, token selection (candidate ranking +
furthest-point sampling) runs per image on the learned context, and the
`top_k` most often chosen tokens win, ties to the lower index (a stable
sort on the host).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from stablekeypoints_tpu_torch.data.base import Loader
from stablekeypoints_tpu_torch.pipeline.runtime import Runtime
from stablekeypoints_tpu_torch.utils.logging import MetricsLogger

__all__ = ["find_best_indices"]


def find_best_indices(runtime: Runtime, dataset, context, logger: Optional[MetricsLogger] = None,
                      generator: Optional[torch.Generator] = None,
                      noises: Optional[Sequence] = None) -> np.ndarray:
    """-> [top_k] int64 token indices. The latent noise of each batch comes
    from `generator` (default: seeded cfg.seed + 3 on the runtime's device),
    or from `noises`, one [batch, H/8, W/8, 4] array per batch."""
    cfg = runtime.cfg
    loader = Loader(dataset, batch_size=cfg.batch_size, shuffle=True, seed=cfg.seed + 2,
                    infinite=True)
    gen = generator or torch.Generator(device=runtime.device).manual_seed(cfg.seed + 3)
    votes = np.zeros((cfg.num_tokens,), np.int64)
    seen = batch_no = 0
    batches = iter(loader)
    try:
        while seen < cfg.num_indices:
            batch = next(batches)
            noise = None if noises is None else noises[batch_no]
            selected = runtime.select_indices(context, batch["img"], noise=noise,
                                              generator=gen).cpu().numpy()
            take = min(selected.shape[0], cfg.num_indices - seen)
            np.add.at(votes, selected[:take].reshape(-1), 1)
            seen += take
            batch_no += 1
            if logger is not None:
                logger.log({"stage": 2, "images_voted": seen})
    finally:
        loader.close()
    return np.argsort(-votes, kind="stable")[: cfg.top_k].astype(np.int64)
