"""High-level API: learn keypoints, and detect them with a learned context
and token indices.

    model = learn_keypoints(dataset, cfg)        # stages 1 + 2
    model = KeypointModel.load("outputs", cfg)   # or: embedding + indices
    kpts = model.detect(image)                   # [top_k, 2] normalized (y, x)

Stage 1 learns the context (`pipeline/optimize.py` `optimize_embedding`),
stage 2 votes the top-k token indices (`pipeline/indices.py`
`find_best_indices`). A folder written by the JAX package's
`KeypointModel.save` loads here. Image folders and the named datasets are
not ported yet: `learn_keypoints` takes a dataset object.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from stablekeypoints_tpu_torch.config import Config
from stablekeypoints_tpu_torch.pipeline.indices import find_best_indices
from stablekeypoints_tpu_torch.pipeline.optimize import optimize_embedding
from stablekeypoints_tpu_torch.pipeline.runtime import Runtime
from stablekeypoints_tpu_torch.utils.artifacts import load_artifact, save_artifact
from stablekeypoints_tpu_torch.utils.logging import MetricsLogger

__all__ = ["KeypointModel", "learn_keypoints"]


@dataclasses.dataclass
class KeypointModel:
    """A learned embedding + selected token indices bound to a runtime."""

    runtime: Runtime
    context: np.ndarray  # [1, T, d]
    indices: np.ndarray  # [top_k]

    def _generator(self, generator: Optional[torch.Generator]) -> torch.Generator:
        if generator is not None:
            return generator
        return torch.Generator(device=self.runtime.device).manual_seed(
            self.runtime.cfg.seed + 9
        )

    def detect(self, image: np.ndarray, generator: Optional[torch.Generator] = None) -> np.ndarray:
        """image [H, W, 3] float in [0, 1] -> [top_k, 2] normalized (y, x),
        from the augmented test-time ensemble."""
        return self.detect_batch(np.asarray(image)[None], generator)[0]

    def detect_batch(self, images: np.ndarray,
                     generator: Optional[torch.Generator] = None) -> np.ndarray:
        """images [M, H, W, 3] -> [M, top_k, 2]."""
        pts = self.runtime.augmented_keypoints(
            self.context, np.asarray(images, np.float32), self.indices,
            generator=self._generator(generator),
        )
        return pts.cpu().numpy()

    def heatmaps(self, image: np.ndarray, generator: Optional[torch.Generator] = None) -> np.ndarray:
        """[top_k, H, W] ensembled attention maps for one image."""
        maps = self.runtime.augmented_maps(
            self.context, np.asarray(image, np.float32), self.indices,
            generator=self._generator(generator),
        )
        return maps.cpu().numpy()

    def save(self, save_folder: str) -> None:
        save_artifact(save_folder, "embedding", self.context)
        save_artifact(save_folder, "indices", self.indices)

    @staticmethod
    def load(save_folder: str, cfg: Optional[Config] = None,
             runtime: Optional[Runtime] = None, device=None) -> "KeypointModel":
        cfg = cfg if cfg is not None else Config()
        runtime = runtime if runtime is not None else Runtime.create(cfg, device=device)
        return KeypointModel(
            runtime,
            load_artifact(save_folder, "embedding"),
            load_artifact(save_folder, "indices").astype(np.int64),
        )


def learn_keypoints(dataset, cfg: Optional[Config] = None, runtime: Optional[Runtime] = None,
                    logger: Optional[MetricsLogger] = None, device=None,
                    **overrides) -> KeypointModel:
    """Stages 1 + 2 on a dataset object (items {"img": [H, W, 3] in [0, 1],
    ...}) -> a KeypointModel. A folder path raises until the dataset
    adapters are ported."""
    if isinstance(dataset, str):
        raise NotImplementedError(
            "learn_keypoints on an image folder: the dataset adapters are not ported yet; "
            "pass a dataset object"
        )
    if cfg is None:
        cfg = Config(dataset_name="custom", **overrides)
    elif overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    runtime = runtime if runtime is not None else Runtime.create(cfg, device=device)
    context = optimize_embedding(runtime, dataset, logger)
    indices = find_best_indices(runtime, dataset, context, logger)
    return KeypointModel(runtime, context.cpu().numpy(), indices)
