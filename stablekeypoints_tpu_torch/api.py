"""High-level API: detect keypoints with a learned context and token indices.

    model = KeypointModel.load("outputs", cfg)   # embedding + indices
    kpts = model.detect(image)                   # [top_k, 2] normalized (y, x)

Stage 1, learning the context, is ported (`pipeline/optimize.py`
`optimize_embedding`, `Runtime.train_step*`); stage 2, the vote of the
top-k token indices, is not yet. A folder written by the JAX package's
`KeypointModel.save` loads here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from stablekeypoints_tpu_torch.config import Config
from stablekeypoints_tpu_torch.pipeline.runtime import Runtime
from stablekeypoints_tpu_torch.utils.artifacts import load_artifact, save_artifact

__all__ = ["KeypointModel"]


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
