"""Mid-stage training checkpoints with step numbers (the JAX package's
`utils/checkpoint.py`, there in Orbax).

Every `checkpoint_every` steps stage 1 saves the (step, context, Adam
state) triple under `save_folder/checkpoints/step_{step:08d}`, one
`torch.save` file a step, and `optimize_embedding` resumes from the
latest one. The random stream is not saved: a resumed run seeds a fresh
generator from the start step (`pipeline/optimize.py`), as the JAX package
folds the start step into a fresh key.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch

__all__ = ["TrainCheckpointer"]


class TrainCheckpointer:
    def __init__(self, save_folder: str):
        self.dir = os.path.join(os.path.abspath(save_folder), "checkpoints")
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def save(self, step: int, context: torch.Tensor, optimizer: torch.optim.Optimizer) -> None:
        """Write the triple to a temporary file, then rename it into place, so
        a run cut mid-write leaves the previous checkpoint as the latest."""
        state = {
            "step": int(step),
            "context": context.detach().to("cpu", torch.float32).clone(),
            "optimizer": optimizer.state_dict(),
        }
        path = self._path(step)
        torch.save(state, path + ".tmp")
        os.replace(path + ".tmp", path)

    def latest_step(self) -> Optional[int]:
        steps = [int(name.split("_")[1]) for name in os.listdir(self.dir)
                 if name.startswith("step_") and not name.endswith(".tmp")]
        return max(steps) if steps else None

    def restore(self, step: Optional[int] = None) -> Optional[dict[str, Any]]:
        """{"step", "context" [1, T, d] fp32, "optimizer" state dict} of
        `step` (default: the latest), loaded onto the CPU; None when there is
        nothing to restore. `Optimizer.load_state_dict` moves the Adam moments
        onto its parameter's device, wherever the checkpoint was written."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        return torch.load(self._path(step), map_location="cpu", weights_only=True)
