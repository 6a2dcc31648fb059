"""Mid-stage training checkpoints with step numbers (the JAX package's
`utils/checkpoint.py`, there in Orbax).

Every `checkpoint_every` steps stage 1 saves the (step, context, Adam
state) triple under `save_folder/checkpoints/step_{step:08d}`, one
`torch.save` file a step, and `optimize_embedding` resumes from the
latest one. The random stream is not saved: a resumed run seeds a fresh
generator from the start step (`pipeline/optimize.py`), as the JAX package
folds the start step into a fresh key.

The Adam state is written device-free: its tensors (the moments, and the
step count, which a capturable Adam on CUDA keeps as a device tensor) go to
the host, and `load_optimizer_state` keeps the live optimizer's device
settings (`capturable`, `foreach`, `fused`), so a checkpoint written on
the card resumes on the CPU and the other way round.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch

__all__ = ["TrainCheckpointer", "load_optimizer_state"]

# param_group settings that follow the device an optimizer runs on, not the run
_DEVICE_KEYS = ("capturable", "foreach", "fused")


def _to_host(state_dict: dict) -> dict:
    return {
        "state": {i: {k: v.detach().to("cpu", copy=True) if torch.is_tensor(v) else v
                      for k, v in st.items()}
                  for i, st in state_dict["state"].items()},
        "param_groups": state_dict["param_groups"],
    }


def load_optimizer_state(optimizer: torch.optim.Optimizer, state_dict: dict) -> None:
    """Load a saved state dict into `optimizer`, keeping its own device
    settings; torch moves the state onto the parameters' device (a
    capturable Adam's step count too)."""
    live = optimizer.param_groups
    groups = [dict(saved, **{k: g[k] for k in _DEVICE_KEYS if k in g})
              for saved, g in zip(state_dict["param_groups"], live)]
    optimizer.load_state_dict({"state": state_dict["state"], "param_groups": groups})


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
            "optimizer": _to_host(optimizer.state_dict()),
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
        nothing to restore. Load the optimizer state with
        `load_optimizer_state`."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        return torch.load(self._path(step), map_location="cpu", weights_only=True)
