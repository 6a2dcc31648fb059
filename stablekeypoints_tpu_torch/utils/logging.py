"""Structured metrics logging: JSONL always, wandb when asked for (the JAX
package's `utils/logging.py`; the field names are the reference's)."""

from __future__ import annotations

import json
import os
import time
from typing import Optional

__all__ = ["MetricsLogger"]


class MetricsLogger:
    def __init__(self, save_folder: str, use_wandb: bool = False, wandb_name: str = "temp",
                 config: Optional[dict] = None, filename: str = "metrics.jsonl"):
        os.makedirs(save_folder, exist_ok=True)
        self._path = os.path.join(save_folder, filename)
        self._file = open(self._path, "a", buffering=1)
        self._start = time.time()
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project="attention_maps", name=wandb_name, config=config or {})
            except ImportError:
                print("wandb not available; logging to JSONL only")
        if config:
            self.log({"event": "config", **config})

    def log(self, metrics: dict):
        record = {"t": round(time.time() - self._start, 3)}
        record.update(
            {k: (float(v) if hasattr(v, "item") or isinstance(v, (int, float)) else v)
             for k, v in metrics.items()}
        )
        self._file.write(json.dumps(record) + "\n")
        if self._wandb is not None and metrics.get("event") != "config":
            self._wandb.log({k: v for k, v in record.items() if isinstance(v, (int, float))})

    def close(self):
        self._file.close()
        if self._wandb is not None:
            self._wandb.finish()
