"""Stage 1: learn the token embedding (the JAX package's
`pipeline/optimize.py`, reference optimize.py:269-452).

Each step is `Runtime.train_step*`: one merged forward over the original
and affine-warped images, per-image token selection, sharpening +
equivariance losses, the gradient w.r.t. the context only, an Adam step.
The VAE latents of the original images are deterministic per image, so
they are cached by dataset index: the first epoch runs fill steps
(encode, and keep the latents), later epochs cached steps (the warped
images are always encoded). `steps_per_call` is accepted and ignored: the
loop calls one step at a time.

With a `TrainCheckpointer`, every `checkpoint_every` steps save the
(step, context, Adam state) triple and the `embedding` artifact, and a run
whose checkpointer holds a checkpoint resumes after its step.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from stablekeypoints_tpu_torch.data.base import Loader, is_deterministic
from stablekeypoints_tpu_torch.pipeline.runtime import Runtime
from stablekeypoints_tpu_torch.utils.artifacts import save_artifact
from stablekeypoints_tpu_torch.utils.checkpoint import TrainCheckpointer
from stablekeypoints_tpu_torch.utils.logging import MetricsLogger

__all__ = ["iteration_time", "optimize_embedding", "stream_seed"]


def iteration_time(now: float, window_start: float, step: int, last_logged_step: int) -> float:
    """Seconds per optimizer step over the window since the last log event."""
    return (now - window_start) / max(step - last_logged_step, 1)


def stream_seed(seed: int, start_step: int) -> int:
    """The training generator's seed for a run that starts at `start_step`:
    `seed` itself from step 0, else a seed mixed from both, so a resumed run
    does not draw step 0's thetas and noise again (the JAX package folds
    the start step into its key)."""
    if start_step == 0:
        return seed
    return int(np.random.SeedSequence([seed, start_step]).generate_state(1)[0])


def optimize_embedding(runtime: Runtime, dataset, logger: Optional[MetricsLogger] = None,
                       context=None, checkpointer: Optional[TrainCheckpointer] = None,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Run steps up to `cfg.num_steps` from `context` (default: the
    runtime's seeded init) and return the learned context [1, T, d] fp32.
    A checkpoint in `checkpointer` replaces the context and the Adam state
    and the run starts after its step. Random thetas and noise come from
    `generator` (default: seeded `stream_seed(cfg.seed + 1, start step)` on
    the runtime's device)."""
    cfg = runtime.cfg
    context = runtime.train_context(context)
    opt = runtime.optimizer(context)
    start_step = 0
    restored = checkpointer.restore() if checkpointer is not None else None
    if restored is not None:
        start_step = restored["step"] + 1
        with torch.no_grad():
            context.copy_(restored["context"])
        opt.load_state_dict(restored["optimizer"])
        if logger is not None:
            logger.log({"stage": 1, "event": "resumed", "step": start_step})
    gen = generator or torch.Generator(device=runtime.device).manual_seed(
        stream_seed(cfg.seed + 1, start_step))
    loader = Loader(dataset, batch_size=cfg.batch_size, shuffle=True, seed=cfg.seed, infinite=True)
    # index-keyed cache of the originals' latents, kept on the device
    lat_cache: Optional[dict[int, torch.Tensor]] = (
        {} if cfg.cache_latents and is_deterministic(dataset) else None
    )

    start = it_start = time.time()
    last_logged_step = start_step - 1
    batches = iter(loader)
    try:
        for step in range(start_step, cfg.num_steps):
            batch = next(batches)
            idx = [int(i) for i in batch.get("_idx", ())]
            if lat_cache is not None and idx and all(i in lat_cache for i in idx):
                latents = torch.stack([lat_cache[i] for i in idx])
                _, _, aux = runtime.train_step_cached(context, opt, latents, batch["img"],
                                                      generator=gen)
            elif lat_cache is not None and idx:
                _, _, aux, latents = runtime.train_step_fill(context, opt, batch["img"],
                                                             generator=gen)
                if len(lat_cache) < cfg.latent_cache_entries:  # a whole batch, as the JAX loop
                    lat_cache.update(zip(idx, latents))
            else:
                _, _, aux = runtime.train_step(context, opt, batch["img"], generator=gen)

            if logger is not None and (step % cfg.log_every == 0 or step == cfg.num_steps - 1):
                values = {k: float(v) for k, v in aux.items()}  # waits for the step
                now = time.time()
                logger.log({
                    "stage": 1,
                    "step": step,
                    # field names of the reference's wandb schema (optimize.py:427-435)
                    "loss": values["loss"],
                    "running_sharpening_loss": values["sharpening"] * cfg.sharpening_loss_weight,
                    "running_equivariance_attn_loss":
                        values["equivariance"] * cfg.equivariance_attn_loss_weight,
                    "iteration time": iteration_time(now, it_start, step, last_logged_step),
                })
                it_start, last_logged_step = now, step
            if cfg.checkpoint_every and step and step % cfg.checkpoint_every == 0:
                save_artifact(cfg.save_folder, "embedding", context.detach().cpu().numpy())
                if checkpointer is not None:
                    checkpointer.save(step, context, opt)
    finally:
        loader.close()

    if logger is not None:
        logger.log({"stage": 1, "event": "done", "seconds": time.time() - start})
    return context.detach()
