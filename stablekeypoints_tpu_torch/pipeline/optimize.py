"""Stage 1: learn the token embedding (the JAX package's
`pipeline/optimize.py`, reference optimize.py:269-452).

Each step is `Runtime.train_step*`: one merged forward over the original
and affine-warped images, per-image token selection, sharpening +
equivariance losses, the gradient w.r.t. the context only, an Adam step.
The VAE latents of the original images are deterministic per image, so
they are cached by dataset index: the first epoch runs fill steps
(encode, and keep the latents), later epochs cached steps (the warped
images are always encoded). As in the JAX package, a group of
`steps_per_call` consecutive cache-hit steps runs as one call
(`Runtime.train_step_scan`: on CUDA one captured step replayed per step)
when the latent cache is on, the group fits before `num_steps`, no
checkpoint boundary falls strictly inside it, every batch of it hits the
cache and no profile is being taken; otherwise its batches are consumed
one step at a time, in order. `profile_steps` traces the steps after the
first with torch.profiler into `save_folder/profile`.

With a `TrainCheckpointer`, every `checkpoint_every` steps save the
(step, context, Adam state) triple and the `embedding` artifact, and a run
whose checkpointer holds a checkpoint resumes after its step.

Under a data-parallel mesh every rank runs this loop: the loader's seed and
the generator's are the same on every rank, so each sees the same global
batches and draws, and each step takes the rank's rows of them. The latent
cache holds the rank's rows, while the set of cached indices, which decides
fill or cached steps and groups, is the same on every rank. Rank 0 writes
the checkpoints (the others wait at a barrier), every rank restores, and the
restored state is broadcast from rank 0.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from stablekeypoints_tpu_torch.data.base import Loader, is_deterministic
from stablekeypoints_tpu_torch.parallel.mesh import barrier, replicate
from stablekeypoints_tpu_torch.pipeline.runtime import Runtime
from stablekeypoints_tpu_torch.utils.artifacts import save_artifact
from stablekeypoints_tpu_torch.utils.checkpoint import TrainCheckpointer, load_optimizer_state
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
    mesh = runtime.mesh
    context = runtime.train_context(context)
    opt = runtime.optimizer(context)
    start_step = 0
    restored = checkpointer.restore() if checkpointer is not None else None
    if restored is not None:
        start_step = restored["step"] + 1
        with torch.no_grad():
            context.copy_(restored["context"])
        load_optimizer_state(opt, restored["optimizer"])
        if logger is not None:
            logger.log({"stage": 1, "event": "resumed", "step": start_step})
    replicate(mesh, [context] + [v for v in opt.state.get(context, {}).values()
                                 if torch.is_tensor(v)])
    gen = generator or torch.Generator(device=runtime.device).manual_seed(
        stream_seed(cfg.seed + 1, start_step))
    loader = Loader(dataset, batch_size=cfg.batch_size, shuffle=True, seed=cfg.seed, infinite=True)
    # index-keyed cache of the originals' latents (this rank's rows), kept on
    # the device, and the indices cached on any rank
    lat_cache: Optional[dict[int, torch.Tensor]] = (
        {} if cfg.cache_latents and is_deterministic(dataset) else None
    )
    cached: set[int] = set()
    rows = mesh.rows(cfg.batch_size)

    start = it_start = time.time()
    last_logged_step = start_step - 1
    batches = iter(loader)
    pending: list = []  # batches pulled for a group but not run in one
    scan_k = max(int(cfg.steps_per_call), 1)
    profiler = None

    def next_batch():
        return pending.pop(0) if pending else next(batches)

    def maybe_log(s, values):
        """values: {aux name: float or 0-dim tensor} of step s."""
        nonlocal it_start, last_logged_step
        if logger is None or not (s % cfg.log_every == 0 or s == cfg.num_steps - 1):
            return
        values = {k: float(v) for k, v in values.items()}  # waits for the step
        now = time.time()
        logger.log({
            "stage": 1,
            "step": s,
            # field names of the reference's wandb schema (optimize.py:427-435)
            "loss": values["loss"],
            "running_sharpening_loss": values["sharpening"] * cfg.sharpening_loss_weight,
            "running_equivariance_attn_loss":
                values["equivariance"] * cfg.equivariance_attn_loss_weight,
            "iteration time": iteration_time(now, it_start, s, last_logged_step),
        })
        it_start, last_logged_step = now, s

    def boundary(s):
        return bool(cfg.checkpoint_every and s and s % cfg.checkpoint_every == 0)

    def maybe_checkpoint(s):
        if boundary(s):
            if mesh.writer:
                save_artifact(cfg.save_folder, "embedding", context.detach().cpu().numpy())
                if checkpointer is not None:
                    checkpointer.save(s, context, opt)
            barrier(mesh)

    def hit(idx):
        return lat_cache is not None and idx and all(i in cached for i in idx)

    def cached_latents(idx):
        return torch.stack([lat_cache[i] for i in idx[rows]])

    step = start_step
    try:
        while step < cfg.num_steps:
            if (cfg.profile_steps and step == start_step + 1 and profiler is None
                    and mesh.writer):
                profiler = _start_profile(runtime.device)
            if (scan_k > 1 and lat_cache is not None and not cfg.profile_steps
                    and step + scan_k <= cfg.num_steps
                    # a boundary at the group's last step is saved after it
                    and not any(boundary(s) for s in range(step, step + scan_k - 1))):
                group = [next_batch() for _ in range(scan_k)]
                idx_groups = [[int(i) for i in b.get("_idx", ())] for b in group]
                if all(hit(g) for g in idx_groups):
                    lat = torch.stack([cached_latents(g) for g in idx_groups])
                    img = np.stack([np.asarray(b["img"]) for b in group])
                    _, _, aux = runtime.train_step_scan(context, opt, lat, img, generator=gen)
                    if logger is not None:
                        aux = {k: v.tolist() for k, v in aux.items()}  # one read a group
                    for j in range(scan_k):
                        maybe_log(step + j, {k: v[j] for k, v in aux.items()})
                    maybe_checkpoint(step + scan_k - 1)
                    step += scan_k
                    continue
                pending.extend(group)  # a miss: the group's batches go one step at a time
            batch = next_batch()
            idx = [int(i) for i in batch.get("_idx", ())]
            if hit(idx):
                latents = cached_latents(idx)
                _, _, aux = runtime.train_step_cached(context, opt, latents, batch["img"],
                                                      generator=gen)
            elif lat_cache is not None and idx:
                _, _, aux, latents = runtime.train_step_fill(context, opt, batch["img"],
                                                             generator=gen)
                if len(cached) < cfg.latent_cache_entries:  # a whole batch, as the JAX loop
                    lat_cache.update(zip(idx[rows], latents))
                    cached.update(idx)
            else:
                _, _, aux = runtime.train_step(context, opt, batch["img"], generator=gen)
            if profiler is not None and step == start_step + cfg.profile_steps:
                _stop_profile(profiler, runtime.device, cfg.save_folder)
                profiler = None
            maybe_log(step, aux)
            maybe_checkpoint(step)
            step += 1
    finally:
        loader.close()
        if profiler is not None:
            _stop_profile(profiler, runtime.device, cfg.save_folder)

    if logger is not None:
        logger.log({"stage": 1, "event": "done", "seconds": time.time() - start})
    return context.detach()


def _start_profile(device: torch.device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profile(profiler, device: torch.device, save_folder: str) -> None:
    """End the trace and write it to save_folder/profile/trace.json."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    profiler.stop()
    out = os.path.join(save_folder, "profile")
    os.makedirs(out, exist_ok=True)
    profiler.export_chrome_trace(os.path.join(out, "trace.json"))
