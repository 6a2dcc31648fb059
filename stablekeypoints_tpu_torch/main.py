"""CLI entry point: stages 1-5 in order (the JAX package's `main.py`).

    python -m stablekeypoints_tpu_torch.main --dataset_name celeba_aligned \
        --dataset_loc /data/celeba [--device cpu] [...]
    torchrun --nproc_per_node N -m stablekeypoints_tpu_torch.main ... [--data_parallel N]

The flags are the JAX package's, with its names, choices and defaults (the
reference's main.py:23-195 and the JAX package's own). The port runs on
the GPU unless `--device` names another device. `--steps_per_call` runs
groups of cache-hit steps as one call (a CUDA graph replayed per step on
the GPU), `--remat` recomputes the transformers' activations in the
backward, `--capture_fp32_bwd` keeps the capture backward's dsim in fp32
and `--profile_steps` writes a torch.profiler trace; `--jax_cache_dir` is
accepted and ignored, as `Config` says.

Data parallel: launched by torchrun, `run` joins the process group (NCCL
on GPUs, gloo with `--device cpu`) and every rank runs every stage on its
rows of each batch (`parallel/mesh.py`); `--data_parallel`, when given,
must equal the number of processes. Rank 0 alone writes artifacts, logs
and checkpoints, and the other ranks wait for it at a barrier.

Stage artifacts (embedding, indices, source_keypoints, target_keypoints,
visible, regressor, all_errors) go to --save_folder as .npy + .pt, the
JAX package's layout; --visualize adds the plots of
`pipeline/visualize.py` after stages 2 and 4 and in stage 5. With --resume, a stage whose artifact is on disk is
not run again, and stage 1 continues from its latest checkpoint.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from stablekeypoints_tpu_torch.config import Config, apply_preset
from stablekeypoints_tpu_torch.data.registry import DATASET_NAMES, build_dataset
from stablekeypoints_tpu_torch.parallel.mesh import (
    barrier,
    destroy_group,
    init_from_launch,
    make_mesh,
)
from stablekeypoints_tpu_torch.pipeline.evaluate import evaluate
from stablekeypoints_tpu_torch.pipeline.indices import find_best_indices
from stablekeypoints_tpu_torch.pipeline.optimize import optimize_embedding
from stablekeypoints_tpu_torch.pipeline.regressor import fit_regressor, precompute_all_keypoints
from stablekeypoints_tpu_torch.pipeline.runtime import Runtime
from stablekeypoints_tpu_torch.pipeline.visualize import pyplot, visualize_attn_maps
from stablekeypoints_tpu_torch.utils.artifacts import load_artifact, save_artifact
from stablekeypoints_tpu_torch.utils.checkpoint import TrainCheckpointer
from stablekeypoints_tpu_torch.utils.logging import MetricsLogger

__all__ = ["build_parser", "config_from_args", "main", "run"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="learn and evaluate keypoints (PyTorch + CUDA)")
    d = Config()
    # network
    p.add_argument("--model_type", type=str, default=d.model_type)
    p.add_argument("--model_path", type=str, default=None,
                   help="diffusers-layout checkpoint dir (unet/, vae/; safetensors or bin); "
                        "omit for random weights")
    p.add_argument("--my_token", type=str, default=None,
                   help="accepted for reference-CLI parity; unused offline")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the GPU (raises without one), "
                        "'cpu' for the plain kernel versions")
    # dataset
    p.add_argument("--dataset_loc", type=str, default=d.dataset_loc)
    p.add_argument("--dataset_name", type=str, default=d.dataset_name, choices=DATASET_NAMES)
    p.add_argument("--max_len", type=int, default=d.max_len)
    p.add_argument("--validation", action="store_true")
    # output
    p.add_argument("--save_folder", type=str, default=d.save_folder)
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--wandb_name", type=str, default=d.wandb_name)
    p.add_argument("--visualize", action="store_true",
                   help="keypoint and heatmap plots after stages 2 and 4 and the ensemble's "
                        "panel in stage 5 (needs matplotlib)")
    # optimization
    p.add_argument("--lr", type=float, default=d.lr)
    p.add_argument("--num_steps", type=int, default=d.num_steps)
    p.add_argument("--num_tokens", type=int, default=d.num_tokens)
    p.add_argument("--batch_size", type=int, default=d.batch_size)
    p.add_argument("--sharpening_loss_weight", type=float, default=d.sharpening_loss_weight)
    p.add_argument("--equivariance_attn_loss_weight", type=float,
                   default=d.equivariance_attn_loss_weight)
    p.add_argument("--sigma", type=float, default=d.sigma)
    p.add_argument("--num_subjects", type=int, default=d.num_subjects)
    # capture
    p.add_argument("--feature_upsample_res", type=int, default=d.feature_upsample_res)
    p.add_argument("--layers", type=int, nargs="+", default=list(d.layers))
    p.add_argument("--noise_level", type=int, default=d.noise_level)
    # selection
    p.add_argument("--top_k_strategy", type=str, default=d.top_k_strategy,
                   choices=["entropy", "gaussian", "consistent"])
    p.add_argument("--furthest_point_num_samples", type=int, default=d.furthest_point_num_samples)
    p.add_argument("--top_k", type=int, default=d.top_k)
    p.add_argument("--num_indices", type=int, default=d.num_indices)
    p.add_argument("--min_dist", type=float, default=d.min_dist)
    # extraction / eval
    p.add_argument("--max_loc_strategy", type=str, default=d.max_loc_strategy,
                   choices=["argmax", "weighted_avg"])
    p.add_argument("--evaluation_method", type=str, default=d.evaluation_method,
                   choices=["inter_eye_distance", "visible", "mean_average_error",
                            "pck", "orientation_invariant"])
    p.add_argument("--max_num_points", type=int, default=d.max_num_points)
    # augmentation
    p.add_argument("--augment_degrees", type=float, default=d.augment_degrees)
    p.add_argument("--augment_scale", type=float, nargs="+", default=list(d.augment_scale))
    p.add_argument("--augment_translate", type=float, nargs="+", default=list(d.augment_translate))
    p.add_argument("--augmentation_iterations", type=int, default=d.augmentation_iterations)
    # compute
    p.add_argument("--image_size", type=int, default=d.image_size)
    p.add_argument("--dtype", type=str, default=d.dtype, choices=["bfloat16", "float32"])
    p.add_argument("--data_parallel", type=int, default=d.data_parallel,
                   help="data-parallel ranks: -1 = the processes torchrun started (one "
                        "without torchrun); another value must equal their number")
    p.add_argument("--no_truncate_unet", dest="truncate_unet", action="store_false")
    p.add_argument("--pallas_capture", type=str, default=d.pallas_capture,
                   choices=["auto", "on", "off"], help="the K1/K2 capture kernels")
    p.add_argument("--capture_dtype", type=str, default=d.capture_dtype, choices=["fp32", "bf16"],
                   help="dtype of the captured attention maps")
    p.add_argument("--capture_fp32_bwd", action="store_true",
                   help="fp32 dsim through the capture backward's products")
    p.add_argument("--fused_groupnorm", type=str, default=d.fused_groupnorm,
                   choices=["auto", "on", "off"], help="the K6 VAE GroupNorm kernel")
    p.add_argument("--fused_gn_conv", type=str, default=d.fused_gn_conv,
                   choices=["auto", "on", "off"],
                   help="the K7 GroupNorm + SiLU + 3x3 conv kernel in the VAE resnets")
    p.add_argument("--flash_attention", type=str, default=d.flash_attention,
                   choices=["auto", "on", "off"], help="the K3/K4/K5 attention kernels")
    p.add_argument("--remat", type=str, default=d.remat, choices=["auto", "on", "off"],
                   help="recompute the UNet transformers' activations in the backward "
                        "(auto: when 2 * batch * (image_size / 512)^2 > 8)")
    p.add_argument("--no_cache_latents", dest="cache_latents", action="store_false",
                   help="disable the per-index VAE latent cache")
    p.add_argument("--latent_cache_entries", type=int, default=d.latent_cache_entries)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--checkpoint_every", type=int, default=d.checkpoint_every)
    p.add_argument("--resume", action="store_true",
                   help="resume from mid-stage checkpoints / stage artifacts")
    p.add_argument("--log_every", type=int, default=d.log_every)
    p.add_argument("--profile_steps", type=int, default=d.profile_steps,
                   help="trace this many stage-1 steps after the first (torch.profiler, "
                        "save_folder/profile)")
    p.add_argument("--eval_batch_images", type=int, default=d.eval_batch_images)
    p.add_argument("--steps_per_call", type=int, default=d.steps_per_call,
                   help="stage-1 cache-hit steps per call (one CUDA graph replayed per step)")
    p.add_argument("--native_io", type=str, default=d.native_io, choices=["auto", "on", "off"],
                   help="JPEG decoding: off = PIL; auto = the native libjpeg decoder where "
                        "it is bit-identical to PIL (a JPEG at the target size); on = the "
                        "native decode + torch-bilinear resize for every JPEG")
    p.add_argument("--eval_ensemble_res", type=int, default=d.eval_ensemble_res,
                   help="-1 = warp the test-time ensemble at image resolution "
                        "(reference-exact); lower = faster eval")
    p.add_argument("--jax_cache_dir", type=str, default=d.jax_cache_dir, help="ignored")
    p.add_argument("--latent_warp", action="store_true",
                   help="warp the cached latent instead of encoding each warped view "
                        "(an approximation: one VAE encode less per step, one per image "
                        "instead of per view in the ensemble)")
    return p


def config_from_args(args: argparse.Namespace) -> Config:
    fields = {f.name for f in dataclasses.fields(Config)}
    kw = {k: v for k, v in vars(args).items() if k in fields}
    for t in ("layers", "augment_scale", "augment_translate"):
        kw[t] = tuple(kw[t])
    return apply_preset(Config(**kw))


def run(cfg: Config, unet_config=None, vae_config=None, device=None) -> dict:
    """Stages 1-5 on `device` (default: the GPU). `unet_config`/`vae_config`
    override the model topology (the tests' tiny models); None means the
    configuration `cfg.model_type` names. Launched by torchrun, each rank
    joins the process group (and leaves it at the end); under a running
    group each rank takes its rank's device unless `device` names one."""
    if cfg.visualize:
        pyplot()  # no matplotlib: raise before any stage runs
    joined = init_from_launch(device)
    try:
        return _run(cfg, unet_config, vae_config, device)
    finally:
        if joined:
            destroy_group()


class _NoLogger:
    """The log of a rank that is not rank 0: nothing is written."""

    def log(self, metrics: dict) -> None:
        pass

    def close(self) -> None:
        pass


def _run(cfg: Config, unet_config, vae_config, device) -> dict:
    mesh = make_mesh(cfg.data_parallel, device=device)
    runtime = Runtime.create(cfg, unet_config, vae_config, mesh=mesh)
    logger = (MetricsLogger(cfg.save_folder, cfg.wandb, cfg.wandb_name,
                            config=dataclasses.asdict(cfg)) if mesh.writer else _NoLogger())
    results: dict = {}

    def save(name, value):
        if mesh.writer:
            save_artifact(cfg.save_folder, name, value)

    def reused(*names):
        """With --resume, the named artifacts when all are on disk, else None."""
        if not cfg.resume:
            return None
        try:
            return [load_artifact(cfg.save_folder, name) for name in names]
        except FileNotFoundError:
            return None

    def artifact_or(name, compute):
        """Stage-level resume: an artifact on disk is not computed again."""
        found = reused(name)
        if found is not None:
            logger.log({"event": "stage_artifact_reused", "artifact": name})
            return found[0]
        value = np.asarray(compute())
        save(name, value)
        barrier(mesh)
        return value

    # Stage 1
    train_ds = build_dataset(cfg, "train")
    checkpointer = TrainCheckpointer(cfg.save_folder) if cfg.checkpoint_every or cfg.resume else None
    context = artifact_or(
        "embedding",
        lambda: optimize_embedding(runtime, train_ds, logger, checkpointer=checkpointer).cpu(),
    )
    results["embedding"] = context

    # Stage 2
    indices = artifact_or("indices", lambda: find_best_indices(runtime, train_ds, context, logger))
    results["indices"] = indices

    if cfg.visualize and mesh.writer:  # no collective: rank 0 alone plots
        visualize_attn_maps(runtime, train_ds, context, indices, logger=logger)

    if cfg.dataset_name in ("custom", "synthetic"):
        if mesh.writer:
            print("Dataset has no annotations; stopping after stage 2 (+visualization).")
        logger.close()
        return results

    # Stage 3
    reg_ds = build_dataset(cfg, "train_reg")
    found = reused("source_keypoints", "target_keypoints")
    if found is not None:
        source, target = found
        visible = (reused("visible") or [None])[0]
        logger.log({"event": "stage_artifact_reused", "artifact": "keypoints"})
    else:
        source, target, visible = precompute_all_keypoints(runtime, reg_ds, context, indices,
                                                           logger)
        save("source_keypoints", source)
        save("target_keypoints", target)
        if visible is not None:
            save("visible", visible)

    # Stage 4
    regressor = fit_regressor(cfg, source, target, visible)
    save("regressor", regressor)
    results["regressor"] = regressor

    if cfg.visualize and mesh.writer:
        visualize_attn_maps(runtime, reg_ds, context, indices, regressor=regressor, logger=logger)
    barrier(mesh)

    # Stage 5
    test_ds = build_dataset(cfg, "test")
    mean_distance, _ = evaluate(runtime, test_ds, context, indices, regressor, logger)
    results["mean_distance"] = mean_distance
    if mesh.writer:
        print(f"mean distance: {mean_distance}")
    logger.close()
    return results


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    return run(config_from_args(args), device=args.device)


if __name__ == "__main__":
    main()
