"""Framework configuration of the PyTorch port.

A copy of the JAX package's `Config` with the same field names and
defaults, so one configuration reads the same on both sides. The port
keeps its own copy: it imports nothing from the JAX package.

Knobs that only steered XLA or the TPU are accepted and ignored, so a
configuration written for the JAX package still constructs here:
`data_parallel`, `remat` (activation checkpointing is not ported; at the
SD-1.5 512^2 batch-4 training shape the JAX package's own auto rule turns
it off), `steps_per_call` (the training loop calls one step at a time),
`jax_cache_dir` and `profile_steps`. `capture_fp32_bwd` keeps the capture
backward's dsim in fp32 through its products, as the JAX package's
`precise` kernel path: the plain version (CPU tensors) honours it, and the
CUDA kernel raises NotImplementedError for it (its products are bf16
mma.sync).

The kernel flags take auto|on|off as in the JAX package, and any other
value raises. On the port "auto" and "on" are one setting: each wrapper
launches its kernel for CUDA tensors and runs its plain version for CPU
tensors. `fused_gn_conv="on"` raises until the fused GroupNorm+SiLU+conv
kernel is ported; until then "auto" means "off" (the unfused resnet path).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["Config", "DATASET_PRESETS", "apply_preset"]


@dataclasses.dataclass
class Config:
    # network / checkpoint
    model_type: str = "sd-legacy/stable-diffusion-v1-5"
    model_path: Optional[str] = None  # diffusers-layout dir (not yet supported)
    my_token: Optional[str] = None

    # dataset
    dataset_loc: str = "~"
    dataset_name: str = "celeba_aligned"
    max_len: int = -1
    validation: bool = False

    # output
    save_folder: str = "outputs"
    wandb: bool = False
    wandb_name: str = "temp"
    visualize: bool = False

    # optimization (stage 1)
    lr: float = 5e-3
    num_steps: int = 500
    num_tokens: int = 500
    batch_size: int = 4
    sharpening_loss_weight: float = 100.0
    equivariance_attn_loss_weight: float = 1000.0
    sigma: float = 2.0
    num_subjects: int = 1

    # attention capture
    feature_upsample_res: int = 128
    layers: tuple[int, ...] = (0, 1, 2, 3)
    noise_level: int = -1

    # token selection
    top_k_strategy: str = "gaussian"
    furthest_point_num_samples: int = 25
    top_k: int = 10
    num_indices: int = 100
    min_dist: float = 0.1

    # keypoint extraction / eval
    max_loc_strategy: str = "argmax"  # argmax | weighted_avg
    evaluation_method: str = "inter_eye_distance"
    max_num_points: int = 50_000

    # augmentation
    augment_degrees: float = 15.0
    augment_scale: tuple[float, float] = (0.8, 1.0)
    augment_translate: tuple[float, float] = (0.25, 0.25)
    augmentation_iterations: int = 10

    # compute
    image_size: int = 512
    dtype: str = "bfloat16"  # compute dtype for the UNet/VAE
    cache_latents: bool = True
    latent_cache_entries: int = 50_000
    data_parallel: int = -1  # ignored (single device)
    truncate_unet: bool = True  # stop the forward after the last captured map
    # auto|on|off for each hand-written kernel (auto and on alike, see the
    # module note); off takes the plain PyTorch layer code instead
    pallas_capture: str = "auto"  # K1 capture kernel
    capture_fp32_bwd: bool = False  # fp32 dsim in the K1 backward (plain version only)
    capture_dtype: str = "fp32"  # fp32|bf16 dtype of the captured maps
    flash_attention: str = "auto"  # K3/K4/K5 attention kernels
    fused_groupnorm: str = "auto"  # K6 VAE GroupNorm kernel
    fused_gn_conv: str = "auto"  # "on" raises until K7 is ported
    remat: str = "auto"  # ignored (activation checkpointing not ported)
    eval_batch_images: int = 4
    steps_per_call: int = 10  # ignored
    # max augmented views per forward pass in the test-time ensemble
    eval_views_per_pass: int = 16
    # resolution of the ensemble's warp/average; -1 = image resolution
    eval_ensemble_res: int = -1
    latent_warp: bool = False  # not yet supported ("True" raises)
    native_io: str = "auto"
    jax_cache_dir: str = "~/.cache/stablekeypoints_tpu/jax"  # ignored
    seed: int = 0
    checkpoint_every: int = 0
    resume: bool = False
    log_every: int = 10
    profile_steps: int = 0  # ignored


DATASET_PRESETS: dict[str, dict] = {
    "celeba_aligned": {"evaluation_method": "inter_eye_distance"},
    "celeba_wild": {"evaluation_method": "inter_eye_distance"},
    "cub_aligned": {"evaluation_method": "visible", "num_steps": 10_000},
    "cub_001": {"evaluation_method": "visible", "num_steps": 10_000},
    "cub_002": {"evaluation_method": "visible", "num_steps": 10_000},
    "cub_003": {"evaluation_method": "visible", "num_steps": 10_000},
    "cub_all": {"evaluation_method": "visible", "num_steps": 10_000},
    "deepfashion": {"evaluation_method": "pck", "num_steps": 10_000},
    "taichi": {"evaluation_method": "mean_average_error", "num_steps": 10_000},
    "human3.6m": {"evaluation_method": "orientation_invariant"},
    "unaligned_human3.6m": {"evaluation_method": "orientation_invariant"},
    "custom": {},
}


def apply_preset(cfg: Config) -> Config:
    """Fill dataset-appropriate defaults the user did not override."""
    preset = DATASET_PRESETS.get(cfg.dataset_name, {})
    defaults = Config()
    updates = {
        k: v for k, v in preset.items() if getattr(cfg, k) == getattr(defaults, k)
    }
    return dataclasses.replace(cfg, **updates)
