"""Framework configuration of the PyTorch port.

A copy of the JAX package's `Config` with the same field names and
defaults, so one configuration reads the same on both sides. The port
keeps its own copy: it imports nothing from the JAX package.

`jax_cache_dir`, which only steered XLA, is accepted and ignored, so a
configuration written for the JAX package still constructs here.
`data_parallel` is the number of data-parallel ranks (`parallel/mesh.py`:
one process a GPU under torchrun; -1 takes the launch's world size, any
other value must equal it), and `native_io` routes JPEG decoding through
the native decoder (`data/base.py`). The training knobs mean what they
mean there: `steps_per_call` cache-hit steps run as one call (on CUDA one
captured step replayed per step, `Runtime.train_step_scan`), `remat`
(auto|on|off) recomputes the UNet transformers' activations in the
backward (auto by the JAX package's rule, `runtime.remat_for`),
`capture_fp32_bwd` keeps the capture backward's dsim in fp32 through its
products (the JAX package's `precise` kernel path; the CUDA kernel takes it
as two bf16 halves), and `profile_steps` traces that many steps after the
first with torch.profiler.

The kernel flags take auto|on|off as in the JAX package, and any other
value raises. On the port "auto" and "on" are one setting: each wrapper
launches its kernel for CUDA tensors and runs its plain version for CPU
tensors. So `fused_gn_conv="auto"` runs the VAE resnets' GroupNorm + SiLU +
3x3 convs as K7, as the JAX package does on its accelerator.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["Config", "DATASET_PRESETS", "apply_preset"]


@dataclasses.dataclass
class Config:
    # network / checkpoint
    model_type: str = "sd-legacy/stable-diffusion-v1-5"
    model_path: Optional[str] = None  # diffusers-layout dir (unet/, vae/); None: random weights
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
    data_parallel: int = -1  # data-parallel ranks; -1: the launch's processes
    truncate_unet: bool = True  # stop the forward after the last captured map
    # auto|on|off for each hand-written kernel (auto and on alike, see the
    # module note); off takes the plain PyTorch layer code instead
    pallas_capture: str = "auto"  # K1 / K2 capture kernels
    capture_fp32_bwd: bool = False  # fp32 dsim through the capture backward's products
    capture_dtype: str = "fp32"  # fp32|bf16 dtype of the captured maps
    flash_attention: str = "auto"  # K3/K4/K5 attention kernels
    fused_groupnorm: str = "auto"  # K6 VAE GroupNorm kernel
    fused_gn_conv: str = "auto"  # K7 VAE GroupNorm + SiLU + 3x3 conv kernel
    remat: str = "auto"  # auto|on|off: recompute the transformers in the backward
    eval_batch_images: int = 4
    steps_per_call: int = 10  # cache-hit steps per call (one graph replayed per step)
    # max augmented views per forward pass in the test-time ensemble
    eval_views_per_pass: int = 16
    # resolution of the ensemble's warp/average; -1 = image resolution
    eval_ensemble_res: int = -1
    # warp the cached latent instead of encoding each warped view (an
    # approximation; black-image-latent fill)
    latent_warp: bool = False
    native_io: str = "auto"
    jax_cache_dir: str = "~/.cache/stablekeypoints_tpu/jax"  # ignored
    seed: int = 0
    checkpoint_every: int = 0
    resume: bool = False
    log_every: int = 10
    profile_steps: int = 0  # steps to trace after the first (save_folder/profile)


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
