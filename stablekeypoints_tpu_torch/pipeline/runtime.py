"""SD keypoint runtime: frozen models, the stage-1 training step, the
stage-2 token selection and detection.

Holds the UNet, the VAE encoder and the DDIM schedule on one device and
runs the computations of the JAX package's `Runtime`:

- training (`_train_step`): one merged forward over [originals; warped]
  images (VAE encode, DDIM noise at the least-noisy timestep, the truncated
  UNet capturing four up-path attention maps), per-image token selection,
  sharpening + equivariance losses, the gradient w.r.t. the context only
  and an Adam step (`torch.optim.Adam` with optax.adam's constants,
  capturable on CUDA); `train_step_scan` runs K cached steps as one CUDA
  graph of one step replayed K times (the JAX package's `lax.scan` of
  `steps_per_call` steps);
- token selection (`select_indices`, JAX `select_indices_fn`): one
  capture forward at the capture grid, then per image the candidate
  ranking and furthest-point sampling, for stage 2's vote
  (`pipeline/indices.py`);
- detection (`_ensembled_maps` / `_ensembled_keypoints`): for each image,
  `augmentation_iterations` random affine views go through one batched
  forward, the maps are inverse-warped and averaged where some view
  covered the pixel, and the argmax gives the keypoints.

With `cfg.latent_warp` (an approximation the JAX package gates behind the
same flag) the warped views are not encoded: the original image's latent
is warped with the same theta, out-of-frame latent pixels filled with the
latent of a black image (`black_latent`). Weights come from a diffusers
checkpoint directory (`cfg.model_path`) or from the seed.

Under a mesh with a 'model' axis (`make_mesh(n_data, n_model)`) the UNet
is built for the rank's model axis and holds its Megatron slice
(`parallel/tensor.py`); the VAE stays whole on every rank. The model ranks
of a data coordinate run the same rows, and the UNet's all-reduces over
their model group complete each split block.

`torch.Generator` cannot reproduce `jax.random`, so the random inputs
(affine thetas and latent noise) are injectable: callers that hold both
sides to one another pass the same values to each.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.distributed as dist
from torch.profiler import record_function

from stablekeypoints_tpu_torch.config import Config
from stablekeypoints_tpu_torch.models.scheduler import DDIMSchedule
from stablekeypoints_tpu_torch.models.unet import (
    SD15_CONFIG,
    SD21_CONFIG,
    SDXL_CONFIG,
    UNet,
    UNetConfig,
)
from stablekeypoints_tpu_torch.models.vae import SD_VAE_CONFIG, SDXL_VAE_CONFIG, VAE, VAEConfig
from stablekeypoints_tpu_torch.models.weights import (
    cast_module,
    copy_state,
    init_random,
    load_unet_state,
    load_vae_state,
)
from stablekeypoints_tpu_torch.ops.keypoints import find_max_pixel, pixel_from_weighted_avg
from stablekeypoints_tpu_torch.ops.losses import equivariance_loss, sharpening_loss
from stablekeypoints_tpu_torch.ops.resize import resize_hw
from stablekeypoints_tpu_torch.ops.selection import furthest_point_sampling, select_candidates
from stablekeypoints_tpu_torch.ops.transforms import (
    AffineParams,
    apply_affine,
    apply_affine_fill,
    apply_inverse_affine,
    sample_thetas,
)
from stablekeypoints_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_mean,
    check_divides,
    gather_rows,
    make_mesh,
    replicate,
    resolve_device,
)
from stablekeypoints_tpu_torch.parallel.tensor import (
    full_unet_shapes,
    shard_unet_state,
    split_plan,
    take_slice,
)

__all__ = ["Runtime", "StepGraph", "collect_maps", "remat_for", "resolve_device",
           "unet_config_for_model_type", "vae_config_for_model_type"]

AUX = ("loss", "sharpening", "equivariance")  # a training step's aux, in stacking order


def _check_kernel_flags(cfg: Config) -> None:
    """Kernel flags take auto|on|off; "auto" and "on" are one setting on the
    port (the wrappers pick the kernel for CUDA tensors, the plain version
    for CPU tensors)."""
    for flag in ("pallas_capture", "flash_attention", "fused_groupnorm", "fused_gn_conv"):
        if getattr(cfg, flag) not in ("auto", "on", "off"):
            raise ValueError(f"{flag}={getattr(cfg, flag)!r}: expected 'auto', 'on' or 'off'")


def remat_for(cfg: Config, n_data: int = 1) -> bool:
    """Whether the UNet's transformers recompute their activations in the
    backward: `cfg.remat` "on" or "off" as given; "auto" by the JAX
    package's rule, on when a rank's share of the merged batch [originals;
    warped], ceil(2B / n_data) images, scaled by the image area over 512^2,
    exceeds 8 (off for SD-1.5 512^2 batch 4 and SDXL 1024^2 batch 1; on for
    SD-2.1 768^2 batch 2 on one device, off on two)."""
    if cfg.remat not in ("auto", "on", "off"):
        raise ValueError(f"remat={cfg.remat!r}: expected 'auto', 'on' or 'off'")
    if cfg.remat != "auto":
        return cfg.remat == "on"
    return -(-2 * cfg.batch_size // n_data) * (cfg.image_size / 512) ** 2 > 8


def unet_config_for_model_type(model_type: str) -> UNetConfig:
    """The backbone of a --model_type name (the JAX package's rules): SDXL
    for a name with "xl"; SD-2.x for "diffusion-2" or "sd2" names, which
    predict v unless the name says "base" (the 768 checkpoints); else
    SD-1.x."""
    name = model_type.lower()
    if "xl" in name:
        return SDXL_CONFIG
    if "diffusion-2" in name or name.startswith("sd2"):
        if "base" in name:
            return SD21_CONFIG
        return dataclasses.replace(SD21_CONFIG, prediction_type="v_prediction")
    return SD15_CONFIG


def vae_config_for_model_type(model_type: str) -> VAEConfig:
    """SDXL's VAE scale (0.13025) for a name with "xl", else SD's."""
    return SDXL_VAE_CONFIG if "xl" in model_type.lower() else SD_VAE_CONFIG


def collect_maps(
    captures: list[torch.Tensor],
    layers: tuple[int, ...],
    upsample_res: int = -1,
    indices: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Average captured [B, R^2, T] maps over layers -> [B, T', res, res] fp32.
    Every map lives on the same R^2 grid, so mean-then-upsample equals
    upsample-then-mean; index selection commutes with both."""
    sel = [captures[i] for i in layers if i < len(captures)]
    if indices is not None:
        sel = [c[:, :, indices] for c in sel]
    maps = torch.stack(sel, dim=0).float().mean(dim=0)  # [B, R^2, T']
    b, rr, t = maps.shape
    r = int(round(rr**0.5))
    maps = maps.transpose(1, 2).reshape(b, t, r, r)
    if upsample_res != -1 and upsample_res != r:
        maps = resize_hw(maps, upsample_res, upsample_res, "bilinear")
    return maps


@dataclasses.dataclass
class Runtime:
    cfg: Config
    unet: UNet
    vae: VAE
    schedule: DDIMSchedule
    device: torch.device
    # the data-parallel world (parallel/mesh.py); None: one process, this device
    mesh: Optional[Mesh] = None
    # SDXL time_ids per (batch, size), see `added_cond`
    _time_ids: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                        compare=False)
    # the captured cached step per batch shape, see `train_step_scan`
    _step_graphs: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                           compare=False)

    def __post_init__(self):
        if self.mesh is None:
            self.mesh = Mesh(0, 1, None, self.device)

    @staticmethod
    def empty(cfg: Config, unet_config: UNetConfig, vae_config: VAEConfig, device=None,
              decoder: bool = True, mesh: Optional[Mesh] = None) -> "Runtime":
        """The models of `cfg` on `device` (a mesh's: its device), their
        memory taken once at its final size and their values not initialised:
        the caller fills them (`load_weights`). `decoder=False` leaves the
        VAE without its decoder (a detector never decodes)."""
        _check_kernel_flags(cfg)
        device = mesh.device if mesh is not None else resolve_device(device)
        use_flash = cfg.flash_attention != "off"
        unet_config = dataclasses.replace(
            unet_config,
            pallas_capture=cfg.pallas_capture != "off",
            flash_attention=use_flash,
            capture_bf16=cfg.capture_dtype == "bf16",
            capture_fp32_bwd=cfg.capture_fp32_bwd,
            remat=remat_for(cfg, mesh.n_data if mesh is not None else 1),
        )
        dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        with torch.device("meta"):
            unet = UNet(unet_config, mesh.model_axis if mesh is not None else None)
            vae = VAE(vae_config, flash=use_flash, fused_gn=cfg.fused_groupnorm != "off",
                      fused_gn_conv=cfg.fused_gn_conv != "off", decoder=decoder)
        # dtypes and layouts set on the meta device, so the device memory is
        # taken once, at its final size
        unet = cast_module(unet, dtype).to_empty(device=device)
        vae = cast_module(vae, dtype).to_empty(device=device)
        return Runtime(cfg, unet.eval(), vae.eval(), DDIMSchedule.create(), device, mesh)

    @staticmethod
    def create(
        cfg: Config,
        unet_config: Optional[UNetConfig] = None,
        vae_config: Optional[VAEConfig] = None,
        device=None,
        mesh: Optional[Mesh] = None,
    ) -> "Runtime":
        """Weights from the diffusers checkpoint directory `cfg.model_path`
        (`unet/` and `vae/`, cast to cfg.dtype on the host and copied once
        to the device; norm parameters fp32), else random from cfg.seed
        (UNet) and cfg.seed + 1 (VAE), at the configuration's full width.
        Load other weights with `load_weights`. `mesh` (default:
        `make_mesh(cfg.data_parallel, device=device)`, one process unless a
        process group runs) places the runtime on its rank's device; every
        rank makes the same weights, and under a 'model' axis keeps its
        slice of the UNet's (each parameter drawn whole, one at a time, and
        sliced, so a rank holds the one-process weights' slices)."""
        _check_kernel_flags(cfg)  # both before a checkpoint is read
        if mesh is None:
            mesh = make_mesh(cfg.data_parallel, device=device)
        elif device is not None and resolve_device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's {mesh.device}")
        if unet_config is None:
            unet_config = unet_config_for_model_type(cfg.model_type)
        if vae_config is None:
            vae_config = vae_config_for_model_type(cfg.model_type)
        states = None
        if cfg.model_path:  # read and checked before any device memory is taken
            states = (load_unet_state(cfg.model_path, unet_config),
                      load_vae_state(cfg.model_path, vae_config))
        rt = Runtime.empty(cfg, unet_config, vae_config, mesh=mesh)
        if states is None:
            axis = rt.unet.axis
            if axis is None:
                init_random(rt.unet, cfg.seed)
            else:
                plan = split_plan(unet_config, axis.size)
                init_random(rt.unet, cfg.seed, full_shapes=full_unet_shapes(unet_config),
                            take=lambda name, t: take_slice(t, plan[name], axis.rank, axis.size))
            init_random(rt.vae, cfg.seed + 1)
        else:
            rt.load_weights(*states)
        if cfg.latent_warp:
            rt.black_latent  # computed once, here
        return rt

    def load_weights(self, unet_state: dict, vae_state: dict) -> "Runtime":
        """Copy state dicts (`models.weights.load_unet_state` /
        `load_vae_state`, or `from_jax_params`) into the models, strictly,
        keeping each parameter's dtype and memory layout. The UNet's state is
        the whole model's; a rank of a 'model' axis copies its slices."""
        unet_state = shard_unet_state(unet_state, self.unet.config, self.unet.axis)
        copy_state(self.unet, unet_state)
        copy_state(self.vae, vae_state)
        self.__dict__.pop("black_latent", None)  # encoded by the old weights
        return self

    @property
    def aff(self) -> AffineParams:
        cfg = self.cfg
        return AffineParams(
            cfg.augment_degrees, tuple(cfg.augment_scale), tuple(cfg.augment_translate)
        )

    def latent_shape(self, batch: int, size: int) -> tuple[int, ...]:
        return (batch, size // 8, size // 8, self.vae.config.latent_channels)

    # ------------------------------------------------------------------
    # core computations

    @torch.no_grad()
    def _encode(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] in [0, 1] -> scaled posterior-mean latents, fp32.
        No gradient flows into the VAE (the JAX package's stop_gradient)."""
        return self.vae.encode_mean(images * 2.0 - 1.0)

    @functools.cached_property
    def black_latent(self) -> torch.Tensor:
        """Per-channel latent of a black image, [4] fp32: the centre pixel of
        encode(zeros) at cfg.image_size, constant per channel away from the
        frame's edges. The reference's image warp pads with black, so the
        latent warp fills out-of-frame latent pixels with this."""
        size = self.cfg.image_size
        lat = self._encode(torch.zeros((1, size, size, 3), device=self.device))
        return lat[0, lat.shape[1] // 2, lat.shape[2] // 2, :].clone()

    @torch.no_grad()
    def _warp_latents(self, latents: torch.Tensor, thetas: torch.Tensor) -> torch.Tensor:
        """Latent-space stand-in for encode(warp(image)) (cfg.latent_warp):
        the latent warped by the same normalized-coordinate theta, filled
        with `black_latent`."""
        return apply_affine_fill(latents, thetas, self.black_latent)

    def added_cond(self, batch: int, target_size: Optional[int] = None) -> Optional[dict]:
        """SDXL micro-conditioning, diffusers' values for an uncropped image
        of `target_size` (default cfg.image_size): time_ids = (orig_h,
        orig_w, crop_top, crop_left, target_h, target_w) = (s, s, 0, 0, s,
        s), [batch, 6] fp32; the pooled text embedding stays at its zeros
        default. None for backbones without micro-conditioning."""
        if self.unet.config.addition_emb_dim <= 0:
            return None
        s = float(target_size if target_size is not None else self.cfg.image_size)
        tid = self._time_ids.get((batch, s))
        if tid is None:  # made once per (batch, size): no host copy on later calls
            with torch.inference_mode(False):
                tid = torch.tensor([[s, s, 0.0, 0.0, s, s]], dtype=torch.float32,
                                   device=self.device).expand(batch, 6)
            self._time_ids[(batch, s)] = tid
        return {"time_ids": tid}

    def _attn_maps(self, images, context, noise, upsample_res: int,
                   indices: Optional[torch.Tensor], truncate: bool = True,
                   latents: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One capture forward: [B, H, W, 3] -> [B, k, res, res] fp32 maps;
        `latents` [B, h, w, 4] skips the encode."""
        cfg = self.cfg
        if latents is None:
            latents = self._encode(images)
        t = self.schedule.timestep_at(cfg.noise_level)
        noisy = self.schedule.add_noise(latents, noise, t)
        b = images.shape[0]
        ts = torch.full((b,), t, dtype=torch.int32, device=self.device)
        ctx = context.expand(b, *context.shape[1:])
        _, captures = self.unet(
            noisy, ts, ctx, capture_res=cfg.feature_upsample_res, truncate=truncate,
            added_cond=self.added_cond(b),
        )
        return collect_maps(captures, cfg.layers, upsample_res, indices)

    def _per_sample_losses(self, maps, maps_t, theta):
        """Token selection and the two losses for one image: maps, maps_t
        [T, R, R] of the original and the warped image, theta [2, 3]."""
        cfg = self.cfg
        cands = select_candidates(maps.detach(), cfg.top_k_strategy,
                                  cfg.furthest_point_num_samples, sigma=cfg.sigma,
                                  num_subjects=cfg.num_subjects)
        idx = furthest_point_sampling(maps_t.detach(), cfg.top_k, cands)
        sl = sharpening_loss(maps[idx], sigma=cfg.sigma, num_subjects=cfg.num_subjects)
        el = equivariance_loss(maps[idx], maps_t[idx], theta)
        return sl, el

    def _train_step(self, context, optimizer, images, thetas=None, noise=None,
                    generator: Optional[torch.Generator] = None, latents_orig=None):
        """One optimization step; returns (context, optimizer, aux, latents of
        the originals). `context` [1, T, d] fp32 is the optimizer's parameter
        and is updated in place; its `.grad` holds this step's gradient.

        thetas [B, 2, 3] and noise [2B, h, w, 4] are drawn from `generator`
        (thetas first) when not given. latents_orig [b, h, w, 4]: cached
        latents of the original images; the warped images are always
        encoded. One merged forward over [originals; warped].

        images, thetas and noise are the global batch; under a data-parallel
        mesh each rank takes its rows of them, and `latents_orig` and the
        returned latents are the rank's rows (b = B / n_data). The rank's
        gradient and aux are averaged over the ranks by one all-reduce
        before the optimizer's step, so each rank's step is the one-process
        step of the global batch. Under a 'model' axis a rank's context
        gradient is its model group's part: the all-reduce takes n_model
        times it, so that the mean over the world is the sum over the model
        ranks averaged over the data coordinates."""
        cfg = self.cfg
        mesh = self.mesh
        if optimizer.param_groups[0]["params"][0] is not context:
            raise ValueError("the optimizer must hold `context` as its parameter")
        # named host ranges for torch.profiler (chip_smoke's step profile)
        with record_function("train_step.encode"):
            images = torch.as_tensor(images, dtype=torch.float32)
            n = images.shape[0]
            check_divides(mesh, n, "a training batch")
            if thetas is None:
                thetas = sample_thetas(generator, n, self.aff)
            if noise is None:
                noise = torch.randn(
                    (2 * n, *self.latent_shape(1, images.shape[1])[1:]), generator=generator,
                    dtype=torch.float32,
                    device=generator.device if generator is not None else self.device,
                )
            rows = mesh.rows(n)
            images = images[rows].to(self.device)
            thetas = thetas[rows].to(self.device, torch.float32)
            noise = noise.to(self.device, torch.float32)
            noise = torch.cat([noise[rows], noise[n + rows.start:n + rows.stop]])
            b = images.shape[0]
            if latents_orig is not None:
                latents_orig = torch.as_tensor(latents_orig, dtype=torch.float32).to(self.device)
            if cfg.latent_warp:
                # no encode of the warped images: the originals' latents
                # (encoded here on a cache miss) are warped instead
                if latents_orig is None:
                    latents_orig = self._encode(images)
                latents = torch.cat([latents_orig, self._warp_latents(latents_orig, thetas)])
                both = torch.cat([images, images], dim=0)  # only its batch size is read
            else:
                images_t = apply_affine(images, thetas)
                both = torch.cat([images, images_t], dim=0)
                if latents_orig is None:
                    latents = self._encode(both)
                else:
                    latents = torch.cat([latents_orig, self._encode(images_t)], dim=0)

        optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            with record_function("train_step.unet"):
                maps_all = self._attn_maps(both, context, noise, -1, None, cfg.truncate_unet,
                                           latents=latents)
            with record_function("train_step.losses"):
                maps, maps_t = maps_all[:b], maps_all[b:]
                per_image = [self._per_sample_losses(maps[i], maps_t[i], thetas[i])
                             for i in range(b)]
                sl = torch.stack([p[0] for p in per_image]).mean()
                el = torch.stack([p[1] for p in per_image]).mean()
                loss = sl * cfg.sharpening_loss_weight + el * cfg.equivariance_attn_loss_weight
            with record_function("train_step.backward"):
                loss.backward()
        aux = [loss, sl, el]
        if mesh.group is not None:
            with record_function("train_step.all_reduce"):
                grad = context.grad if mesh.n_model == 1 else context.grad * mesh.n_model
                context.grad, *aux = all_reduce_mean(mesh, [grad, *aux])
        with record_function("train_step.adam"):
            optimizer.step()
        return context, optimizer, dict(zip(AUX, (a.detach() for a in aux))), latents[:b]

    # ------------------------------------------------------------------
    # training entry points (thetas=, noise=, generator= as in _train_step)

    def optimizer(self, context: torch.Tensor) -> torch.optim.Adam:
        """Adam over the context, with optax.adam's constants: betas (0.9,
        0.999), eps 1e-8 added to the bias-corrected root, no weight decay.
        Capturable on CUDA (its step count a device tensor, so that a CUDA
        graph can hold the update); torch refuses that for CPU tensors."""
        return torch.optim.Adam([context], lr=self.cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=0.0, capturable=context.device.type == "cuda")

    def train_context(self, context=None) -> torch.Tensor:
        """A trainable copy of `context` (default: `init_context()`) on the
        runtime's device: fp32 leaf tensor that requires grad."""
        context = self.init_context() if context is None else context
        return torch.as_tensor(context, dtype=torch.float32).to(self.device).detach().clone().requires_grad_()

    def train_step(self, context, optimizer, images, **random):
        """(context, optimizer, images [B, H, W, 3]) -> (context, optimizer, aux)."""
        return self._train_step(context, optimizer, images, **random)[:3]

    def train_step_fill(self, context, optimizer, images, **random):
        """As train_step, and also the original images' latents [B, h, w, 4]
        for the training loop's cache."""
        return self._train_step(context, optimizer, images, **random)

    def train_step_cached(self, context, optimizer, latents, images, **random):
        """As train_step, with the original images' latents given (no encode
        of the originals)."""
        return self._train_step(context, optimizer, images, latents_orig=latents, **random)[:3]

    def train_step_scan(self, context, optimizer, latents, images, thetas=None, noise=None,
                        generator: Optional[torch.Generator] = None):
        """K cached steps in one call (the JAX package's `lax.scan` over
        `steps_per_call` steps): (context, optimizer, latents [K, b, h, w, 4],
        images [K, B, H, W, 3]) -> (context, optimizer, aux with each value
        stacked over the K steps). Its math is K `train_step_cached` calls:
        images, thetas and noise are global batches, latents the rank's rows
        (b = B / n_data), and each step all-reduces as `_train_step` does.

        thetas [K, B, 2, 3] and noise [K, 2B, h, w, 4] are drawn from
        `generator` when not given, before the first step and in the order
        K per-step calls draw them (thetas, then noise, for each step), so
        the group sees the draws of K `train_step_cached` calls from the
        same generator state. The group's inputs are copied to the device
        once.

        On the CPU the steps run one after another. On CUDA one cached step
        is captured as a CUDA graph at the first call for its batch shape
        (`StepGraph`: the first step of that call runs eagerly on a side
        stream as the warm-up, the capture follows) and replayed once a
        step: each step's inputs are copied device to device into the
        graph's static buffers and its aux into a [K] stack, which the
        caller reads once. A capture that fails raises; nothing falls back
        to eager steps. Under an NCCL mesh the all-reduces (the step's, and
        a 'model' axis's over its model group) are inside the graph (every
        rank warms up and captures in the same order); gloo cannot be
        captured, so a group on CUDA tensors under gloo raises."""
        latents = torch.as_tensor(latents, dtype=torch.float32).to(self.device)
        images = torch.as_tensor(images, dtype=torch.float32).to(self.device)
        k, b = images.shape[:2]
        check_divides(self.mesh, b, "a training batch")
        drawn_t, drawn_n = [], []
        for _ in range(k):  # the per-step order of the draws
            if thetas is None:
                drawn_t.append(sample_thetas(generator, b, self.aff))
            if noise is None:
                drawn_n.append(torch.randn(
                    (2 * b, *latents.shape[2:]), generator=generator, dtype=torch.float32,
                    device=generator.device if generator is not None else self.device,
                ))
        thetas = torch.stack(drawn_t) if thetas is None else torch.as_tensor(thetas)
        noise = torch.stack(drawn_n) if noise is None else torch.as_tensor(noise)
        thetas = thetas.to(self.device, torch.float32)
        noise = noise.to(self.device, torch.float32)
        inputs = [dict(images=images[j], thetas=thetas[j], noise=noise[j], latents=latents[j])
                  for j in range(k)]
        if self.device.type != "cuda":
            auxes = [self._train_step(context, optimizer, x["images"], thetas=x["thetas"],
                                      noise=x["noise"], latents_orig=x["latents"])[2]
                     for x in inputs]
            return context, optimizer, {n: torch.stack([a[n] for a in auxes]) for n in AUX}
        if self.mesh.group is not None and dist.get_backend(self.mesh.group) != "nccl":
            raise RuntimeError(
                f"steps_per_call groups on CUDA capture the all-reduce in a CUDA graph, which "
                f"the {dist.get_backend(self.mesh.group)} backend cannot be; use NCCL or "
                f"steps_per_call=1"
            )
        stack = torch.empty((k, len(AUX)), dtype=torch.float32, device=self.device)
        graph = self._step_graph(context, optimizer, inputs[0])
        first = 0
        if graph.graph is None:  # step 0 is the warm-up
            stack[0].copy_(graph.warm_up(inputs[0]))
            graph.capture()
            first = 1
        for j in range(first, k):
            graph.replay(inputs[j])
            stack[j].copy_(graph.aux)
        return context, optimizer, {n: stack[:, i] for i, n in enumerate(AUX)}

    def _step_graph(self, context, optimizer, example: dict) -> "StepGraph":
        """The captured cached step for `example`'s shapes (a fresh, not yet
        captured one the first time, or when the context or the optimizer's
        state are other tensors than at its capture)."""
        key = tuple(tuple(example[n].shape) for n in StepGraph.INPUTS)
        graph = self._step_graphs.get(key)
        if graph is None or graph.state_ptrs != StepGraph.state_of(context, optimizer):
            graph = self._step_graphs[key] = StepGraph(self, context, optimizer, example)
        return graph

    def views_per_pass(self, views: int) -> int:
        """Largest divisor of `views` that is <= eval_views_per_pass."""
        top = min(self.cfg.eval_views_per_pass, views)
        return next(c for c in range(top, 0, -1) if views % c == 0)

    def _ensembled_maps(self, context, images, indices, thetas=None, noise=None,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """images [M, H, W, 3] -> ensembled maps [M, k, H, W] fp32.

        thetas [M*n, 2, 3] and noise [M*n, H/8, W/8, 4] (n views per image,
        image-major) are drawn from `generator` when not given; views go
        through the models `views_per_pass` at a time."""
        cfg = self.cfg
        m, size = images.shape[0], images.shape[1]
        n = cfg.augmentation_iterations
        v = m * n
        ens = size if cfg.eval_ensemble_res == -1 else min(cfg.eval_ensemble_res, size)
        thetas, noise = self._view_draws(v, size, thetas, noise, generator)
        if cfg.latent_warp:
            # one encode per image, its latent warped per view
            view_latents = self._warp_latents(
                self._encode(images).repeat_interleave(n, dim=0), thetas)
            imgs_t = images.repeat_interleave(n, dim=0)  # only its batch size is read
        else:
            view_latents = None
            imgs_t = apply_affine(images.repeat_interleave(n, dim=0), thetas)
        chunk = self.views_per_pass(v)
        warped = []
        for c0 in range(0, v, chunk):
            sl = slice(c0, c0 + chunk)
            maps = self._attn_maps(imgs_t[sl], context, noise[sl], ens, indices,
                                   latents=None if view_latents is None else view_latents[sl])
            ones = torch.ones((maps.shape[0], 1, ens, ens), dtype=maps.dtype, device=maps.device)
            stacked = torch.cat([maps, ones], dim=1).permute(0, 2, 3, 1)
            warped.append(apply_inverse_affine(stacked, thetas[sl]).permute(0, 3, 1, 2))
        warped = torch.cat(warped, dim=0)
        kk = warped.shape[1] - 1
        warped = warped.reshape(m, n, kk + 1, ens, ens).sum(dim=1)
        avg = torch.nan_to_num(warped[:, :kk] / warped[:, kk:], nan=0.0, posinf=0.0, neginf=0.0)
        if ens != size:
            avg = resize_hw(avg.reshape(m * kk, ens, ens), size, size, "bilinear").reshape(
                m, kk, size, size
            )
        return avg

    def _view_draws(self, v: int, size: int, thetas, noise, generator):
        """The thetas [v, 2, 3] and then the noise [v, size/8, size/8, 4] of v
        views, drawn from `generator` where not given, on the device."""
        if thetas is None:
            thetas = sample_thetas(generator, v, self.aff)
        if noise is None:
            noise = torch.randn(
                self.latent_shape(v, size), generator=generator, dtype=torch.float32,
                device=generator.device if generator is not None else self.device,
            )
        return thetas.to(self.device, torch.float32), noise.to(self.device, torch.float32)

    def _ensembled_keypoints(self, context, images, indices, **random) -> torch.Tensor:
        """Ensembled maps reduced to [M, k, 2] normalized (y, x)."""
        avg = self._ensembled_maps(context, images, indices, **random)
        m, kk, size = avg.shape[0], avg.shape[1], avg.shape[2]
        flat = avg.reshape(m * kk, size, size)
        if self.cfg.max_loc_strategy == "argmax":
            pts = find_max_pixel(flat)
        else:
            pts = pixel_from_weighted_avg(flat)
        return pts.reshape(m, kk, 2) / size

    # ------------------------------------------------------------------
    # stage 2

    @torch.inference_mode()
    def select_indices(self, context, images, noise=None,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Per-image token selection for the stage-2 vote (JAX
        `select_indices_fn`): (context [1, T, d], images [B, H, W, 3] in
        [0, 1]) -> [B, top_k] int64 token indices. noise [B, H/8, W/8, 4] is
        drawn from `generator` when not given. Under a data-parallel mesh
        each rank selects for its rows (B must divide over the ranks) and
        the selections are gathered in rank order."""
        cfg = self.cfg
        context = torch.as_tensor(context, dtype=torch.float32).to(self.device)
        images = torch.as_tensor(images, dtype=torch.float32)
        b, size = images.shape[0], images.shape[1]
        check_divides(self.mesh, b, "a vote batch")
        if noise is None:
            noise = torch.randn(
                self.latent_shape(b, size), generator=generator, dtype=torch.float32,
                device=generator.device if generator is not None else self.device,
            )
        rows = self.mesh.rows(b)
        noise = torch.as_tensor(noise, dtype=torch.float32)[rows].to(self.device)
        maps = self._attn_maps(images[rows].to(self.device), context, noise,
                               cfg.feature_upsample_res, None, True)
        selected = []
        for m in maps:
            cands = select_candidates(m, cfg.top_k_strategy, cfg.furthest_point_num_samples,
                                      sigma=cfg.sigma, num_subjects=cfg.num_subjects)
            selected.append(furthest_point_sampling(m, cfg.top_k, cands))
        return gather_rows(self.mesh, torch.stack(selected), b)

    # ------------------------------------------------------------------
    # detection entry points

    def _inputs(self, context, images, indices):
        context = torch.as_tensor(context, dtype=torch.float32).to(self.device)
        images = torch.as_tensor(images, dtype=torch.float32).to(self.device)
        indices = torch.as_tensor(indices, dtype=torch.long).to(self.device)
        return context, images, indices

    @torch.inference_mode()
    def augmented_keypoints(self, context, images, indices, thetas=None, noise=None,
                            generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(context [1, T, d], images [M, H, W, 3] in [0, 1], indices [k])
        -> [M, k, 2] normalized (y, x). Optional thetas=, noise=,
        generator= as in `_ensembled_maps`. Under a data-parallel mesh the
        views of all M images are drawn on every rank, each rank runs the
        ensemble of its rows (ceil(M / world) a rank: M need not divide),
        and the keypoints are gathered in rank order."""
        context, images, indices = self._inputs(context, images, indices)
        m, size = images.shape[0], images.shape[1]
        n = self.cfg.augmentation_iterations
        thetas, noise = self._view_draws(m * n, size, thetas, noise, generator)
        rows = self.mesh.rows(m)
        if rows.stop > rows.start:
            views = slice(rows.start * n, rows.stop * n)
            pts = self._ensembled_keypoints(context, images[rows], indices, thetas=thetas[views],
                                            noise=noise[views])
        else:  # more ranks than images: this rank has none
            pts = torch.zeros((0, indices.shape[0], 2), device=self.device)
        return gather_rows(self.mesh, pts, m)

    @torch.inference_mode()
    def augmented_maps(self, context, image, indices, **random) -> torch.Tensor:
        """(context, image [H, W, 3], indices [k]) -> [k, H, W] fp32 maps."""
        context, image, indices = self._inputs(context, image, indices)
        return self._ensembled_maps(context, image[None], indices, **random)[0]

    def init_context(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Random context [1, num_tokens, context_dim] fp32."""
        gen = generator or torch.Generator().manual_seed(self.cfg.seed)
        ctx = torch.randn(
            (1, self.cfg.num_tokens, self.unet.config.context_dim), generator=gen,
            dtype=torch.float32,
        ).to(self.device)
        replicate(self.mesh, [ctx])  # rank 0's, as the JAX package replicates it
        return ctx


class StepGraph:
    """One cached training step as a CUDA graph, after torch's
    whole-network capture pattern: static input buffers, one eager step on
    a side stream (builds, plans and cached constants, the Adam state),
    gradients set to None, then the capture of `Runtime._train_step` over
    the buffers; Adam is capturable, so its update is in the graph. No
    host copy and no random draw happens inside the step once its inputs
    are on the device."""

    INPUTS = ("images", "thetas", "noise", "latents")

    def __init__(self, rt: Runtime, context: torch.Tensor, optimizer, example: dict):
        self.rt, self.context, self.optimizer = rt, context, optimizer
        self.inputs = {n: torch.empty_like(example[n]) for n in self.INPUTS}
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.aux: Optional[torch.Tensor] = None  # [len(AUX)], the graph's output
        self.grad: Optional[torch.Tensor] = None
        self.state_ptrs = None

    @staticmethod
    def state_of(context, optimizer) -> tuple:
        """The addresses the graph reads and writes: the context and the
        optimizer's state tensors."""
        state = optimizer.state.get(context, {})
        return (context.data_ptr(),) + tuple(
            (n, v.data_ptr()) for n, v in sorted(state.items()) if torch.is_tensor(v))

    def _step(self) -> torch.Tensor:
        x = self.inputs
        aux = self.rt._train_step(self.context, self.optimizer, x["images"], thetas=x["thetas"],
                                  noise=x["noise"], latents_orig=x["latents"])[2]
        return torch.stack([aux[n] for n in AUX])

    def _load(self, values: dict) -> None:
        for n in self.INPUTS:
            self.inputs[n].copy_(values[n])

    def warm_up(self, values: dict) -> torch.Tensor:
        """One eager step on `values` on a side stream; returns its aux."""
        self._load(values)
        main = torch.cuda.current_stream(self.rt.device)
        side = torch.cuda.Stream(self.rt.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            aux = self._step()
        main.wait_stream(side)
        return aux

    def capture(self) -> None:
        """Record one step over the static buffers."""
        self.optimizer.zero_grad(set_to_none=True)  # the graph allocates its own gradient
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.aux = self._step()
        self.graph, self.grad = graph, self.context.grad
        self.state_ptrs = self.state_of(self.context, self.optimizer)

    def replay(self, values: dict) -> None:
        """Copy `values` into the static buffers and run the step."""
        self._load(values)
        self.graph.replay()
        self.context.grad = self.grad  # this step's gradient, as after an eager step
