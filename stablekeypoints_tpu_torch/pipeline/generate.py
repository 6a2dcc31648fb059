"""Image generation with a learned embedding (the JAX package's
`pipeline/generate.py`; reference generate_image.py and
ptp_utils.text2image_ldm_stable).

DDIM over the runtime's schedule with the full (untruncated) UNet,
conditioned on the learned context; classifier-free guidance when
`guidance_scale != 1` (two forwards a step, as the learned context's token
count differs from the unconditional one's); optionally the final step's
token maps; then `VAE.decode` and clip(x / 2 + 0.5). The initial latents
come from the caller (`latents=`) or from a `torch.Generator`, which
cannot reproduce `jax.random`.

    python -m stablekeypoints_tpu_torch.pipeline.generate --save_folder OUT \
        [--model_path DIR] [--num_images N] [--guidance_scale S] [--device cpu]
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from stablekeypoints_tpu_torch.pipeline.runtime import Runtime, collect_maps

__all__ = ["generate_images", "main", "v_to_eps"]


def v_to_eps(v, lat, alpha_t):
    """A v-prediction model output -> epsilon at timestep t. With
    lat = sqrt(a) x0 + sqrt(1-a) eps and v = sqrt(a) eps - sqrt(1-a) x0,
    sqrt(a) v + sqrt(1-a) lat = eps exactly."""
    alpha_t = torch.as_tensor(alpha_t, dtype=torch.float32)
    return torch.sqrt(alpha_t) * v + torch.sqrt(1.0 - alpha_t) * lat


@torch.inference_mode()
def generate_images(runtime: Runtime, context, num_images: int = 1,
                    generator: Optional[torch.Generator] = None, latent_hw: Optional[int] = None,
                    capture_final_maps: bool = False, guidance_scale: float = 1.0,
                    uncond_context=None, latents=None):
    """-> (images [N, 8h, 8w, 3] in [0, 1], maps [N, T, R, R] or None), numpy
    fp32. `context` [1, T, d]; `uncond_context` defaults to zeros
    [1, 77, d] (pass a CLIP("") embedding for checkpoint-faithful guidance);
    at guidance 1.0 the unconditional forward is skipped (the reference's
    executed low_resource path). `latents` [N, h, w, 4] replaces the
    initial noise, else it is drawn from `generator` (default: seeded
    cfg.seed + 8 on the runtime's device)."""
    cfg = runtime.cfg
    sched = runtime.schedule
    dev = runtime.device
    unet = runtime.unet
    context = torch.as_tensor(context, dtype=torch.float32).to(dev)
    if latents is None:
        hw = latent_hw if latent_hw is not None else cfg.image_size // 8
        gen = generator or torch.Generator(device=dev).manual_seed(cfg.seed + 8)
        latents = torch.randn((num_images, hw, hw, unet.config.in_channels), generator=gen,
                              dtype=torch.float32, device=gen.device)
    latents = torch.as_tensor(latents, dtype=torch.float32).to(dev)
    n = latents.shape[0]
    ctx = context.expand(n, *context.shape[1:])
    # SDXL: conditioned on the generated size (None for the other backbones)
    added = runtime.added_cond(n, target_size=latents.shape[1] * 8)
    if guidance_scale != 1.0:
        if uncond_context is None:
            uncond_context = torch.zeros((1, 77, context.shape[-1]))
        uncond = torch.as_tensor(uncond_context, dtype=torch.float32).to(dev)
        uctx = uncond.expand(n, *uncond.shape[1:])

    for i, t in enumerate(sched.timesteps):
        ts = torch.full((n,), int(t), dtype=torch.int32, device=dev)
        eps, _ = unet(latents, ts, ctx, added_cond=added)
        if guidance_scale != 1.0:
            eps_u, _ = unet(latents, ts, uctx, added_cond=added)
            eps = eps_u + guidance_scale * (eps - eps_u)
        if unet.config.prediction_type == "v_prediction":
            # guidance combines model outputs, then the combined v converts
            eps = v_to_eps(eps, latents, np.float32(sched.alphas_cumprod[int(t)]))
        latents = sched.ddim_step(eps, latents, i)

    maps = None
    if capture_final_maps:
        ts = torch.full((n,), int(sched.timesteps[-1]), dtype=torch.int32, device=dev)
        _, captures = unet(latents, ts, ctx, capture_res=cfg.feature_upsample_res, truncate=True,
                           added_cond=added)
        maps = collect_maps(captures, cfg.layers, -1, None).cpu().numpy()
    images = torch.clamp(runtime.vae.decode(latents) / 2.0 + 0.5, 0.0, 1.0)
    return images.cpu().numpy(), maps


def main(argv=None):
    """Load the learned embedding from --save_folder and save
    `generated_{i:03d}.png` there (generate_image.py parity)."""
    import argparse
    import os

    from PIL import Image

    from stablekeypoints_tpu_torch.config import Config
    from stablekeypoints_tpu_torch.utils.artifacts import load_artifact

    p = argparse.ArgumentParser(description="generate images with a learned embedding")
    p.add_argument("--save_folder", type=str, default="outputs")
    p.add_argument("--model_type", type=str, default=Config.model_type)
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--num_images", type=int, default=1)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--guidance_scale", type=float, default=1.0,
                   help="classifier-free guidance scale; 1.0 = text-only "
                        "(the reference's executed low_resource=True path)")
    p.add_argument("--uncond_path", type=str, default=None,
                   help="optional .npy/.pt embedding for the guidance's unconditional branch "
                        "(e.g. a saved CLIP('') encoding); default zeros")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the GPU (raises without one)")
    args = p.parse_args(argv)

    embedding = load_artifact(args.save_folder, "embedding")
    uncond = None
    if args.uncond_path:
        d, f = os.path.split(args.uncond_path)
        uncond = load_artifact(d or ".", os.path.splitext(f)[0])
    cfg = Config(model_type=args.model_type, model_path=args.model_path,
                 image_size=args.image_size, num_tokens=embedding.shape[1], seed=args.seed)
    runtime = Runtime.create(cfg, device=args.device)
    images, _ = generate_images(runtime, embedding, args.num_images,
                                guidance_scale=args.guidance_scale, uncond_context=uncond)
    for i, img in enumerate(images):
        out = os.path.join(args.save_folder, f"generated_{i:03d}.png")
        Image.fromarray((img * 255).astype(np.uint8)).save(out)
        print(f"saved {out}")
    return images


if __name__ == "__main__":
    main()
