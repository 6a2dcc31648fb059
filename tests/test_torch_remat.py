"""`remat` in the port (activation checkpointing of the UNet's
transformers, the JAX package's `nn.remat`).

- The decision: `remat_for` and the UNet a Runtime builds agree with the
  JAX Runtime's over the grid of its auto rule's test
  (tests/test_train_step.py: batch x image size), and `on` / `off` are
  taken as given.
- A tiny training step with remat on computes what it computes with remat
  off: the same captured maps (the recompute adds none), the same loss and
  the same context gradient (rtol 1e-6: the recompute runs the same ops on
  the same inputs), with remat_resnets too.
"""

import torch_threads  # noqa: F401  (torch's threads: this xdist worker's share)
import dataclasses
import functools

import numpy as np
import pytest
import torch

from stablekeypoints_tpu_torch.config import Config
from stablekeypoints_tpu_torch.models.unet import tiny_unet_config
from stablekeypoints_tpu_torch.models.vae import tiny_vae_config
from stablekeypoints_tpu_torch.pipeline.runtime import Runtime, remat_for

SIZE = dict(image_size=64, num_tokens=16, feature_upsample_res=16, top_k=4,
            furthest_point_num_samples=8, batch_size=2, dtype="float32")


@pytest.mark.parametrize("batch,size,remat", [
    (4, 512, "auto"),   # SD-1.5's training shape: 8 units, kept
    (1, 1024, "auto"),  # SDXL's: 8 units, kept
    (2, 1024, "auto"),  # 16 units: recomputed
    (16, 512, "auto"),  # 32 units: recomputed
    (16, 512, "off"),
    (1, 512, "on"),
])
def test_remat_decision_equals_jax(batch, size, remat):
    from stablekeypoints_tpu.config import Config as JaxConfig
    from stablekeypoints_tpu.models.unet import tiny_unet_config as jax_tiny_unet
    from stablekeypoints_tpu.models.vae import tiny_vae_config as jax_tiny_vae
    from stablekeypoints_tpu.pipeline.runtime import Runtime as JaxRuntime

    kw = dict(dataset_name="synthetic", batch_size=batch, image_size=size, remat=remat)
    want = JaxRuntime.create(JaxConfig(data_parallel=1, jax_cache_dir="", **kw),
                             jax_tiny_unet(), jax_tiny_vae()).unet.config.remat
    assert remat_for(Config(**kw)) is want
    rt = Runtime.empty(Config(**kw), tiny_unet_config(), tiny_vae_config(), device="cpu")
    assert rt.unet.config.remat is want
    assert all(block.cfg.remat is want for name, block in rt.unet.named_children()
               if name.startswith(("down_", "up_", "mid")))


def test_remat_rejects_unknown_values():
    with pytest.raises(ValueError, match="remat"):
        remat_for(Config(remat="sometimes"))


@functools.lru_cache(maxsize=None)
def _runtimes():
    off = Runtime.create(Config(**SIZE, remat="off"), tiny_unet_config(), tiny_vae_config(),
                         device="cpu")
    on = {}
    for name, resnets in (("on", False), ("resnets", True)):
        ucfg = dataclasses.replace(tiny_unet_config(), remat_resnets=resnets)
        rt = Runtime.empty(Config(**SIZE, remat="on"), ucfg, tiny_vae_config(), device="cpu")
        on[name] = rt.load_weights(off.unet.state_dict(), off.vae.state_dict())
    return off, on


def _step(rt, ctx0, images, thetas, noise):
    """One step; returns (aux, the context gradient, forward calls of the
    UNet's transformers and resnets)."""
    from stablekeypoints_tpu_torch.models.layers import ResnetBlock, Transformer2D

    calls = {Transformer2D: 0, ResnetBlock: 0}

    def count(module, *_):
        calls[type(module)] += 1

    # pre-hooks: a recompute stops once it has what the backward needs,
    # before its module returns
    hooks = [m.register_forward_pre_hook(count) for m in rt.unet.modules() if type(m) in calls]
    context = rt.train_context(ctx0)
    try:
        _, _, aux = rt.train_step(context, rt.optimizer(context), images, thetas=thetas,
                                  noise=noise)
    finally:
        for h in hooks:
            h.remove()
    return aux, context.grad.clone(), calls


@pytest.mark.parametrize("variant", ["on", "resnets"])
def test_remat_step_equals_no_remat(variant):
    off, on = _runtimes()
    rt = on[variant]
    assert rt.unet.config.remat and not off.unet.config.remat
    assert rt.unet.config.remat_resnets == (variant == "resnets")
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32))
    gen = torch.Generator().manual_seed(1)
    thetas = torch.stack([torch.eye(2, 3) * 0.9 + torch.tensor([[0, 0, 0.1], [0, 0, -0.1]])] * 2)
    noise = torch.randn((4, 8, 8, 4), generator=gen)
    ctx0 = off.init_context()

    # the captured maps under a gradient: as many, and equal
    latents = off._encode(images)
    ts = torch.full((2,), off.schedule.timestep_at(-1), dtype=torch.int32)
    noisy = off.schedule.add_noise(latents, noise[:2], int(ts[0]))
    ctx = ctx0.clone().requires_grad_()
    caps = [r.unet(noisy, ts, ctx.expand(2, -1, -1), capture_res=16, truncate=True)[1]
            for r in (off, rt)]
    assert len(caps[0]) == len(caps[1]) == 4
    for a, b in zip(*caps):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=0)

    aux_off, g_off, calls_off = _step(off, ctx0, images, thetas, noise)
    aux_on, g_on, calls_on = _step(rt, ctx0, images, thetas, noise)
    # every block on the gradient's path is run again in the backward (the
    # first resnet reads no context: nothing to recompute there)
    from stablekeypoints_tpu_torch.models.layers import ResnetBlock, Transformer2D

    assert calls_on[Transformer2D] == 2 * calls_off[Transformer2D]
    assert calls_on[ResnetBlock] == (2 * calls_off[ResnetBlock] - 1 if variant == "resnets"
                                     else calls_off[ResnetBlock])
    for name in aux_off:
        torch.testing.assert_close(aux_on[name], aux_off[name], rtol=1e-6, atol=0)
    assert g_off.abs().max() > 0
    torch.testing.assert_close(g_on, g_off, rtol=1e-6, atol=1e-6 * g_off.abs().max().item())
