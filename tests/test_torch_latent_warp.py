"""The latent-space warp (`cfg.latent_warp`): the port against the JAX
package, on the CPU in fp32 with the tiny topologies at 64^2.

- `apply_affine_fill` against JAX's: 1e-6 absolute (the same bilinear
  taps; JAX's static-params form is a matmul of the same weights);
- `black_latent` against the JAX `Runtime`'s: 1e-6 absolute (one encode);
- the training step with the warp (fill and cached) against JAX
  `_train_step`: the test_torch_train_slice.py tolerances (loss and aux
  rtol 1e-5, the context gradient 1e-4 of its largest magnitude);
- detection with the warp against JAX `_ensembled_maps`: the
  test_torch_slice.py tolerance (1e-5 absolute on the maps).
"""

import torch_threads  # noqa: F401  (torch's threads: this xdist worker's share)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_slice import ATOL, _jax_random_inputs
from test_torch_train_slice import (
    GRAB,
    _assert_aux_close,
    _assert_grad_close,
    _inputs,
    _random_from_key,
)

from stablekeypoints_tpu.config import Config as JaxConfig
from stablekeypoints_tpu.models.unet import tiny_unet_config as jax_tiny_unet
from stablekeypoints_tpu.models.vae import tiny_vae_config as jax_tiny_vae
from stablekeypoints_tpu.ops import transforms as jt
from stablekeypoints_tpu.parallel import mesh as pmesh
from stablekeypoints_tpu.pipeline.runtime import Runtime as JaxRuntime
from stablekeypoints_tpu_torch.config import Config
from stablekeypoints_tpu_torch.models.unet import tiny_unet_config
from stablekeypoints_tpu_torch.models.vae import tiny_vae_config
from stablekeypoints_tpu_torch.models.weights import from_jax_params
from stablekeypoints_tpu_torch.ops.transforms import apply_affine_fill
from stablekeypoints_tpu_torch.pipeline.runtime import Runtime

SIZE = dict(image_size=64, num_tokens=16, feature_upsample_res=16, top_k=4,
            furthest_point_num_samples=8, batch_size=2, dtype="float32", latent_warp=True)


def test_apply_affine_fill_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.standard_normal((3, 8, 8, 4)).astype(np.float32)
    thetas = np.asarray(jt.sample_thetas(jax.random.PRNGKey(1), 3, jt.AffineParams()))
    thetas = thetas.copy()
    thetas[0, :, 2] += 0.9  # far out of frame: the fill dominates
    fill = np.array([0.3, -1.0, 2.0, 0.5], np.float32)
    want = np.asarray(jt.apply_affine_fill(jnp.asarray(img), jnp.asarray(thetas),
                                           jnp.asarray(fill), params=jt.AffineParams()))
    got = apply_affine_fill(torch.from_numpy(img), torch.from_numpy(thetas), fill).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    identity = np.tile(np.array([[[1, 0, 0], [0, 1, 0]]], np.float32), (3, 1, 1))
    same = apply_affine_fill(torch.from_numpy(img), torch.from_numpy(identity), fill).numpy()
    np.testing.assert_allclose(same, img, rtol=0, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _runtimes():
    jrt = JaxRuntime.create(JaxConfig(jax_cache_dir="", **SIZE), jax_tiny_unet(), jax_tiny_vae(),
                            mesh=pmesh.make_mesh(1))
    rt = Runtime.create(Config(**SIZE), tiny_unet_config(), tiny_vae_config(), device="cpu")
    rt.load_weights(*from_jax_params(jax.device_get(jrt.unet_params),
                                     jax.device_get(jrt.vae_params)))
    return jrt, rt


def test_black_latent_matches_jax():
    jrt, rt = _runtimes()
    got = rt.black_latent.numpy()
    assert got.shape == (4,)
    np.testing.assert_allclose(got, np.asarray(jrt.black_latent), rtol=0, atol=1e-6)


def test_train_step_with_latent_warp_matches_jax():
    """A fill step (the originals encoded once, their latents warped) and a
    cached step on the JAX latents, against JAX `_train_step` with
    latent_warp on; the warped images are never encoded."""
    jrt, rt = _runtimes()
    images, ctx = _inputs()
    key = jax.random.PRNGKey(5)

    @jax.jit
    def fill(ctx, images, key):
        _, grads, key, aux, lat = jrt._train_step(
            jrt.unet_params, jrt.vae_params, GRAB, ctx, GRAB.init(ctx), images, key,
            return_latents=True)
        return grads, key, aux, lat

    @jax.jit
    def cached(ctx, lat, images, key):
        _, grads, _, aux = jrt._train_step(
            jrt.unet_params, jrt.vae_params, GRAB, ctx, GRAB.init(ctx), images, key,
            latents_orig=lat)
        return grads, aux

    want_g, key2, want_aux, want_lat = fill(jnp.asarray(ctx), jnp.asarray(images), key)
    encodes = []
    real_encode = rt._encode
    rt._encode = lambda x: encodes.append(x.shape[0]) or real_encode(x)
    try:
        context = rt.train_context(ctx)
        _, _, aux, lat = rt.train_step_fill(context, rt.optimizer(context), images,
                                            **_random_from_key(key))
        assert encodes == [2]  # the two originals, once
        _assert_aux_close(aux, want_aux)
        _assert_grad_close(context.grad.numpy(), want_g)
        np.testing.assert_allclose(lat.numpy(), np.asarray(want_lat), atol=1e-5)

        want_g, want_aux = cached(jnp.asarray(ctx), want_lat, jnp.asarray(images), key2)
        context = rt.train_context(ctx)
        _, _, aux = rt.train_step_cached(context, rt.optimizer(context),
                                         torch.from_numpy(np.array(want_lat)), images,
                                         **_random_from_key(key2))
        assert encodes == [2]  # no encode on a cached step
        _assert_aux_close(aux, want_aux)
        _assert_grad_close(context.grad.numpy(), want_g)
    finally:
        del rt._encode
    assert np.abs(np.asarray(want_g)).max() > 0


@pytest.mark.parametrize("views_per_pass", [16, 3])
def test_detect_with_latent_warp_matches_jax(views_per_pass):
    """One encode of the 2 images (not one per view); views_per_pass 3 runs
    the 6 warped latents in two passes on both sides."""
    jrt, rt = _runtimes()
    kw = dict(SIZE, augmentation_iterations=3, eval_views_per_pass=views_per_pass)
    black = jrt.black_latent  # computed eagerly, outside the trace below
    jrt = JaxRuntime(JaxConfig(jax_cache_dir="", **kw), jrt.unet, jrt.vae, jrt.unet_params,
                     jrt.vae_params, jrt.schedule, jrt.mesh, jrt.vae_loop)
    jrt.__dict__["black_latent"] = black
    rt = Runtime(Config(**kw), rt.unet, rt.vae, rt.schedule, rt.device)
    rng = np.random.default_rng(7)
    imgs = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    idx = np.array([3, 0, 7, 12], np.int32)
    ctx = np.array(jrt.init_context()) * 30.0
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax.jit(jrt._ensembled_maps)(jrt.unet_params, jrt.vae_params, ctx, imgs,
                                                   idx, key))
    thetas, noise = _jax_random_inputs(key, 2, 3, 64, views_per_pass)
    encodes = []
    real_encode = rt._encode
    rt._encode = lambda x: encodes.append(x.shape[0]) or real_encode(x)
    rt.black_latent  # computed before the count
    encodes.clear()
    with torch.inference_mode():
        got = rt._ensembled_maps(*rt._inputs(ctx, imgs, idx), thetas=torch.from_numpy(thetas),
                                 noise=torch.from_numpy(noise)).numpy()
    assert encodes == [2]
    assert got.shape == want.shape == (2, 4, 64, 64)
    np.testing.assert_allclose(got, want, atol=ATOL)
