"""The SD-2.x and SDXL slices of the port's Runtime against the JAX Runtime,
on the CPU in fp32: detection (ensembled maps and keypoints), a fill and a
cached training step (loss, aux, the context gradient) and SDXL generation
with the final-step capture.

Both sides run the packages' tiny SD-2.x and SDXL topologies (48-dim
context) with the tiny VAE at 64^2, with the same parameters (JAX's,
through `from_jax_params`) and the same random inputs (recomputed here from
the JAX keys as the JAX Runtime splits them). SDXL's micro-conditioning
(time_ids of the image size) enters every UNet call on both sides.

Tolerances are those of the SD-1.5 slices: test_torch_slice.py (maps 1e-5
absolute), test_torch_train_slice.py (loss and aux rtol 1e-5, the context
gradient 1e-4 of its largest magnitude) and test_torch_generate.py (images
1e-4, maps 1e-5 absolute).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stablekeypoints_tpu.config import Config as JaxConfig
from stablekeypoints_tpu.models import unet as junet
from stablekeypoints_tpu.models.scheduler import DDIMSchedule as JaxSchedule
from stablekeypoints_tpu.models.vae import tiny_vae_config as jax_tiny_vae
from stablekeypoints_tpu.ops.keypoints import find_max_pixel
from stablekeypoints_tpu.ops.transforms import AffineParams as JaxAffine
from stablekeypoints_tpu.ops.transforms import sample_thetas as jax_sample_thetas
from stablekeypoints_tpu.parallel import mesh as pmesh
from stablekeypoints_tpu.pipeline import generate as jgen
from stablekeypoints_tpu.pipeline.runtime import Runtime as JaxRuntime
from stablekeypoints_tpu_torch.config import Config
from stablekeypoints_tpu_torch.models import unet as tunet
from stablekeypoints_tpu_torch.models import weights as tw
from stablekeypoints_tpu_torch.models.scheduler import DDIMSchedule
from stablekeypoints_tpu_torch.models.vae import tiny_vae_config
from stablekeypoints_tpu_torch.pipeline import generate
from stablekeypoints_tpu_torch.pipeline.runtime import Runtime

MODEL_TYPE = {"sd21": "stabilityai/stable-diffusion-2-1-base",
              "sdxl": "stabilityai/stable-diffusion-xl-base-1.0"}
# one runtime pair per family serves every test here
SIZE = dict(image_size=64, num_tokens=16, feature_upsample_res=16, top_k=4,
            augmentation_iterations=3, batch_size=2, furthest_point_num_samples=8,
            dtype="float32")
CTX_DIM = 48  # both tiny topologies


@functools.lru_cache(maxsize=None)
def _runtimes(family, schedule_steps=None):
    """The JAX Runtime of the family's tiny topology and the port's with its
    weights; with `schedule_steps`, both on a DDIM schedule of that many
    steps (generation)."""
    jcfg = getattr(junet, f"{family}_tiny_config")()
    tcfg = getattr(tunet, f"{family}_tiny_config")()
    kw = dict(SIZE, model_type=MODEL_TYPE[family])
    jrt = JaxRuntime.create(JaxConfig(jax_cache_dir="", **kw), jcfg, jax_tiny_vae(),
                            mesh=pmesh.make_mesh(1))
    rt = Runtime.create(Config(**kw), tcfg, tiny_vae_config(), device="cpu")
    rt.load_weights(*tw.from_jax_params(jax.device_get(jrt.unet_params),
                                        jax.device_get(jrt.vae_params)))
    if schedule_steps is not None:
        jrt.schedule = JaxSchedule.create(schedule_steps)
        rt.schedule = DDIMSchedule.create(schedule_steps)
    return jrt, rt


@pytest.mark.parametrize("family", ["sd21", "sdxl"])
def test_added_cond_matches_jax(family):
    jrt, rt = _runtimes(family)
    want = jrt._added_cond(3)
    got = rt.added_cond(3)
    if family == "sd21":
        assert got is None and want is None
        return
    np.testing.assert_array_equal(got["time_ids"].numpy(), np.asarray(want["time_ids"]))
    np.testing.assert_array_equal(rt.added_cond(1, target_size=128)["time_ids"].numpy(),
                                  np.asarray(jrt._added_cond(1, target_size=128)["time_ids"]))


def _jax_random_inputs(key, m, n, size, views_per_pass):
    """The thetas and noise the JAX `_ensembled_maps` draws from `key`."""
    k_theta, k_noise = jax.random.split(key)
    v = m * n
    thetas = jax_sample_thetas(k_theta, v, JaxAffine())
    chunk = next(c for c in range(min(views_per_pass, v), 0, -1) if v % c == 0)
    shape = (chunk, size // 8, size // 8, 4)
    if chunk == v:
        noise = jax.random.normal(k_noise, shape, jnp.float32)
    else:
        noise = jnp.concatenate([
            jax.random.normal(jax.random.fold_in(k_noise, i), shape, jnp.float32)
            for i in range(v // chunk)
        ])
    return np.array(thetas), np.array(noise)


@pytest.mark.parametrize("family", ["sd21", "sdxl"])
def test_detect_slice_matches_jax_runtime(family):
    """Ensembled maps of 2 images x 3 views through both Runtimes, and the
    port's keypoints against the JAX argmax of the JAX maps."""
    jrt, rt = _runtimes(family)
    rng = np.random.default_rng(7)
    imgs = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    idx = np.array([3, 0, 7, 12], np.int32)
    ctx = np.array(jrt.init_context()) * 30.0
    key = jax.random.PRNGKey(11)
    want_maps = np.asarray(jax.jit(jrt._ensembled_maps)(
        jrt.unet_params, jrt.vae_params, ctx, imgs, idx, key))
    # the JAX Runtime's keypoints of those maps (cfg.max_loc_strategy argmax)
    want_pts = np.asarray(find_max_pixel(jnp.asarray(want_maps.reshape(8, 64, 64)))) / 64
    thetas, noise = _jax_random_inputs(key, 2, 3, 64, rt.cfg.eval_views_per_pass)
    random = dict(thetas=torch.from_numpy(thetas), noise=torch.from_numpy(noise))
    got_pts = rt.augmented_keypoints(ctx, imgs, idx, **random).numpy()
    with torch.inference_mode():
        got_maps = rt._ensembled_maps(*rt._inputs(ctx, imgs, idx), **random).numpy()
    assert got_maps.shape == want_maps.shape == (2, 4, 64, 64)
    np.testing.assert_allclose(got_maps, want_maps, atol=1e-5)
    top2 = -np.sort(-want_maps.reshape(8, -1), axis=-1)[:, :2]
    decisive = (top2[:, 0] - top2[:, 1]) > 1e-5
    assert decisive.any()
    np.testing.assert_array_equal(got_pts.reshape(8, 2)[decisive],
                                  want_pts.reshape(8, 2)[decisive])


# zero updates; the state after `update` is the gradient itself
GRAB = optax.GradientTransformation(lambda p: jnp.zeros_like(p),
                                    lambda g, s, p=None: (jnp.zeros_like(g), g))


@pytest.mark.parametrize("family", ["sd21", "sdxl"])
def test_train_step_fill_and_cached_match_jax(family):
    """Loss, aux and the context gradient of a fill step (batch 2), and for
    SDXL of a cached step on the JAX latents with the next key's inputs
    (the cached step differs from the fill step only before the UNet, so
    SD-2.x's is left to the SD-1.5 test of it)."""
    jrt, rt = _runtimes(family)

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

    def random_from_key(key):
        _, k_noise, k_theta = jax.random.split(key, 3)
        thetas = np.array(jax_sample_thetas(k_theta, 2, JaxAffine()))
        noise = np.array(jax.random.normal(k_noise, (4, 8, 8, 4), jnp.float32))
        return dict(thetas=torch.from_numpy(thetas), noise=torch.from_numpy(noise))

    def check(aux, want_aux, grad, want_g):
        for name in ("loss", "sharpening", "equivariance"):
            np.testing.assert_allclose(float(aux[name]), float(want_aux[name]), rtol=1e-5)
        want_g = np.asarray(want_g)
        assert np.abs(want_g).max() > 0
        np.testing.assert_allclose(grad, want_g, rtol=0, atol=1e-4 * np.abs(want_g).max())

    rng = np.random.default_rng(7)
    images = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    ctx = rng.standard_normal((1, 16, CTX_DIM)).astype(np.float32) * 10.0
    key = jax.random.PRNGKey(5)
    want_g, key2, want_aux, want_lat = fill(jnp.asarray(ctx), jnp.asarray(images), key)
    context = rt.train_context(ctx)
    _, _, aux, lat = rt.train_step_fill(context, rt.optimizer(context), images,
                                        **random_from_key(key))
    check(aux, want_aux, context.grad.numpy(), want_g)
    np.testing.assert_allclose(lat.numpy(), np.asarray(want_lat), atol=1e-5)
    if family == "sd21":
        return

    want_g, want_aux = cached(jnp.asarray(ctx), want_lat, jnp.asarray(images), key2)
    context = rt.train_context(ctx)
    _, _, aux = rt.train_step_cached(context, rt.optimizer(context),
                                     torch.from_numpy(np.array(want_lat)), images,
                                     **random_from_key(key2))
    check(aux, want_aux, context.grad.numpy(), want_g)


def test_sdxl_generate_images_matches_jax():
    """4 DDIM steps of 1 image with the final-step capture, time_ids of the
    generated size on every forward (JAX tests/test_sdxl.py's flow)."""
    jrt, rt = _runtimes("sdxl", schedule_steps=4)
    rng = np.random.default_rng(8)
    ctx = (rng.standard_normal((1, 16, CTX_DIM)) * 3).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want_img, want_maps = jgen.generate_images(jrt, jnp.asarray(ctx), 1, key=key,
                                               capture_final_maps=True)
    latents = np.array(jax.random.normal(key, (1, 8, 8, 4), jnp.float32))
    got_img, got_maps = generate.generate_images(rt, ctx, capture_final_maps=True,
                                                 latents=latents)
    assert got_img.shape == want_img.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(got_img, want_img, rtol=0, atol=1e-4)
    assert 0.05 < np.ptp(want_img)
    assert got_maps.shape == want_maps.shape == (1, 16, 16, 16)
    np.testing.assert_allclose(got_maps, want_maps, rtol=0, atol=1e-5)
