"""The detection slice as a whole: the port's Runtime vs the JAX Runtime.

Both sides run the tiny UNet/VAE topologies at 64^2 in fp32 on the CPU
with the same parameters (carried across by `from_jax_params`) and the
same random inputs: the affine thetas and latent noise are recomputed here
import torch_threads  # noqa: F401  (torch's threads: this xdist worker's share)
from the JAX key exactly as `Runtime._ensembled_maps` splits it, and handed
to the port.

Tolerance on the ensembled maps: 1e-5 absolute (maps are O(1/num_tokens);
the sides agree to fp32 rounding through the VAE, UNet, capture and the
inverse warp, measured ~4e-7). Keypoints must be equal wherever the
map's argmax beats its runner-up by more than that tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablekeypoints_tpu.config import Config as JaxConfig
from stablekeypoints_tpu.models.unet import tiny_unet_config as jax_tiny_unet
from stablekeypoints_tpu.models.vae import tiny_vae_config as jax_tiny_vae
from stablekeypoints_tpu.ops.transforms import AffineParams as JaxAffine
from stablekeypoints_tpu.ops.transforms import sample_thetas as jax_sample_thetas
from stablekeypoints_tpu.parallel import mesh as pmesh
from stablekeypoints_tpu.pipeline.runtime import Runtime as JaxRuntime
from stablekeypoints_tpu_torch.config import Config
from stablekeypoints_tpu_torch.models.unet import tiny_unet_config
from stablekeypoints_tpu_torch.models.vae import tiny_vae_config
from stablekeypoints_tpu_torch.models.weights import from_jax_params
from stablekeypoints_tpu_torch.pipeline.runtime import Runtime

ATOL = 1e-5
SIZE = dict(image_size=64, num_tokens=16, feature_upsample_res=16, top_k=4,
            augmentation_iterations=3, dtype="float32")


def _jax_random_inputs(key, m, n, size, views_per_pass):
    """The thetas and noise `_ensembled_maps` draws from `key`."""
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


@pytest.mark.parametrize("pallas_capture,views_per_pass", [("off", 16), ("on", 3)])
def test_detect_slice_matches_jax_runtime(pallas_capture, views_per_pass):
    """pallas_capture='on' runs the JAX capture kernel in interpret mode;
    views_per_pass=3 chunks the 6 views into two forwards on both sides."""
    kw = dict(SIZE, pallas_capture=pallas_capture, eval_views_per_pass=views_per_pass)
    jrt = JaxRuntime.create(JaxConfig(jax_cache_dir="", **kw), jax_tiny_unet(),
                            jax_tiny_vae(), mesh=pmesh.make_mesh(1))
    rt = Runtime.create(Config(**kw), tiny_unet_config(), tiny_vae_config(), device="cpu")
    rt.load_weights(*from_jax_params(jax.device_get(jrt.unet_params),
                                     jax.device_get(jrt.vae_params)))

    rng = np.random.default_rng(7)
    imgs = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    idx = np.array([3, 0, 7, 12], np.int32)
    # x30: a learned context gives peaked maps; the N(0, 1) init through
    # these tiny random weights gives near-uniform ones with no clear argmax
    ctx = np.array(jrt.init_context()) * 30.0
    key = jax.random.PRNGKey(11)

    want_pts = np.asarray(jrt.augmented_keypoints_fn(ctx, imgs, idx, key))
    want_maps = np.asarray(jax.jit(jrt._ensembled_maps)(
        jrt.unet_params, jrt.vae_params, ctx, imgs, idx, key))
    thetas, noise = _jax_random_inputs(key, 2, 3, 64, views_per_pass)

    random = dict(thetas=torch.from_numpy(thetas), noise=torch.from_numpy(noise))
    got_pts = rt.augmented_keypoints(ctx, imgs, idx, **random).numpy()
    with torch.inference_mode():
        got_maps = rt._ensembled_maps(*rt._inputs(ctx, imgs, idx), **random).numpy()

    assert got_maps.shape == want_maps.shape == (2, 4, 64, 64)
    np.testing.assert_allclose(got_maps, want_maps, atol=ATOL)
    assert got_pts.shape == (2, 4, 2) and np.isfinite(got_pts).all()
    top2 = -np.sort(-want_maps.reshape(8, -1), axis=-1)[:, :2]
    decisive = (top2[:, 0] - top2[:, 1]) > ATOL
    assert decisive.any()
    np.testing.assert_array_equal(got_pts.reshape(8, 2)[decisive], want_pts.reshape(8, 2)[decisive])
