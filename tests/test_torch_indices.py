"""Stage 2 in the port vs the JAX package: `Runtime.select_indices` against
`select_indices_fn`, and `find_best_indices` against JAX's, on the tiny
topologies in fp32 with the same parameters (`from_jax_params`) and the
same latent noise, recomputed here from the JAX key sequence
(`key, sub = split(key)` per batch, `normal(sub, latents.shape)`). Index
arrays must be equal exactly: the maps agree to fp32 rounding and the
selection's tie rules are JAX's (tests/test_torch_train_ops.py).
"""

import torch_threads  # noqa: F401  (torch's threads: this xdist worker's share)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from stablekeypoints_tpu.config import Config as JaxConfig
from stablekeypoints_tpu.data.synthetic import SyntheticBlobs as JaxBlobs
from stablekeypoints_tpu.models.unet import tiny_unet_config as jax_tiny_unet
from stablekeypoints_tpu.models.vae import tiny_vae_config as jax_tiny_vae
from stablekeypoints_tpu.parallel import mesh as pmesh
from stablekeypoints_tpu.pipeline.indices import find_best_indices as jax_find_best_indices
from stablekeypoints_tpu.pipeline.runtime import Runtime as JaxRuntime
from stablekeypoints_tpu_torch.api import KeypointModel, learn_keypoints
from stablekeypoints_tpu_torch.config import Config
from stablekeypoints_tpu_torch.data.registry import build_dataset
from stablekeypoints_tpu_torch.data.synthetic import SyntheticBlobs
from stablekeypoints_tpu_torch.models.unet import tiny_unet_config
from stablekeypoints_tpu_torch.models.vae import tiny_vae_config
from stablekeypoints_tpu_torch.models.weights import from_jax_params
from stablekeypoints_tpu_torch.pipeline.indices import find_best_indices
from stablekeypoints_tpu_torch.pipeline.runtime import Runtime
from stablekeypoints_tpu_torch.utils.logging import MetricsLogger

SIZE = dict(image_size=64, num_tokens=16, feature_upsample_res=16, top_k=4,
            furthest_point_num_samples=8, batch_size=2, num_indices=5, dtype="float32")


@functools.lru_cache(maxsize=None)
def _runtimes():
    jrt = JaxRuntime.create(JaxConfig(jax_cache_dir="", **SIZE), jax_tiny_unet(), jax_tiny_vae(),
                            mesh=pmesh.make_mesh(1))
    rt = Runtime.create(Config(**SIZE), tiny_unet_config(), tiny_vae_config(), device="cpu")
    rt.load_weights(*from_jax_params(jax.device_get(jrt.unet_params),
                                     jax.device_get(jrt.vae_params)))
    return jrt, rt


def _context(seed):
    # x10: peaked maps, so the token rankings are well separated
    return np.random.default_rng(seed).standard_normal((1, 16, 32)).astype(np.float32) * 10.0


@pytest.mark.parametrize("seed", [0, 1])
def test_select_indices_equal_jax(seed):
    jrt, rt = _runtimes()
    images = np.random.default_rng(seed + 10).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    ctx = _context(seed)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jrt.select_indices_fn(jnp.asarray(ctx), jnp.asarray(images), key))
    noise = np.array(jax.random.normal(key, (2, 8, 8, 4), jnp.float32))
    got = rt.select_indices(ctx, images, noise=torch.from_numpy(noise))
    assert got.shape == (2, 4) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_find_best_indices_equal_jax(tmp_path):
    """5 images in batches of 2: the last batch votes with one image."""
    jrt, rt = _runtimes()
    ctx = _context(2)
    want = jax_find_best_indices(jrt, JaxBlobs(length=6, image_size=64), jnp.asarray(ctx))
    key, noises = jax.random.PRNGKey(rt.cfg.seed + 3), []
    for _ in range(3):
        key, sub = jax.random.split(key)
        noises.append(torch.from_numpy(np.array(jax.random.normal(sub, (2, 8, 8, 4)))))
    logger = MetricsLogger(str(tmp_path))
    got = find_best_indices(rt, SyntheticBlobs(length=6, image_size=64), ctx, logger,
                            noises=noises)
    logger.close()
    assert got.shape == (4,) and len(set(got.tolist())) == 4
    np.testing.assert_array_equal(got, np.asarray(want))
    log = (tmp_path / "metrics.jsonl").read_text()
    assert [line.count('"images_voted"') for line in log.splitlines()] == [1, 1, 1]
    assert '"images_voted": 5' in log


def test_learn_keypoints_runs_both_stages_and_detects(tmp_path):
    _, rt0 = _runtimes()
    cfg = Config(**dict(SIZE, num_steps=2))
    rt = Runtime(cfg, rt0.unet, rt0.vae, rt0.schedule, rt0.device)
    data = SyntheticBlobs(length=4, image_size=64)
    model = learn_keypoints(data, runtime=rt)
    assert isinstance(model, KeypointModel)
    assert model.context.shape == (1, 16, 32) and model.indices.shape == (4,)
    assert len(set(model.indices.tolist())) == 4 and (model.indices < 16).all()
    pts = model.detect(data[0]["img"])
    assert pts.shape == (4, 2) and np.isfinite(pts).all()
    # an image folder goes through the custom adapter: the same run as on
    # the adapter's dataset object
    for i in range(4):
        Image.fromarray((data[i]["img"] * 255).astype(np.uint8)).save(tmp_path / f"im_{i}.png")
    from_folder = learn_keypoints(str(tmp_path), runtime=rt, image_size=64)
    folder_ds = build_dataset(Config(dataset_name="custom", dataset_loc=str(tmp_path), **SIZE),
                              "train")
    from_object = learn_keypoints(folder_ds, runtime=rt)
    assert len(folder_ds) == 4
    np.testing.assert_array_equal(from_folder.context, from_object.context)
    np.testing.assert_array_equal(from_folder.indices, from_object.indices)
    assert not np.array_equal(from_folder.context, model.context)  # other images, other context
