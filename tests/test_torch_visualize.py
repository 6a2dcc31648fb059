"""Visualization: the port's `pipeline/visualize.py` against the JAX
package's, and `--visualize` through the port's CLI.

- With stand-in runtimes whose maps depend only on the image (the same
  function on both sides), `visualize_attn_maps` (with a regressor),
  `save_augmentation_panel` and `create_vid` write the same file names as
  the JAX functions, and `create_vid`'s tracks and saved maps are equal
  (the image order, keypoint extraction and regressor are host numpy on
  both sides).
- With the real tiny runtimes (the JAX `Runtime`'s weights carried across,
  64^2, fp32), `create_vid`'s tracks against JAX's: every frame's thetas
  and noise are recomputed from the JAX key it splits per frame and
  handed to the port. Maps (saved in fp16) within 1e-3 of their largest
  magnitude (fp16's 2^-11 relative rounding on top of the detect slice's
  1e-5); keypoints equal wherever the map's argmax is decisive.
- The CLI end to end with --visualize on a synthetic CelebA layout at 64^2
  writes the JAX package's visualization artifacts beside the stage ones.
"""

import torch_threads  # noqa: F401  (torch's threads: this xdist worker's share)
import os
import sys

import jax
import numpy as np
import pytest
import torch
from test_torch_slice import _jax_random_inputs

from stablekeypoints_tpu.config import Config as JaxConfig
from stablekeypoints_tpu.models.unet import tiny_unet_config as jax_tiny_unet
from stablekeypoints_tpu.models.vae import tiny_vae_config as jax_tiny_vae
from stablekeypoints_tpu.parallel import mesh as pmesh
from stablekeypoints_tpu.pipeline import visualize as jvis
from stablekeypoints_tpu.pipeline.runtime import Runtime as JaxRuntime
from stablekeypoints_tpu_torch import main as cli
from stablekeypoints_tpu_torch.config import Config
from stablekeypoints_tpu_torch.models.unet import tiny_unet_config
from stablekeypoints_tpu_torch.models.vae import tiny_vae_config
from stablekeypoints_tpu_torch.models.weights import from_jax_params
from stablekeypoints_tpu_torch.ops.transforms import AffineParams
from stablekeypoints_tpu_torch.pipeline import visualize
from stablekeypoints_tpu_torch.pipeline.runtime import Runtime

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "examples"))
from make_synthetic_celeba import make_synthetic_celeba  # noqa: E402

TINY = dict(image_size=64, num_tokens=16, feature_upsample_res=16, top_k=4,
            augmentation_iterations=2, dtype="float32")


class _Frames:
    def __init__(self, n, size=32, seed=0):
        rng = np.random.default_rng(seed)
        self.items = [{"img": rng.uniform(0, 1, (size, size, 3)).astype(np.float32),
                       "kpts": rng.uniform(0, 1, (6, 2)).astype(np.float32)} for _ in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _image_maps(image, k):
    """[k, H, W] maps that depend only on the image."""
    gray = np.asarray(image, np.float32).mean(-1)
    return np.stack([np.roll(gray, 3 * j, axis=1) ** (j + 1) for j in range(k)])


class _JaxStandIn:
    def __init__(self, cfg):
        self.cfg = cfg

    def augmented_maps_fn(self, context, image, indices, key):
        return _image_maps(image, len(indices))


class _PortStandIn:
    device = torch.device("cpu")

    def __init__(self, cfg):
        self.cfg = cfg
        self.aff = AffineParams(cfg.augment_degrees, tuple(cfg.augment_scale),
                                tuple(cfg.augment_translate))

    def augmented_maps(self, context, image, indices, generator=None):
        return torch.from_numpy(_image_maps(np.asarray(image), len(indices)))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_artifact_set_and_tracks_equal_jax(tmp_path):
    data = _Frames(5)
    indices = np.arange(3)
    regressor = np.random.default_rng(1).standard_normal((6, 12)).astype(np.float32) * 0.1
    tracks = {}
    for side in ("jax", "port"):
        out = str(tmp_path / side)
        if side == "jax":
            rt, mod = _JaxStandIn(JaxConfig(save_folder=out, seed=2)), jvis
        else:
            rt, mod = _PortStandIn(Config(save_folder=out, seed=2)), visualize
        mod.visualize_attn_maps(rt, data, None, indices, regressor=regressor, num_images=4)
        mod.save_augmentation_panel(rt, data[0]["img"], None, indices,
                                    os.path.join(out, "augmentation.png"))
        tracks[side] = mod.create_vid(rt, data, None, indices, regressor=regressor)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    assert "unsupervised_keypoints.pdf" in _files(tmp_path / "port")
    np.testing.assert_allclose(tracks["port"], tracks["jax"], rtol=0, atol=1e-6)
    for name in ("keypoints", "saved_maps"):
        np.testing.assert_array_equal(np.load(tmp_path / "port" / f"{name}.npy"),
                                      np.load(tmp_path / "jax" / f"{name}.npy"))


class _Injected:
    """The port runtime, with each augmented_maps call's thetas and noise
    taken from a list (one entry per frame)."""

    def __init__(self, rt, randoms):
        self.rt, self.randoms = rt, list(randoms)

    def __getattr__(self, name):
        return getattr(self.rt, name)

    def augmented_maps(self, context, image, indices, generator=None):
        thetas, noise = self.randoms.pop(0)
        return self.rt.augmented_maps(context, image, indices, thetas=torch.from_numpy(thetas),
                                      noise=torch.from_numpy(noise))


def test_create_vid_tracks_match_jax(tmp_path):
    frames = _Frames(3, size=64, seed=3)
    jcfg = JaxConfig(jax_cache_dir="", save_folder=str(tmp_path / "jax"), **TINY)
    jrt = JaxRuntime.create(jcfg, jax_tiny_unet(), jax_tiny_vae(), mesh=pmesh.make_mesh(1))
    rt = Runtime.create(Config(save_folder=str(tmp_path / "port"), **TINY), tiny_unet_config(),
                        tiny_vae_config(), device="cpu")
    rt.load_weights(*from_jax_params(jax.device_get(jrt.unet_params),
                                     jax.device_get(jrt.vae_params)))
    ctx = np.array(jrt.init_context()) * 30.0
    idx = np.array([3, 0, 7, 12])
    want = jvis.create_vid(jrt, frames, ctx, idx)
    # the per-frame keys of the JAX create_vid, and the inputs each one draws
    key, randoms = jax.random.PRNGKey(jcfg.seed + 7), []
    for _ in range(len(frames)):
        key, sub = jax.random.split(key)
        randoms.append(_jax_random_inputs(sub, 1, TINY["augmentation_iterations"], 64, 16))
    got = visualize.create_vid(_Injected(rt, randoms), frames, ctx, idx)
    maps = {side: np.load(tmp_path / side / "saved_maps.npy").astype(np.float32)
            for side in ("jax", "port")}
    assert maps["port"].shape == maps["jax"].shape == (3, 4, 64, 64)
    np.testing.assert_allclose(maps["port"], maps["jax"], rtol=0,
                               atol=1e-3 * np.abs(maps["jax"]).max())
    flat = maps["jax"].reshape(12, -1)
    top2 = -np.sort(-flat, axis=-1)[:, :2]
    decisive = (top2[:, 0] - top2[:, 1]) > 1e-3 * np.abs(flat).max()
    assert decisive.any()
    np.testing.assert_array_equal(got.reshape(12, 2)[decisive], want.reshape(12, 2)[decisive])
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


def test_cli_with_visualize_writes_the_jax_artifacts(tmp_path):
    data, out = str(tmp_path / "celeba"), str(tmp_path / "out")
    make_synthetic_celeba(data, n=8, image_size=64)
    argv = ["--dataset_name", "celeba_aligned", "--dataset_loc", data, "--save_folder", out,
            "--image_size", "64", "--num_tokens", "16", "--feature_upsample_res", "16",
            "--batch_size", "2", "--num_steps", "1", "--num_indices", "2",
            "--furthest_point_num_samples", "8", "--top_k", "4", "--augmentation_iterations", "2",
            "--max_num_points", "4", "--eval_batch_images", "2", "--dtype", "float32",
            "--device", "cpu", "--visualize"]
    args = cli.build_parser().parse_args(argv)
    cfg = cli.config_from_args(args)
    assert cfg.visualize
    results = cli.run(cfg, tiny_unet_config(), tiny_vae_config(), device=args.device)
    assert np.isfinite(results["mean_distance"])
    files = set(os.listdir(out))
    want = {"unsupervised_keypoints.pdf", "estimated_keypoints.pdf", "gt_keypoints.pdf",
            "augmentation.png"} | {f"keypoint_{j:03d}.png" for j in range(4)}
    assert want <= files, sorted(want - files)
    assert {"regressor.npy", "all_errors.npy"} <= files


def test_plots_need_matplotlib(tmp_path, monkeypatch):
    """Without matplotlib the plotting functions raise before computing
    anything; nothing is skipped quietly."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    rt = _PortStandIn(Config(save_folder=str(tmp_path)))
    with pytest.raises(ImportError):
        visualize.visualize_attn_maps(rt, _Frames(2), None, np.arange(2))
    with pytest.raises(ImportError):
        visualize.create_vid(rt, _Frames(2), None, np.arange(2))
    assert os.listdir(tmp_path) == []
