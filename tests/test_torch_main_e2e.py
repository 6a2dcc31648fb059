"""The port's five-stage CLI end to end on the CPU (the JAX package's
tests/test_main_e2e.py, without --visualize, which the port does not have).

argv -> `build_parser` -> `config_from_args` -> `run(cfg, tiny UNet, tiny
VAE, device="cpu")` on a 16-image synthetic CelebA layout at 64^2
(`examples/make_synthetic_celeba.py`): stages 1-5 complete, the reference
artifact set and the step-2 checkpoint are on disk, and a `--resume` rerun
reuses the stage 1-3 artifacts and fits a bitwise-equal regressor.

The run's weights are a JAX `Runtime`'s (`from_jax_params`), so its first
stage-3 chunk can be held to the JAX package: (1) replaying the run's
generator draws through the port's runtime gives the run's saved source
keypoints bitwise; (2) with thetas and noise from a JAX key, the port's
ensembled maps of that chunk are within 1e-5 of the JAX `Runtime`'s and
its keypoints equal wherever the argmax is decisive
(tests/test_torch_slice.py's tolerance).
"""

import torch_threads  # noqa: F401  (torch's threads: this xdist worker's share)
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
from test_torch_slice import ATOL, _jax_random_inputs

from stablekeypoints_tpu.config import Config as JaxConfig
from stablekeypoints_tpu.models.unet import tiny_unet_config as jax_tiny_unet
from stablekeypoints_tpu.models.vae import tiny_vae_config as jax_tiny_vae
from stablekeypoints_tpu.parallel import mesh as pmesh
from stablekeypoints_tpu.pipeline.runtime import Runtime as JaxRuntime
from stablekeypoints_tpu_torch import main as cli
from stablekeypoints_tpu_torch.data.registry import build_dataset
from stablekeypoints_tpu_torch.models.unet import tiny_unet_config
from stablekeypoints_tpu_torch.models.vae import tiny_vae_config
from stablekeypoints_tpu_torch.models.weights import from_jax_params
from stablekeypoints_tpu_torch.pipeline.runtime import Runtime

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "examples"))
from make_synthetic_celeba import make_synthetic_celeba  # noqa: E402

STAGE_ARTIFACTS = ("embedding", "indices", "source_keypoints", "target_keypoints", "visible",
                   "regressor", "all_errors")
TINY = dict(image_size=64, num_tokens=16, feature_upsample_res=16, top_k=4,
            augmentation_iterations=4, dtype="float32")


def _argv(data, out, *extra):
    return ["--dataset_name", "celeba_aligned", "--dataset_loc", data, "--save_folder", out,
            "--image_size", "64", "--num_tokens", "16", "--feature_upsample_res", "16",
            "--batch_size", "4", "--num_steps", "3", "--checkpoint_every", "2",
            "--num_indices", "8", "--furthest_point_num_samples", "8", "--top_k", "4",
            "--augmentation_iterations", "4", "--max_num_points", "10",
            "--eval_batch_images", "4", "--dtype", "float32", "--device", "cpu", *extra]


def _run_cli(argv):
    args = cli.build_parser().parse_args(argv)
    cfg = cli.config_from_args(args)
    assert cfg.evaluation_method == "inter_eye_distance"  # the dataset's preset
    return cfg, cli.run(cfg, tiny_unet_config(), tiny_vae_config(), device=args.device)


@pytest.fixture(scope="module")
def jax_runtime():
    return JaxRuntime.create(JaxConfig(jax_cache_dir="", **TINY), jax_tiny_unet(), jax_tiny_vae(),
                             mesh=pmesh.make_mesh(1))


@pytest.fixture(scope="module")
def e2e(tmp_path_factory, jax_runtime):
    """The run, on the JAX runtime's weights."""
    data = str(tmp_path_factory.mktemp("celeba_data"))
    out = str(tmp_path_factory.mktemp("celeba_out"))
    make_synthetic_celeba(data, n=16, image_size=64)
    weights = from_jax_params(jax.device_get(jax_runtime.unet_params),
                              jax.device_get(jax_runtime.vae_params))
    create = Runtime.create
    mp = pytest.MonkeyPatch()
    mp.setattr(cli.Runtime, "create",
               staticmethod(lambda *a, **k: create(*a, **k).load_weights(*weights)))
    try:
        cfg, results = _run_cli(_argv(data, out))
        rerun = _run_cli(_argv(data, out, "--resume"))[1]
    finally:
        mp.undo()
    return data, out, cfg, results, rerun


def test_stages_1_to_5_complete(e2e):
    *_, results, _ = e2e
    assert results["embedding"].shape == (1, 16, 32)  # tiny context_dim 32
    assert results["indices"].shape == (4,) and len(set(results["indices"].tolist())) == 4
    assert results["regressor"].shape == (8, 10) and results["regressor"].dtype == np.float32
    assert np.isfinite(results["mean_distance"])


def test_reference_artifact_set_on_disk(e2e):
    _, out, *_ = e2e
    for name in STAGE_ARTIFACTS:
        for ext in ("npy", "pt"):
            assert os.path.exists(os.path.join(out, f"{name}.{ext}")), (name, ext)
    assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == ["step_00000002"]
    assert np.load(os.path.join(out, "source_keypoints.npy")).shape == (10, 4, 2)
    assert np.load(os.path.join(out, "all_errors.npy")).shape == (4,)


def test_resume_reuses_stage_artifacts(e2e):
    _, out, _, first, rerun = e2e
    with open(os.path.join(out, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    configs = [i for i, r in enumerate(records) if r.get("event") == "config"]
    assert len(configs) == 2
    reused = {r["artifact"] for r in records[configs[1]:] if r.get("event") == "stage_artifact_reused"}
    assert reused == {"embedding", "indices", "keypoints"}
    assert not any("loss" in r or "images_voted" in r for r in records[configs[1]:])
    first_stages = [r["stage"] for r in records[: configs[1]] if "stage" in r]
    assert first_stages == sorted(first_stages) and set(first_stages) == {1, 2, 3, 5}
    np.testing.assert_array_equal(rerun["embedding"], first["embedding"])
    np.testing.assert_array_equal(rerun["indices"], first["indices"])
    np.testing.assert_array_equal(rerun["regressor"], first["regressor"])
    assert rerun["mean_distance"] == first["mean_distance"]  # same seed, the plain CPU path


def test_first_stage3_chunk_equals_jax_runtime(e2e, jax_runtime):
    data, out, cfg, results, _ = e2e
    reg_ds = build_dataset(cfg, "train_reg")
    m = cfg.eval_batch_images
    order = np.random.default_rng(cfg.seed + 4).permutation(len(reg_ds))[:m]
    images = np.stack([reg_ds[int(i)]["img"] for i in order])
    ctx, idx = results["embedding"], results["indices"]
    rt = Runtime.create(cfg, tiny_unet_config(), tiny_vae_config(), device="cpu")
    rt.load_weights(*from_jax_params(jax.device_get(jax_runtime.unet_params),
                                     jax.device_get(jax_runtime.vae_params)))

    # (1) the run's stage-3 draws replayed: the run's saved keypoints
    replay = rt.augmented_keypoints(ctx, images, idx,
                                    generator=torch.Generator().manual_seed(cfg.seed + 4))
    np.testing.assert_array_equal(replay.numpy(), np.load(os.path.join(out, "source_keypoints.npy"))[:m])

    # (2) the JAX runtime with the same weights, thetas and noise
    key = jax.random.PRNGKey(cfg.seed + 4)
    idx32 = idx.astype(np.int32)
    want_maps = np.asarray(jax.jit(jax_runtime._ensembled_maps)(
        jax_runtime.unet_params, jax_runtime.vae_params, ctx, images, idx32, key))
    want_pts = np.asarray(jax_runtime.augmented_keypoints_fn(ctx, images, idx32, key))
    thetas, noise = _jax_random_inputs(key, m, cfg.augmentation_iterations, 64,
                                       cfg.eval_views_per_pass)
    random = dict(thetas=torch.from_numpy(thetas), noise=torch.from_numpy(noise))
    got_pts = rt.augmented_keypoints(ctx, images, idx, **random).numpy()
    with torch.inference_mode():
        got_maps = rt._ensembled_maps(*rt._inputs(ctx, images, idx), **random).numpy()
    assert got_maps.shape == want_maps.shape == (m, 4, 64, 64)
    np.testing.assert_allclose(got_maps, want_maps, atol=ATOL)
    top2 = -np.sort(-want_maps.reshape(m * 4, -1), axis=-1)[:, :2]
    decisive = (top2[:, 0] - top2[:, 1]) > ATOL
    assert decisive.any()
    np.testing.assert_array_equal(got_pts.reshape(-1, 2)[decisive], want_pts.reshape(-1, 2)[decisive])


def test_custom_dataset_stops_after_stage_2(e2e, tmp_path):
    data, *_ = e2e
    argv = _argv(os.path.join(data, "Img", "img_align_celeba_png"), str(tmp_path))
    argv[1] = "custom"
    argv += ["--num_steps", "1", "--num_indices", "4"]
    args = cli.build_parser().parse_args(argv)
    results = cli.run(cli.config_from_args(args), tiny_unet_config(), tiny_vae_config(),
                      device=args.device)
    assert set(results) == {"embedding", "indices"}
    assert sorted(os.listdir(tmp_path)) == ["checkpoints", "embedding.npy", "embedding.pt",
                                            "indices.npy", "indices.pt", "metrics.jsonl"]


@pytest.mark.parametrize("extra,grouped", [
    (["--steps_per_call", "2", "--remat", "on", "--capture_fp32_bwd"], True),
    (["--steps_per_call", "2", "--profile_steps", "2"], False),
])
def test_trainer_knobs_through_the_cli(e2e, tmp_path, extra, grouped):
    """--steps_per_call, --remat and --capture_fp32_bwd reach the trainer:
    16 images in batches of 4 fill the cache in 4 steps, then steps 4-5 run
    as one group of 2; --profile_steps traces steps 1-2 (no group runs
    while a profile is being taken)."""
    data, *_ = e2e
    argv = _argv(os.path.join(data, "Img", "img_align_celeba_png"), str(tmp_path))
    argv[1] = "custom"
    argv += ["--num_steps", "6", "--checkpoint_every", "0", "--num_indices", "4", *extra]
    args = cli.build_parser().parse_args(argv)
    made, groups = [], []
    create = Runtime.create

    def recording(*a, **k):
        rt = create(*a, **k)
        scan = rt.train_step_scan
        rt.train_step_scan = lambda *s, **kw: groups.append(len(s[2])) or scan(*s, **kw)
        made.append(rt)
        return rt

    mp = pytest.MonkeyPatch()
    mp.setattr(cli.Runtime, "create", staticmethod(recording))
    try:
        results = cli.run(cli.config_from_args(args), tiny_unet_config(), tiny_vae_config(),
                          device=args.device)
    finally:
        mp.undo()
    assert set(results) == {"embedding", "indices"} and np.isfinite(results["embedding"]).all()
    ucfg = made[0].unet.config
    assert (ucfg.remat, ucfg.capture_fp32_bwd) == (("--remat" in extra),
                                                   ("--capture_fp32_bwd" in extra))
    assert groups == ([2] if grouped else [])
    assert os.path.exists(os.path.join(tmp_path, "profile", "trace.json")) == (not grouped)
