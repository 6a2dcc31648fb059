"""The port's serving export (`stablekeypoints_tpu_torch/serving.py`) on the CPU.

`export_detector` writes the weights, the learned arrays and a manifest;
`ServedDetector.load(dir, device="cpu")` rebuilds the runtime and runs one
static program per exported batch size eagerly (on the card each is a CUDA
graph; `chip_smoke.py`'s `[serve]` phase holds that one). The contract is
the JAX package's `tests/test_serving.py`, at its sizes (tiny UNet/VAE at
64^2, 4 views, fp32):

- served keypoints equal the port's live `augmented_keypoints` with the
  same seed within 1e-5 (the same code on the same buffers: bitwise here),
  and another seed changes them;
- the files and the manifest, whose fields shared with the JAX manifest
  equal the JAX `export_detector`'s for the same export;
- `regressed` against `pipeline/metrics.py:apply_regressor` within 1e-5,
  the regressor rows check, the batch check, dispatch over (2, 1), an SDXL
  topology, a JAX artifact refused, results unchanged by a later `detect`,
  concurrent requests equal to serial ones;
- against the JAX package: the same weights (`from_jax_params`), the thetas
  and noise of `PRNGKey(seed)` recomputed and injected: the port's served
  keypoints equal JAX's served ones wherever the map's argmax beats its
  runner-up by more than 1e-5 (the maps agree to ~4e-7,
  tests/test_torch_slice.py), `regressed` within 1e-5;
- the capture-safety caches: the resize matrices and SDXL's time_ids are
  made once, bitwise the values made before, `add_noise` copies nothing
  to the device, and K6's ticket counters outlive a larger batch's.
"""

import torch_threads  # noqa: F401  (torch's threads: this xdist worker's share)
import json
import os

import jax
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
from stablekeypoints_tpu.serving import ServedDetector as JaxServedDetector
from stablekeypoints_tpu.serving import export_detector as jax_export_detector
from stablekeypoints_tpu_torch import serving
from stablekeypoints_tpu_torch.config import Config
from stablekeypoints_tpu_torch.models.scheduler import DDIMSchedule
from stablekeypoints_tpu_torch.models.unet import sdxl_tiny_config, tiny_unet_config
from stablekeypoints_tpu_torch.models.vae import tiny_vae_config
from stablekeypoints_tpu_torch.models.weights import from_jax_params
from stablekeypoints_tpu_torch.ops import resize
from stablekeypoints_tpu_torch.pipeline.metrics import apply_regressor
from stablekeypoints_tpu_torch.pipeline.runtime import Runtime
from stablekeypoints_tpu_torch.serving import ServedDetector, export_detector

ATOL = 1e-5
SIZE = 64
TOP_K = 4
BATCH = 2
TINY = dict(image_size=SIZE, num_tokens=16, feature_upsample_res=16, top_k=TOP_K,
            augmentation_iterations=4, dtype="float32")
# the manifest fields that keep their name and meaning from the JAX package
SHARED_FIELDS = ("batches", "image_size", "top_k", "num_regressed", "outputs", "model_type",
                 "augmentation_iterations", "max_loc_strategy")


def _live(rt, context, images, indices, seed):
    return rt.augmented_keypoints(context, images, indices,
                                  generator=torch.Generator().manual_seed(seed)).numpy()


@pytest.fixture(scope="module")
def rt():
    return Runtime.create(Config(**TINY), tiny_unet_config(), tiny_vae_config(), device="cpu")


@pytest.fixture(scope="module")
def learned(rt):
    rng = np.random.default_rng(3)
    # x3: peaked maps through the tiny random weights (a clear argmax)
    context = (3.0 * rng.standard_normal((1, 16, rt.unet.config.context_dim))).astype(np.float32)
    return context, np.asarray([1, 5, 9, 13])


def test_export_roundtrip_matches_live(tmp_path, rt, learned):
    context, indices = learned
    out = str(tmp_path / "serving")
    manifest = export_detector(rt, context, indices, out, batch=BATCH)

    with open(os.path.join(out, "manifest.json")) as f:
        assert json.load(f) == manifest
    assert manifest["format"] == "stablekeypoints_tpu_torch" and manifest["format_version"] == 1
    assert manifest["batches"] == [BATCH] and manifest["top_k"] == TOP_K
    assert manifest["outputs"] == ["keypoints"] and manifest["num_regressed"] is None
    assert manifest["platforms"] == ["cuda", "cpu"]
    assert manifest["torch_version"] == torch.__version__
    assert set(manifest["files"]) == {"unet.safetensors", "vae_encoder.safetensors",
                                      "embedding.npy", "embedding.pt", "indices.npy",
                                      "indices.pt"}
    for name, nbytes in manifest["files"].items():
        assert os.path.getsize(os.path.join(out, name)) == nbytes > 0

    det = ServedDetector.load(out, device="cpu")
    # the served runtime: the detect path's weights, bitwise, and no decoder
    assert det.runtime.vae.decoder is None
    want = rt.unet.state_dict()
    for name, p in det.runtime.unet.state_dict().items():
        assert p.dtype == want[name].dtype and torch.equal(p, want[name]), name
    for name, p in det.runtime.vae.state_dict().items():
        assert torch.equal(p, rt.vae.state_dict()[name]), name
    np.testing.assert_array_equal(det.context.numpy(), context)
    np.testing.assert_array_equal(det.indices.numpy(), indices)

    rng = np.random.default_rng(7)
    imgs = rng.uniform(0, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    served = det.detect(imgs, seed=11)
    assert set(served) == {"keypoints"}
    assert served["keypoints"].shape == (BATCH, TOP_K, 2)
    np.testing.assert_allclose(served["keypoints"], _live(rt, context, imgs, indices, 11),
                               atol=ATOL)
    # the seed is live: another one draws other views
    other = det.detect(imgs, seed=12)["keypoints"]
    assert np.abs(other - served["keypoints"]).max() > 0


def test_export_with_regressor(tmp_path, rt, learned):
    context, indices = learned
    rng = np.random.default_rng(5)
    n_gt = 3
    reg = rng.standard_normal((2 * TOP_K, 2 * n_gt)).astype(np.float32) * 0.1
    out = str(tmp_path / "serving_reg")
    manifest = export_detector(rt, context, indices, out, batch=1, regressor=reg)
    assert manifest["outputs"] == ["keypoints", "regressed"]
    assert manifest["num_regressed"] == n_gt
    assert {"regressor.npy", "regressor.pt"} <= set(manifest["files"])

    det = ServedDetector.load(out, device="cpu")
    imgs = rng.uniform(0, 1, (1, SIZE, SIZE, 3)).astype(np.float32)
    got = det.detect(imgs, seed=2)
    assert got["regressed"].shape == (1, n_gt, 2)
    want = apply_regressor(got["keypoints"][0], reg)
    np.testing.assert_allclose(got["regressed"][0], want, atol=ATOL)


def test_regressor_shape_and_batches_validated(tmp_path, rt, learned):
    context, indices = learned
    bad = np.zeros((2 * TOP_K + 2, 4), np.float32)
    with pytest.raises(ValueError, match="regressor rows"):
        export_detector(rt, context, indices, str(tmp_path / "x"), regressor=bad)
    for batch in (0, (), (1, -2)):
        with pytest.raises(ValueError, match="batch sizes must be positive ints"):
            export_detector(rt, context, indices, str(tmp_path / "y"), batch=batch)


def test_batch_shape_validated(tmp_path, rt, learned):
    context, indices = learned
    out = str(tmp_path / "serving_b1")
    export_detector(rt, context, indices, out, batch=1)
    det = ServedDetector.load(out, device="cpu")
    for shape in ((2, SIZE, SIZE, 3), (1, SIZE, SIZE, 1), (1, 32, 32, 3), (SIZE, SIZE, 3)):
        with pytest.raises(ValueError, match="exported for images of shape"):
            det.detect(np.zeros(shape, np.float32))
    with pytest.raises(ValueError, match="noise"):
        det.detect(np.zeros((1, SIZE, SIZE, 3), np.float32), noise=torch.zeros(1, 8, 8, 4))


def test_multi_batch_export_dispatches_on_leading_dim(tmp_path, rt, learned):
    context, indices = learned
    out = str(tmp_path / "serving_multi")
    manifest = export_detector(rt, context, indices, out, batch=(2, 1))
    assert manifest["batches"] == [1, 2]  # sorted, deduplicated

    det = ServedDetector.load(out, device="cpu")
    assert sorted(det.programs) == [1, 2]
    rng = np.random.default_rng(11)
    for b in (1, 2):
        imgs = rng.uniform(0, 1, (b, SIZE, SIZE, 3)).astype(np.float32)
        got = det.detect(imgs, seed=5)
        assert got["keypoints"].shape == (b, TOP_K, 2)
        np.testing.assert_allclose(got["keypoints"], _live(rt, context, imgs, indices, 5),
                                   atol=ATOL)
    with pytest.raises(ValueError, match=r"b in \[1, 2\]"):
        det.detect(np.zeros((3, SIZE, SIZE, 3), np.float32))


def test_results_unchanged_by_a_later_detect(tmp_path, rt, learned):
    context, indices = learned
    out = str(tmp_path / "serving_again")
    export_detector(rt, context, indices, out, batch=1, regressor=np.eye(2 * TOP_K, 4))
    det = ServedDetector.load(out, device="cpu")
    rng = np.random.default_rng(2)
    first = det.detect(rng.uniform(0, 1, (1, SIZE, SIZE, 3)).astype(np.float32), seed=1)
    kept = {k: v.copy() for k, v in first.items()}
    second = det.detect(rng.uniform(0, 1, (1, SIZE, SIZE, 3)).astype(np.float32), seed=2)
    assert np.abs(second["keypoints"] - kept["keypoints"]).max() > 0
    for k in kept:
        np.testing.assert_array_equal(first[k], kept[k])


def test_concurrent_detects_match_serial_ones(tmp_path, rt, learned):
    """Threads share one program's static buffers: each detect copies in,
    runs and copies out under the program's lock, so every result equals
    the same request served alone."""
    import sys
    import threading

    context, indices = learned
    out = str(tmp_path / "serving_threads")
    export_detector(rt, context, indices, out, batch=1)
    det = ServedDetector.load(out, device="cpu")
    rng = np.random.default_rng(4)
    requests = [(rng.uniform(0, 1, (1, SIZE, SIZE, 3)).astype(np.float32), seed)
                for seed in range(6)]
    want = [det.detect(imgs, seed=seed)["keypoints"] for imgs, seed in requests]
    got = [None] * len(requests)

    def serve(i):
        got[i] = det.detect(*requests[i])["keypoints"]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=serve, args=(i,)) for i in range(len(requests))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_sdxl_topology_export(tmp_path):
    """A micro-conditioned (SDXL-topology) detector round-trips: its UNet
    configuration comes back from the manifest."""
    cfg = Config(model_type="sdxl", **TINY)
    xrt = Runtime.create(cfg, sdxl_tiny_config(), tiny_vae_config(), device="cpu")
    rng = np.random.default_rng(13)
    context = (3.0 * rng.standard_normal((1, 16, xrt.unet.config.context_dim))).astype(np.float32)
    indices = np.asarray([0, 3, 7, 11])

    out = str(tmp_path / "serving_sdxl")
    manifest = export_detector(xrt, context, indices, out, batch=1)
    assert manifest["model_type"] == "sdxl"
    det = ServedDetector.load(out, device="cpu")
    assert det.runtime.unet.config == xrt.unet.config
    assert det.runtime.vae.config == xrt.vae.config
    assert det.runtime.added_cond(1) is not None

    imgs = rng.uniform(0, 1, (1, SIZE, SIZE, 3)).astype(np.float32)
    served = det.detect(imgs, seed=4)["keypoints"]
    np.testing.assert_allclose(served, _live(xrt, context, imgs, indices, 4), atol=ATOL)


def test_a_jax_artifact_is_refused(tmp_path):
    """A directory in the JAX package's format (format_version 2, .stablehlo
    blobs, no "format" field) does not load here."""
    out = tmp_path / "jax_artifact"
    out.mkdir()
    (out / "detector_b1.stablehlo").write_bytes(b"\0" * 16)
    (out / "manifest.json").write_text(json.dumps({
        "format_version": 2, "batches": [1],
        "blobs": {"1": {"file": "detector_b1.stablehlo", "bytes": 16}}, "image_size": SIZE,
        "top_k": TOP_K, "num_regressed": None, "outputs": ["keypoints"], "platforms": ["cpu"],
    }))
    with pytest.raises(ValueError, match="not a stablekeypoints_tpu_torch serving artifact"):
        ServedDetector.load(str(out), device="cpu")


def test_cli_refuses_platforms(tmp_path):
    with pytest.raises(SystemExit) as e:
        serving.main(["--save_folder", str(tmp_path), "--out", str(tmp_path / "o"),
                      "--platforms", "cpu,tpu", "--device", "cpu"])
    assert e.value.code == 2


# ---------------------------------------------------------------------------
# against the JAX package


def _jax_random_inputs(seed, m, n, size):
    """The thetas and noise the JAX export draws from PRNGKey(seed) (one
    forward pass: views_per_pass 16 >= m * n)."""
    k_theta, k_noise = jax.random.split(jax.random.PRNGKey(np.uint32(seed)))
    thetas = jax_sample_thetas(k_theta, m * n, JaxAffine())
    noise = jax.random.normal(k_noise, (m * n, size // 8, size // 8, 4), np.float32)
    return np.array(thetas), np.array(noise)


def test_served_matches_the_jax_export(tmp_path):
    jrt = JaxRuntime.create(JaxConfig(dataset_name="synthetic", jax_cache_dir="", **TINY),
                            jax_tiny_unet(), jax_tiny_vae(), mesh=pmesh.make_mesh(1))
    rt = Runtime.create(Config(**TINY), tiny_unet_config(), tiny_vae_config(), device="cpu")
    rt.load_weights(*from_jax_params(jax.device_get(jrt.unet_params),
                                     jax.device_get(jrt.vae_params)))
    rng = np.random.default_rng(17)
    context = np.array(jrt.init_context()) * 30.0  # peaked maps, as test_torch_slice.py
    indices = np.asarray([3, 0, 7, 12])
    reg = rng.standard_normal((2 * TOP_K, 6)).astype(np.float32) * 0.1
    imgs = rng.uniform(0, 1, (1, SIZE, SIZE, 3)).astype(np.float32)
    seed = 9

    jax_dir, out = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_manifest = jax_export_detector(jrt, context, indices.astype(np.int32), jax_dir, batch=1,
                                       regressor=reg)
    manifest = export_detector(rt, context, indices, out, batch=1, regressor=reg)
    assert {f: manifest[f] for f in SHARED_FIELDS} == {f: jax_manifest[f] for f in SHARED_FIELDS}
    # the JAX artifact is refused by the port
    with pytest.raises(ValueError, match="not a stablekeypoints_tpu_torch serving artifact"):
        ServedDetector.load(jax_dir, device="cpu")

    want = JaxServedDetector.load(jax_dir).detect(imgs, seed=seed)
    thetas, noise = _jax_random_inputs(seed, 1, TINY["augmentation_iterations"], SIZE)
    got = ServedDetector.load(out, device="cpu").detect(imgs, thetas=torch.from_numpy(thetas),
                                                         noise=torch.from_numpy(noise))
    assert set(got) == set(want) == {"keypoints", "regressed"}

    maps = np.asarray(jax.jit(jrt._ensembled_maps)(
        jrt.unet_params, jrt.vae_params, context, imgs, indices.astype(np.int32),
        jax.random.PRNGKey(np.uint32(seed))))
    top2 = -np.sort(-maps.reshape(TOP_K, -1), axis=-1)[:, :2]
    decisive = (top2[:, 0] - top2[:, 1]) > ATOL
    assert decisive.any(), top2
    np.testing.assert_array_equal(got["keypoints"].reshape(TOP_K, 2)[decisive],
                                  want["keypoints"].reshape(TOP_K, 2)[decisive])
    np.testing.assert_allclose(got["regressed"], want["regressed"], atol=ATOL)


# ---------------------------------------------------------------------------
# capture safety: nothing on the detect path copies host memory to the
# device after its first call


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resize_matrix_made_once_and_unchanged(dtype):
    before = torch.from_numpy(resize._resize_matrix_np(16, 64, "bilinear").copy()).to(
        device="cpu", dtype=dtype)
    with torch.inference_mode():  # a first call from the inference-mode detect path
        got = resize.resize_matrix(16, 64, "bilinear", dtype, torch.device("cpu"))
    assert not got.is_inference()  # autograd may save it (the training capture does)
    assert got.dtype == dtype and torch.equal(got, before)
    assert resize.resize_matrix(16, 64, "bilinear", dtype, torch.device("cpu")) is got
    other = resize.resize_matrix(16, 64, "bicubic", dtype, torch.device("cpu"))
    assert other is not got and not torch.equal(other, got)


def test_added_cond_made_once_and_unchanged():
    xrt = Runtime.create(Config(model_type="sdxl", **TINY), sdxl_tiny_config(),
                         tiny_vae_config(), device="cpu")
    with torch.inference_mode():
        first = xrt.added_cond(3)["time_ids"]
    s = float(SIZE)
    before = torch.tensor([[s, s, 0.0, 0.0, s, s]], dtype=torch.float32).expand(3, 6)
    assert not first.is_inference() and torch.equal(first, before)
    assert xrt.added_cond(3)["time_ids"] is first
    assert torch.equal(xrt.added_cond(1, 32)["time_ids"],
                       torch.tensor([[32.0, 32.0, 0.0, 0.0, 32.0, 32.0]]))
    assert xrt.added_cond(3, 32)["time_ids"] is not first


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_add_noise_unchanged(dtype):
    """The noise factors stay host scalars: the same values as before, when
    they were copied to the sample's device."""
    sched = DDIMSchedule.create()
    g = torch.Generator().manual_seed(0)
    sample = torch.randn((2, 8, 8, 4), generator=g).to(dtype)
    noise = torch.randn((2, 8, 8, 4), generator=g).to(dtype)
    t = sched.timestep_at(-1)
    acp = np.float32(sched.alphas_cumprod[t])
    a = torch.tensor(np.sqrt(acp), dtype=torch.float32).to(dtype)
    b = torch.tensor(np.sqrt(np.float32(1.0) - acp), dtype=torch.float32).to(dtype)
    assert torch.equal(sched.add_noise(sample, noise, t),
                       a.to(sample.device) * sample + b.to(sample.device) * noise)


def test_groupnorm_counters_outlive_a_larger_batch():
    """K6's ticket counters are made in the warm-up; a later, larger batch
    takes a new buffer and the one an earlier graph captured stays alive."""
    from stablekeypoints_tpu_torch.kernels import groupnorm

    device = torch.device("meta")  # stands in for a card: only the buffers are made
    try:
        small = groupnorm._counters(device, 10)
        assert small.numel() == 128 * 16 and groupnorm._counters(device, 16) is small
        large = groupnorm._counters(device, 40)
        assert large.numel() == 128 * 40 and groupnorm._counters(device, 10) is large
        assert groupnorm._COUNTERS[device] == [small, large]
    finally:
        groupnorm._COUNTERS.pop(device, None)
