"""The port stands alone and runs on the card unless asked otherwise.

- Importing `stablekeypoints_tpu_torch` and running its CPU slices
  (detection, the serving export and its served detector, training)
  leaves `jax` and the JAX package out of `sys.modules` (a fresh
  interpreter); importing the CLI, the dataset
  adapters, the stage 3-5 modules, generation and visualization and
  training loads no PIL (and no matplotlib) either.
- Entry points (a served detector's load too) refuse to run without a GPU
  unless given device="cpu".
- A kernel wrapper given a tensor that is not on the CPU launches its
  kernel or raises; it never falls back to the plain version. The
  attention and capture kernels' wrappers take inputs that require grad
  (they run inside autograd Functions); K6 and K7 are forward-only and
  reject them.
- Knobs whose kernel or feature is not ported yet raise; a checkpoint
  directory that holds no weights raises (no silent random weights);
  every SD-1.x, SD-2.x and SDXL model type builds the JAX package's
  configuration.
"""

import torch_threads  # noqa: F401  (torch's threads: this xdist worker's share)
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from stablekeypoints_tpu_torch.api import KeypointModel
from stablekeypoints_tpu_torch.config import Config
from stablekeypoints_tpu_torch.kernels import attn_capture, cross_attn, flash, gn_conv, groupnorm
from stablekeypoints_tpu_torch.models.unet import tiny_unet_config
from stablekeypoints_tpu_torch.models.vae import tiny_vae_config
from stablekeypoints_tpu_torch.pipeline.runtime import Runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(image_size=64, num_tokens=16, feature_upsample_res=16, top_k=4,
            augmentation_iterations=2, dtype="float32")

_CHILD = """
import sys
import numpy as np
import stablekeypoints_tpu_torch.api as api
import stablekeypoints_tpu_torch.kernels._build
from stablekeypoints_tpu_torch.config import Config
from stablekeypoints_tpu_torch.models.unet import tiny_unet_config
from stablekeypoints_tpu_torch.models.vae import tiny_vae_config
from stablekeypoints_tpu_torch.pipeline.runtime import Runtime
cfg = Config(image_size=64, num_tokens=16, feature_upsample_res=16, top_k=4,
             augmentation_iterations=2, dtype="float32")
rt = Runtime.create(cfg, tiny_unet_config(), tiny_vae_config(), device="cpu")
model = api.KeypointModel(rt, rt.init_context().numpy(), np.arange(4))
pts = model.detect(np.full((64, 64, 3), 0.5, np.float32))
assert pts.shape == (4, 2), pts.shape
import tempfile
import stablekeypoints_tpu_torch.serving as serving
with tempfile.TemporaryDirectory() as out:
    serving.export_detector(rt, model.context, model.indices, out, batch=1)
    det = serving.ServedDetector.load(out, device="cpu")
    got = det.detect(np.full((1, 64, 64, 3), 0.5, np.float32))["keypoints"]
    assert got.shape == (1, 4, 2), got.shape
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "flax"))
             or m == "stablekeypoints_tpu" or m.startswith("stablekeypoints_tpu."))
print("IMPORTED", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", _CHILD], capture_output=True, text=True,
                       cwd=REPO, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "IMPORTED []" in r.stdout


_CHILD_TRAIN = """
import sys
import stablekeypoints_tpu_torch.main
import stablekeypoints_tpu_torch.data.registry
import stablekeypoints_tpu_torch.data.celeba
import stablekeypoints_tpu_torch.data.cub
import stablekeypoints_tpu_torch.data.cub_parts
import stablekeypoints_tpu_torch.data.custom
import stablekeypoints_tpu_torch.data.deepfashion
import stablekeypoints_tpu_torch.data.human36m
import stablekeypoints_tpu_torch.data.taichi
import stablekeypoints_tpu_torch.data.unaligned_human36m
import stablekeypoints_tpu_torch.pipeline.ensemble_loop
import stablekeypoints_tpu_torch.pipeline.evaluate
import stablekeypoints_tpu_torch.pipeline.metrics
import stablekeypoints_tpu_torch.pipeline.regressor
import stablekeypoints_tpu_torch.pipeline.generate
import stablekeypoints_tpu_torch.pipeline.visualize
import stablekeypoints_tpu_torch.ops.extras
import stablekeypoints_tpu_torch.models.scheduler
import stablekeypoints_tpu_torch.models.weights
import stablekeypoints_tpu_torch.utils.checkpoint
import stablekeypoints_tpu_torch.pipeline.indices as indices
import stablekeypoints_tpu_torch.pipeline.optimize as optimize
from stablekeypoints_tpu_torch.config import Config
from stablekeypoints_tpu_torch.data.synthetic import SyntheticBlobs
from stablekeypoints_tpu_torch.models.unet import tiny_unet_config
from stablekeypoints_tpu_torch.models.vae import tiny_vae_config
from stablekeypoints_tpu_torch.pipeline.runtime import Runtime
cfg = Config(image_size=64, num_tokens=16, feature_upsample_res=16, top_k=4,
             furthest_point_num_samples=8, batch_size=2, num_steps=2, num_indices=2,
             dtype="float32")
rt = Runtime.create(cfg, tiny_unet_config(), tiny_vae_config(), device="cpu")
data = SyntheticBlobs(length=2, image_size=64)
ctx = optimize.optimize_embedding(rt, data)
assert ctx.shape == (1, 16, 32), ctx.shape
assert indices.find_best_indices(rt, data, ctx).shape == (4,)
rt.schedule = stablekeypoints_tpu_torch.models.scheduler.DDIMSchedule.create(2)
images, _ = stablekeypoints_tpu_torch.pipeline.generate.generate_images(
    rt, ctx, 1, guidance_scale=2.0)
assert images.shape == (1, 64, 64, 3), images.shape
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "flax", "optax", "PIL", "matplotlib"))
             or m == "stablekeypoints_tpu" or m.startswith("stablekeypoints_tpu."))
print("IMPORTED", bad)
sys.exit(1 if bad else 0)
"""


_CHILD_MESH_NATIVE = """
import sys
from stablekeypoints_tpu_torch.parallel import mesh
from stablekeypoints_tpu_torch.utils import native
m = mesh.make_mesh(-1, device="cpu")
assert (m.rank, m.world, m.group) == (0, 1, None)
native.available()
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "jaxlib", "flax", "optax"))
             or k == "stablekeypoints_tpu" or k.startswith("stablekeypoints_tpu."))
print("IMPORTED", bad)
sys.exit(1 if bad else 0)
"""


def test_mesh_and_native_import_no_jax():
    """parallel/mesh.py and utils/native.py (a mesh made, the native
    library loaded) import no JAX and nothing of the JAX package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", _CHILD_MESH_NATIVE], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "IMPORTED []" in r.stdout
    for rel in ("parallel/mesh.py", "utils/native.py"):
        with open(os.path.join(REPO, "stablekeypoints_tpu_torch", rel)) as f:
            src = f.read()
        assert "import jax" not in src and "stablekeypoints_tpu." not in src, rel


_CHILD_TENSOR = """
import sys
import torch
from stablekeypoints_tpu_torch.parallel import tensor
from stablekeypoints_tpu_torch.models.unet import UNet, sdxl_tiny_config
cfg = sdxl_tiny_config()
with torch.device("meta"):
    unet = UNet(cfg, tensor.ModelAxis(0, 2))
assert unet.axis is not None and tensor.split_plan(cfg, 2)
assert tensor.predicted_all_reduces(cfg, 2, 8, 16, True, True)["forward"] > 0
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "jaxlib", "flax", "optax"))
             or k == "stablekeypoints_tpu" or k.startswith("stablekeypoints_tpu."))
print("IMPORTED", bad)
sys.exit(1 if bad else 0)
"""


def test_tensor_parallel_imports_no_jax():
    """parallel/tensor.py (a split UNet built, its plan and its predicted
    all-reduces) and tools/tensor_parallel_scaling.py import no JAX and
    nothing of the JAX package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", _CHILD_TENSOR], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "IMPORTED []" in r.stdout
    for rel in ("stablekeypoints_tpu_torch/parallel/tensor.py",
                "tools/tensor_parallel_scaling.py"):
        with open(os.path.join(REPO, rel)) as f:
            src = f.read()
        assert "import jax" not in src and "stablekeypoints_tpu." not in src, rel


def test_training_imports_no_jax_and_no_pil():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", _CHILD_TRAIN], capture_output=True, text=True,
                       cwd=REPO, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "IMPORTED []" in r.stdout


def test_chip_smoke_imports_no_jax_and_needs_a_card(tmp_path):
    """chip_smoke.py fails without a card, and alone (no repo beside it)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                       cwd=REPO, env=env, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                       cwd=tmp_path, env=env, timeout=300)
    assert r.returncode != 0 and '"ok": true' not in r.stdout
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        src = f.read()
    assert "import jax" not in src and "stablekeypoints_tpu." not in src


def test_runtime_create_needs_a_gpu_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Runtime.create(Config(**TINY), tiny_unet_config(), tiny_vae_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KeypointModel.load("unused", Config(**TINY))


def test_served_detector_needs_a_gpu_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from stablekeypoints_tpu_torch.serving import ServedDetector, export_detector

    rt = Runtime.create(Config(**TINY), tiny_unet_config(), tiny_vae_config(), device="cpu")
    export_detector(rt, rt.init_context(), np.arange(4), str(tmp_path), batch=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServedDetector.load(str(tmp_path))
    det = ServedDetector.load(str(tmp_path), device="cpu")
    assert det.runtime.device.type == "cpu" and det.programs[1].graph is None


def test_training_needs_a_gpu_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = Config(**TINY, batch_size=2, furthest_point_num_samples=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Runtime.create(cfg, tiny_unet_config(), tiny_vae_config())
    rt = Runtime.create(cfg, tiny_unet_config(), tiny_vae_config(), device="cpu")
    context = rt.train_context()
    assert context.device.type == "cpu" and context.requires_grad and context.is_leaf
    images = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    _, _, aux = rt.train_step(context, rt.optimizer(context), images,
                              generator=torch.Generator().manual_seed(0))
    assert all(np.isfinite(float(v)) for v in aux.values())
    with pytest.raises(ValueError, match="optimizer"):
        rt.train_step(rt.train_context(), rt.optimizer(context), images)


def _meta_grad(*shape):
    return torch.empty(*shape, device="meta", dtype=torch.bfloat16, requires_grad=True)


# d 96 passes the JAX gates (flash and the resident cross band take head dims
# up to 128 and 160) but no kernel is built for it: the wrappers must raise
@pytest.mark.parametrize("call", [
    lambda m: attn_capture.capture_attention_fused(m(1, 2, 4, 2, 96), m(4, 2), m(1, 8, 2, 96), 0.1),
    lambda m: attn_capture.capture_attention_fused_bwd(
        m(1, 2, 4, 2, 80), m(256, 2), m(1, 8, 2, 80), m(1, 1024, 8).float(), 0.1),
    lambda m: attn_capture.capture_attention_fused_bwd(
        m(1, 2, 4, 2, 96), m(4, 2), m(1, 8, 2, 96), m(1, 16, 8).float(), 0.1, precise=True),
    lambda m: cross_attn.cross_attention_resident(m(1, 64, 2, 96), m(1, 8, 2, 96),
                                                  m(1, 8, 2, 96), 0.1),
    lambda m: cross_attn.cross_attention_resident_bwd(m(1, 64, 2, 96), m(1, 8, 2, 96),
                                                      m(1, 8, 2, 96), m(1, 64, 2, 96), 0.1),
    lambda m: flash.flash_self_attention(m(1, 64, 2, 96), m(1, 64, 2, 96), m(1, 64, 2, 96), 0.1,
                                         with_lse=True),
    lambda m: flash.flash_self_attention(m(1, 64, 1, 512), m(1, 64, 1, 512), m(1, 64, 1, 512),
                                         0.1, with_lse=True),
    lambda m: flash.flash_cross_attention_bwd(
        m(1, 64, 2, 512), m(1, 8, 2, 512), m(1, 8, 2, 512), m(1, 64, 2, 512),
        m(1, 64, 2, 512), m(1, 2, 64).float(), 0.1),
    lambda m: attn_capture.capture_attention(m(1, 2, 144, 96), m(1, 8, 2, 96), 0.1),
    lambda m: attn_capture.capture_attention_bwd(
        m(1, 2, 144, 96), m(1, 8, 2, 96), m(1, 144, 8).float(), 0.1, precise=True),
], ids=["capture_d96", "capture_bwd_256_cols", "capture_bwd_precise", "cross_d96",
        "cross_bwd_d96", "flash_self_d96", "flash_self_d512_lse", "flash_cross_bwd_d512",
        "capture_unfused_d96", "capture_unfused_bwd_precise"])
def test_grad_wrappers_raise_for_shapes_no_kernel_takes(call):
    """Inputs that require grad pass the wrappers' checks now; a shape or
    head dim that no kernel takes still raises before any launch, with
    capture_fp32_bwd (the precise backward kernels) too."""
    with pytest.raises(NotImplementedError):
        call(_meta_grad)


class _CudaLike:
    """Stands in for a CUDA tensor in `check_kernel_inputs` (no card here)."""

    def __init__(self, requires_grad):
        self.device, self.dtype, self.requires_grad = torch.device("cuda", 0), torch.bfloat16, requires_grad

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 256


def test_only_the_forward_only_kernel_rejects_grads():
    from stablekeypoints_tpu_torch.kernels._common import check_kernel_inputs

    x, w = _CudaLike(True), _CudaLike(False)
    with pytest.raises(RuntimeError, match="forward-only"):
        groupnorm._check("fused_group_norm", x, w, w)  # K6
    with pytest.raises(RuntimeError, match="forward-only"):
        check_kernel_inputs("fused_gn_silu_conv3x3", x, w)  # K7's check, as its wrapper calls it
    check_kernel_inputs("attention", x, w, allow_grad=True)  # K1/K2/K3/K4/K5


@pytest.mark.parametrize("kernel", ["capture", "cross", "flash_self", "flash_cross", "groupnorm",
                                    "capture_unfused", "capture_unfused_bwd", "gn_conv"])
def test_wrappers_raise_instead_of_falling_back(kernel):
    """Meta tensors stand in for device tensors here: any non-CPU input goes
    to the kernel path, whose checks reject it before a launch."""
    meta = lambda *s: torch.empty(*s, device="meta", dtype=torch.bfloat16)  # noqa: E731
    calls = {
        "capture": lambda: attn_capture.capture_attention_fused(
            meta(1, 2, 4, 2, 80), meta(4, 2), meta(1, 8, 2, 80), 0.1),
        "cross": lambda: cross_attn.cross_attention_resident(
            meta(1, 64, 2, 40), meta(1, 8, 2, 40), meta(1, 8, 2, 40), 0.1),
        "flash_self": lambda: flash.flash_self_attention(
            meta(1, 64, 2, 40), meta(1, 64, 2, 40), meta(1, 64, 2, 40), 0.1),
        "flash_cross": lambda: flash.flash_cross_attention(
            meta(1, 64, 2, 40), meta(1, 8, 2, 40), meta(1, 8, 2, 40), 0.1),
        "groupnorm": lambda: groupnorm.fused_group_norm(
            meta(1, 8, 8, 128), torch.ones(128), torch.zeros(128), 32, 1e-6, "silu"),
        "capture_unfused": lambda: attn_capture.capture_attention(
            meta(1, 2, 144, 80), meta(1, 8, 2, 80), 0.1),
        "capture_unfused_bwd": lambda: attn_capture.capture_attention_bwd(
            meta(1, 2, 144, 80), meta(1, 8, 2, 80), meta(1, 144, 8).float(), 0.1),
        "gn_conv": lambda: gn_conv.fused_gn_silu_conv3x3(
            meta(1, 8, 8, 128), *(meta(1, 128).float() for _ in range(3)),
            meta(3, 3, 128, 128), meta(128)),
    }
    with pytest.raises(ValueError, match="CUDA device"):
        calls[kernel]()


@pytest.mark.parametrize("n,d,context,res,error", [
    (1024, 96, False, None, NotImplementedError),  # flash band, a head dim the kernel is not built for
    (4096, 96, True, None, NotImplementedError),  # resident cross band
    (1024, 96, True, None, NotImplementedError),  # masked flash band
    # d 64 (SD-2.x, SDXL): the kernels take it, and reject the meta (not CUDA) tensor
    (1024, 64, False, None, ValueError),
    (4096, 64, True, None, ValueError),
    (1024, 64, True, None, ValueError),
    (256, 64, True, 128, ValueError),  # the capture at d 64 (K1's wrapper)
    # a capture grid the JAX package gives its unfused kernel: K2's wrapper
    # takes the shape and rejects the meta (not CUDA) tensor
    (256, 80, True, 96, ValueError),
])
def test_layer_routing_raises_off_the_cpu(n, d, context, res, error):
    """Wherever the JAX layer runs a kernel, the port's layer calls a kernel
    wrapper, which raises for what its kernel does not take: a tensor that
    is not on the CPU never reaches the plain einsum path."""
    from stablekeypoints_tpu_torch.models.layers import CrossAttention

    with torch.device("meta"):
        layer = CrossAttention(d, 1, d, context_dim=16 if context else None,
                               pallas_capture=True, flash=True)
        x = torch.empty(1, n, d)
        ctx = torch.empty(1, 500, 16) if context else None
    with pytest.raises(error):
        layer(x, ctx, capture_res=res)


def test_kernel_flags_take_auto_on_off():
    with pytest.raises(ValueError, match="flash_attention"):
        Runtime.create(Config(**TINY, flash_attention="yes"), device="cpu")


@pytest.mark.parametrize("override", [
    dict(model_type="stabilityai/stable-diffusion-2-1"),
    dict(model_type="stabilityai/stable-diffusion-2-base"),
    dict(model_type="sd2-768"),
    dict(model_type="stabilityai/stable-diffusion-xl-base-1.0"),
])
def test_unported_options_raise(override):
    """SD-2.x and SDXL model types raised until they were ported; now each
    builds the JAX package's UNet configuration (its fields, the TPU knobs
    aside) and Runtime.create picks the JAX VAE scale for it. The UNet is
    given tiny here (the model type's own one is full width)."""
    import dataclasses

    from stablekeypoints_tpu.models import vae as jax_vae
    from stablekeypoints_tpu.pipeline.runtime import unet_config_for_model_type as jax_pick
    from stablekeypoints_tpu_torch.pipeline.runtime import unet_config_for_model_type

    mt = override["model_type"]
    got, want = unet_config_for_model_type(mt), jax_pick(mt)
    fields = [f.name for f in dataclasses.fields(got)]
    assert {f: getattr(got, f) for f in fields} == {f: getattr(want, f) for f in fields}
    assert got.head_dim_fixed == 64 and got.prediction_type == (
        "epsilon" if "base" in mt or "xl" in mt else "v_prediction")
    rt = Runtime.create(Config(**TINY, **override), tiny_unet_config(), device="cpu")
    jax_scale = (jax_vae.SDXL_VAE_CONFIG if "xl" in mt else jax_vae.SD_VAE_CONFIG).scaling_factor
    assert rt.vae.config.scaling_factor == jax_scale


def test_model_path_without_weights_raises(tmp_path):
    """A checkpoint directory is loaded, never replaced by random weights."""
    with pytest.raises(FileNotFoundError):
        Runtime.create(Config(**TINY, model_path="/nonexistent"), tiny_unet_config(),
                       tiny_vae_config(), device="cpu")
    (tmp_path / "unet").mkdir()
    with pytest.raises(FileNotFoundError, match="no safetensors/bin"):
        Runtime.create(Config(**TINY, model_path=str(tmp_path)), tiny_unet_config(),
                       tiny_vae_config(), device="cpu")


def test_keypoint_model_save_load_detect(tmp_path):
    cfg = Config(**TINY)
    rt = Runtime.create(cfg, tiny_unet_config(), tiny_vae_config(), device="cpu")
    model = KeypointModel(rt, rt.init_context().numpy(), np.array([1, 5, 2, 9]))
    model.save(str(tmp_path))
    loaded = KeypointModel.load(str(tmp_path), cfg, runtime=rt)
    np.testing.assert_array_equal(loaded.indices, [1, 5, 2, 9])
    imgs = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    pts = loaded.detect_batch(imgs)
    assert pts.shape == (2, 4, 2) and np.isfinite(pts).all()
    assert (pts >= 0).all() and (pts <= 1).all()
    np.testing.assert_array_equal(loaded.detect(imgs[1]), loaded.detect_batch(imgs[1:])[0])
    maps = loaded.heatmaps(imgs[0])
    assert maps.shape == (4, 64, 64) and np.isfinite(maps).all()
