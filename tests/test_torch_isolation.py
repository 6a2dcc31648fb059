"""The port stands alone and runs on the card unless asked otherwise.

- Importing `stablekeypoints_tpu_torch` and running its CPU slices
  (detection, training) leaves `jax`, the JAX package and PIL out of
  `sys.modules` (a fresh interpreter).
- Entry points refuse to run without a GPU unless given device="cpu".
- A kernel wrapper given a tensor that is not on the CPU launches its
  kernel or raises; it never falls back to the plain version. The
  attention kernels' wrappers take inputs that require grad (they run
  inside autograd Functions); K6 is forward-only and rejects them.
- Knobs whose kernel or feature is not ported yet raise.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from stablekeypoints_tpu_torch.api import KeypointModel
from stablekeypoints_tpu_torch.config import Config
from stablekeypoints_tpu_torch.kernels import attn_capture, cross_attn, flash, groupnorm
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
import stablekeypoints_tpu_torch.pipeline.optimize as optimize
from stablekeypoints_tpu_torch.config import Config
from stablekeypoints_tpu_torch.data.synthetic import SyntheticBlobs
from stablekeypoints_tpu_torch.models.unet import tiny_unet_config
from stablekeypoints_tpu_torch.models.vae import tiny_vae_config
from stablekeypoints_tpu_torch.pipeline.runtime import Runtime
cfg = Config(image_size=64, num_tokens=16, feature_upsample_res=16, top_k=4,
             furthest_point_num_samples=8, batch_size=2, num_steps=2, dtype="float32")
rt = Runtime.create(cfg, tiny_unet_config(), tiny_vae_config(), device="cpu")
ctx = optimize.optimize_embedding(rt, SyntheticBlobs(length=2, image_size=64))
assert ctx.shape == (1, 16, 32), ctx.shape
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "flax", "optax", "PIL"))
             or m == "stablekeypoints_tpu" or m.startswith("stablekeypoints_tpu."))
print("IMPORTED", bad)
sys.exit(1 if bad else 0)
"""


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


@pytest.mark.parametrize("call", [
    lambda m: attn_capture.capture_attention_fused(m(1, 2, 4, 2, 64), m(4, 2), m(1, 8, 2, 64), 0.1),
    lambda m: attn_capture.capture_attention_fused_bwd(
        m(1, 2, 4, 2, 80), m(256, 2), m(1, 8, 2, 80), m(1, 1024, 8).float(), 0.1),
    lambda m: attn_capture.capture_attention_fused_bwd(
        m(1, 2, 4, 2, 80), m(4, 2), m(1, 8, 2, 80), m(1, 16, 8).float(), 0.1, precise=True),
    lambda m: cross_attn.cross_attention_resident(m(1, 64, 2, 64), m(1, 8, 2, 64),
                                                  m(1, 8, 2, 64), 0.1),
    lambda m: cross_attn.cross_attention_resident_bwd(m(1, 64, 2, 64), m(1, 8, 2, 64),
                                                      m(1, 8, 2, 64), m(1, 64, 2, 64), 0.1),
    lambda m: flash.flash_self_attention(m(1, 64, 2, 64), m(1, 64, 2, 64), m(1, 64, 2, 64), 0.1,
                                         with_lse=True),
    lambda m: flash.flash_self_attention(m(1, 64, 1, 512), m(1, 64, 1, 512), m(1, 64, 1, 512),
                                         0.1, with_lse=True),
    lambda m: flash.flash_cross_attention_bwd(
        m(1, 64, 2, 512), m(1, 8, 2, 512), m(1, 8, 2, 512), m(1, 64, 2, 512),
        m(1, 64, 2, 512), m(1, 2, 64).float(), 0.1),
], ids=["capture_d64", "capture_bwd_256_cols", "capture_bwd_precise", "cross_d64",
        "cross_bwd_d64", "flash_self_d64", "flash_self_d512_lse", "flash_cross_bwd_d512"])
def test_grad_wrappers_raise_for_shapes_no_kernel_takes(call):
    """Inputs that require grad pass the wrappers' checks now; a shape, head
    dim or option that no kernel takes still raises before any launch."""
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
    check_kernel_inputs("attention", x, w, allow_grad=True)  # K1/K3/K4/K5


@pytest.mark.parametrize("kernel", ["capture", "cross", "flash_self", "flash_cross", "groupnorm"])
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
    }
    with pytest.raises(ValueError, match="CUDA device"):
        calls[kernel]()


@pytest.mark.parametrize("n,d,context,res", [
    (1024, 64, False, None),  # flash band, a head dim the kernel is not built for
    (4096, 64, True, None),  # resident cross band
    (1024, 64, True, None),  # masked flash band
    (256, 80, True, 96),  # a capture grid the JAX package gives its unfused kernel
])
def test_layer_routing_raises_off_the_cpu(n, d, context, res):
    """Wherever the JAX layer runs a kernel, the port's layer calls a kernel
    wrapper, which raises for what its kernel does not take: a tensor that
    is not on the CPU never reaches the plain einsum path."""
    from stablekeypoints_tpu_torch.models.layers import CrossAttention

    with torch.device("meta"):
        layer = CrossAttention(d, 1, d, context_dim=16 if context else None,
                               pallas_capture=True, flash=True)
        x = torch.empty(1, n, d)
        ctx = torch.empty(1, 500, 16) if context else None
    with pytest.raises(NotImplementedError):
        layer(x, ctx, capture_res=res)


def test_kernel_flags_take_auto_on_off():
    with pytest.raises(ValueError, match="flash_attention"):
        Runtime.create(Config(**TINY, flash_attention="yes"), device="cpu")


@pytest.mark.parametrize("override", [
    dict(fused_gn_conv="on"), dict(model_path="/nonexistent"), dict(latent_warp=True),
    dict(model_type="stabilityai/stable-diffusion-xl-base-1.0"),
])
def test_unported_options_raise(override):
    with pytest.raises(NotImplementedError):
        Runtime.create(Config(**TINY, **override), device="cpu")


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
