"""The port stands alone and runs on the card unless asked otherwise.

- Importing `stablekeypoints_tpu_torch` and running its CPU slice leaves
  `jax` and the JAX package out of `sys.modules` (a fresh interpreter).
- Entry points refuse to run without a GPU unless given device="cpu".
- A kernel wrapper given a tensor that is not on the CPU launches its
  kernel or raises; it never falls back to the plain version.
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
