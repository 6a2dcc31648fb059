"""Every head dim that the layers' routing rules send to K1-K5 is one the
kernel was compiled for.

On the CPU every wrapper takes its plain version, so a routing rule that
sends a head dim the CUDA kernel does not take (K3 at d 160 before it was
built, SD-1.5 at 1536^2) passes every CPU test and raises only on the card.
Here the full-width UNets and the VAE run on the `meta` device (shapes
only, no memory, no arithmetic) with the kernel entry points of
`models/layers.py` replaced by recorders, at each backbone's image sizes
that `chip_smoke.py` or the CLI drives: SD-1.5 at 512^2 (detect and
training, 128^2, 96^2 and 256^2 capture grids), at 768^2 and 1024^2
(training, whose captured d-160 layers hold 24 and 32 source columns) and
generation up to 2048^2; SD-2.x at 768^2 (and the 512^2 base model); SDXL
at 1024^2; each with the default 500 learned tokens and with 1000
(`--num_tokens`). Each recorded (kernel, head dim) must lie in that
kernel's `KERNEL_DIMS`, at the training sizes the flash kernels' head dims
in `BWD_DIMS` too, each fused capture's source columns, output columns and
tokens within the limits its forward and backward take, and each unfused
capture's tokens within its limit.
"""

import torch_threads  # noqa: F401  (torch's threads: this xdist worker's share)
import dataclasses

import pytest
import torch

from stablekeypoints_tpu_torch.kernels import attn_capture, cross_attn, flash
from stablekeypoints_tpu_torch.models import layers
from stablekeypoints_tpu_torch.models import vae as V
from stablekeypoints_tpu_torch.models.unet import SD15_CONFIG, SD21_CONFIG, SDXL_CONFIG, UNet

DIMS = {"cross": cross_attn.KERNEL_DIMS, "flash_self": flash.KERNEL_DIMS,
        "flash_cross": flash.KERNEL_DIMS, "capture": attn_capture.KERNEL_DIMS,
        "capture_unfused": attn_capture.KERNEL_DIMS}
BACKBONES = {"sd15": SD15_CONFIG, "sd21": SD21_CONFIG, "sdxl": SDXL_CONFIG}
# (backbone, image size, capture grids of its detect / training passes: () for
# generation only)
SIZES = [("sd15", 512, (128, 96, 256)), ("sd15", 768, (128,)), ("sd15", 1024, (128,)), ("sd15", 1536, ()),
         ("sd15", 2048, ()), ("sd21", 512, ()), ("sd21", 768, (128, 96)), ("sdxl", 1024, (128,))]


@pytest.fixture
def routed(monkeypatch):
    """(kernel, head dim) of every kernel call the layers route,
    ("capture_shape", (d, X, P, T)) of every fused capture and
    ("capture_unfused_tokens", T) of every unfused one."""
    calls = set()

    def attention(kind, q, k, v, scale):
        calls.add((kind, q.shape[-1]))
        return torch.empty_like(q)

    def capture(tt, ww, k, scale, precise=False, total_heads=None):
        calls.add(("capture", tt.shape[-1]))
        calls.add(("capture_shape", (tt.shape[-1], tt.shape[3], ww.shape[0], k.shape[1])))
        return torch.empty((tt.shape[0], tt.shape[2] * ww.shape[0], k.shape[1]), device=tt.device)

    def capture_unfused(q, k, scale, precise=False, total_heads=None):
        calls.add(("capture_unfused", q.shape[-1]))
        calls.add(("capture_unfused_tokens", k.shape[1]))
        return torch.empty((q.shape[0], q.shape[2], k.shape[1]), device=q.device)

    def vae_attention(q, k, v, scale):
        calls.add(("flash_self", q.shape[-1]))
        return torch.empty_like(q)

    monkeypatch.setattr(layers, "attention", attention)
    monkeypatch.setattr(layers, "capture_fn", capture)
    monkeypatch.setattr(layers, "capture_unfused_fn", capture_unfused)
    monkeypatch.setattr(V.k_flash, "flash_self_attention", vae_attention)
    return calls


@pytest.mark.parametrize("family,size,grids", SIZES)
def test_routed_head_dims_are_compiled(routed, family, size, grids):
    cfg = dataclasses.replace(BACKBONES[family], flash_attention=True, pallas_capture=True)
    with torch.device("meta"):
        unet = UNet(cfg).to(torch.bfloat16)
        vae = V.VAE(V.SD_VAE_CONFIG, flash=True).to(torch.bfloat16)
        lat = torch.empty((1, size // 8, size // 8, 4))
        ts = torch.zeros((1,), dtype=torch.int32)
        for tokens in (500, 1000, 77):  # the learned context (--num_tokens), the guidance's
            unet(lat, ts, torch.empty((1, tokens, cfg.context_dim)))
        vae.decode(lat)
        vae.encode_mean(torch.empty((1, size, size, 3)))
        generation = set(routed)
        for res in grids:  # the detect / training passes' capture forward
            for tokens in (500, 1000):
                unet(lat, ts, torch.empty((1, tokens, cfg.context_dim)), capture_res=res, truncate=True)
    if family == "sd15" and size >= 1536:  # the 1280-channel levels reach K3: (S / 32)^2 >= 2048
        assert ("cross", 160) in generation
    shapes = {d for kind, d in routed if kind == "capture_shape"}
    for d, x, p, t in shapes:
        assert x <= attn_capture.MAX_SRC and p <= attn_capture.MAX_COLS and t <= attn_capture.MAX_TOKENS, (
            f"{family} {size}^2: a fused capture at d {d}, X {x}, P {p}, {t} tokens")
    if family == "sd15" and size in (768, 1024):  # up_1 captured at X 24 / 32, 500 tokens
        assert (160, size // 32, 128, 500) in shapes
    if family == "sd15" and size == 512:  # 1000 tokens; 256 columns a row at the 256^2 grid
        assert {(160, 16, 128, 1000), (80, 32, 256, 500), (160, 16, 256, 1000)} <= shapes
    unfused = {t for kind, t in routed if kind == "capture_unfused_tokens"}
    assert all(t <= attn_capture.MAX_TOKENS for t in unfused), unfused
    if 96 in grids:
        assert 1000 in unfused
    for kind, d in sorted(routed - {("capture_shape", s) for s in shapes}
                          - {("capture_unfused_tokens", t) for t in unfused}):
        assert d in DIMS[kind], f"{family} {size}^2 routes head dim {d} to {kind}"
        if grids and kind.startswith("flash"):
            assert d in flash.BWD_DIMS or d == 512, f"{family} {size}^2: {kind} backward at d {d}"
