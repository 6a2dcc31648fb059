"""Generation: the port's VAE decoder, DDIM step and `generate_images`
against the JAX package, on the CPU in fp32.

Weights are a JAX `Runtime`'s, carried across by `from_jax_params`; the
initial latents are drawn in the test with `jax.random.normal` from the
key the JAX `generate_images` draws them from, and handed to the port
(`latents=`). Both runtimes get the same 4-step schedule.

Tolerances (fp32 on both sides, sums in another order):
- decoded images: 1e-5 of their largest magnitude (measured ~1e-7 through
  ~15 convolutions, the attention and the upsamples);
- one DDIM step: 2e-6 absolute on O(1) latents (a few fp32 ulps);
- generated images in [0, 1]: 1e-4 absolute, and the final-step maps 1e-5
  absolute (4 full UNet forwards with guidance, whose differences the DDIM
  update carries and the decoder amplifies; measured <= ~1e-6);
- the 3x3 conv against JAX `Conv3x3Split`: 1e-5 of the largest magnitude
  (fp32 sums over 576 products in another order).
"""

import torch_threads  # noqa: F401  (torch's threads: this xdist worker's share)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablekeypoints_tpu.config import Config as JaxConfig
from stablekeypoints_tpu.models import weights as jw
from stablekeypoints_tpu.models.layers import Conv3x3Split, Downsample as JaxDownsample
from stablekeypoints_tpu.models.scheduler import DDIMSchedule as JaxSchedule
from stablekeypoints_tpu.models.unet import tiny_unet_config as jax_tiny_unet
from stablekeypoints_tpu.models.vae import VAE as JaxVAE
from stablekeypoints_tpu.models.vae import VAEConfig as JaxVAEConfig
from stablekeypoints_tpu.models.vae import tiny_vae_config as jax_tiny_vae
from stablekeypoints_tpu.parallel import mesh as pmesh
from stablekeypoints_tpu.pipeline import generate as jgen
from stablekeypoints_tpu.pipeline.runtime import Runtime as JaxRuntime
from stablekeypoints_tpu_torch.config import Config
from stablekeypoints_tpu_torch.models import layers
from stablekeypoints_tpu_torch.models import weights as tw
from stablekeypoints_tpu_torch.models.layers import Conv2d, Downsample
from stablekeypoints_tpu_torch.models.scheduler import DDIMSchedule
from stablekeypoints_tpu_torch.models.unet import tiny_unet_config
from stablekeypoints_tpu_torch.models.vae import VAE, VAEConfig, tiny_vae_config
from stablekeypoints_tpu_torch.pipeline import generate
from stablekeypoints_tpu_torch.pipeline.runtime import Runtime

SIZE = dict(image_size=64, num_tokens=16, feature_upsample_res=16, dtype="float32")
STEPS = 4


def _count(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("fused", [False, True])
def test_decoder_matches_jax(monkeypatch, fused):
    """Channels 128/256 and 8^2 latents, so with routing on every resnet conv
    passes K7's gate (the 256 -> 128 level through a shortcut) and both
    GroupNorm applies K6's; the CPU runs each kernel's plain version, JAX
    its kernels in interpret mode."""
    jcfg = JaxVAEConfig(block_channels=(128, 256), layers_per_block=1)
    params = jw.init_vae_params_fast(3, jcfg, 16)
    jvae = JaxVAE(jcfg, dtype=jnp.float32, fused_gn=fused, fused_gn_interpret=True,
                  fused_gn_conv=fused)
    z = np.random.default_rng(4).standard_normal((2, 8, 8, 4)).astype(np.float32) * 0.2
    want = np.asarray(jax.jit(lambda p, x: jvae.apply({"params": p}, x, method=JaxVAE.decode))(
        params, z))
    vae = VAE(VAEConfig(block_channels=(128, 256), layers_per_block=1), fused_gn=fused,
              fused_gn_conv=fused)
    tw.copy_state(vae, tw.from_jax_params({}, params)[1])
    vae = tw.cast_module(vae, torch.float32).eval()
    k7 = _count(monkeypatch, layers.k_gn_conv, "fused_gn_silu_conv3x3")
    k6 = _count(monkeypatch, layers.k_gn, "fused_group_norm")
    with torch.no_grad():
        got = vae.decode(torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    # 6 resnets (mid x2, two a level) x 2 convs; the mid attention's norm and conv_norm_out
    assert (len(k7), len(k6)) == ((12, 2) if fused else (0, 0))


def test_tiny_vae_decode_matches_jax():
    """The tests' tiny VAE (16-32 channels: nothing routes to a kernel)."""
    params = jw.init_vae_params_fast(5, jax_tiny_vae(), 32)
    jvae = JaxVAE(jax_tiny_vae(), dtype=jnp.float32)
    z = np.random.default_rng(6).standard_normal((1, 4, 4, 4)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jvae.apply({"params": p}, x, method=JaxVAE.decode))(
        params, z))
    vae = VAE(tiny_vae_config())
    tw.copy_state(vae, tw.from_jax_params({}, params)[1])
    with torch.no_grad():
        got = vae.decode(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("step_index", [0, 2, 49])
def test_ddim_step_matches_jax(step_index):
    """The 50-step schedule; index 49 is the last step (previous alpha
    alphas_cumprod[0])."""
    rng = np.random.default_rng(step_index)
    eps, lat = (rng.standard_normal((2, 8, 8, 4)).astype(np.float32) for _ in range(2))
    want = np.asarray(JaxSchedule.create().ddim_step(jnp.asarray(eps), jnp.asarray(lat),
                                                     step_index))
    got = DDIMSchedule.create().ddim_step(torch.from_numpy(eps), torch.from_numpy(lat),
                                          step_index).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_v_to_eps_identity():
    rng = np.random.default_rng(0)
    x0, eps = (rng.standard_normal((2, 4, 4, 4)).astype(np.float32) for _ in range(2))
    a = np.float32(0.37)
    lat = np.sqrt(a) * x0 + np.sqrt(1 - a) * eps
    v = np.sqrt(a) * eps - np.sqrt(1 - a) * x0
    got = generate.v_to_eps(torch.from_numpy(v), torch.from_numpy(lat), a).numpy()
    np.testing.assert_allclose(got, eps, atol=1e-5)
    want = np.asarray(jgen.v_to_eps(jnp.asarray(v), jnp.asarray(lat), a))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def runtimes():
    jrt = JaxRuntime.create(JaxConfig(jax_cache_dir="", **SIZE), jax_tiny_unet(), jax_tiny_vae(),
                            mesh=pmesh.make_mesh(1))
    jrt.schedule = JaxSchedule.create(STEPS)
    rt = Runtime.create(Config(**SIZE), tiny_unet_config(), tiny_vae_config(), device="cpu")
    rt.load_weights(*tw.from_jax_params(jax.device_get(jrt.unet_params),
                                        jax.device_get(jrt.vae_params)))
    rt.schedule = DDIMSchedule.create(STEPS)
    return jrt, rt


@pytest.mark.parametrize("guidance,capture", [(1.0, True), (3.0, False)])
def test_generate_images_matches_jax(runtimes, guidance, capture):
    jrt, rt = runtimes
    rng = np.random.default_rng(8)
    ctx = (rng.standard_normal((1, 16, 32)) * 3).astype(np.float32)
    uncond = (rng.standard_normal((1, 77, 32)) * 0.5).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want_img, want_maps = jgen.generate_images(jrt, jnp.asarray(ctx), 2, key=key,
                                               capture_final_maps=capture,
                                               guidance_scale=guidance,
                                               uncond_context=jnp.asarray(uncond))
    latents = np.array(jax.random.normal(key, (2, 8, 8, 4), jnp.float32))
    got_img, got_maps = generate.generate_images(rt, ctx, capture_final_maps=capture,
                                                 guidance_scale=guidance, uncond_context=uncond,
                                                 latents=latents)
    assert got_img.shape == want_img.shape == (2, 64, 64, 3)
    assert (got_img >= 0).all() and (got_img <= 1).all()
    np.testing.assert_allclose(got_img, want_img, rtol=0, atol=1e-4)
    assert 0.05 < np.ptp(want_img)  # the images are not flat (clipped) everywhere
    if capture:
        assert got_maps.shape == want_maps.shape == (2, 16, 16, 16)
        np.testing.assert_allclose(got_maps, want_maps, rtol=0, atol=1e-5)
    else:
        assert got_maps is None and want_maps is None


def test_generate_guidance_one_skips_the_uncond_forward(runtimes, monkeypatch):
    """Guidance 1.0 runs one UNet forward a step, guidance != 1 two; the
    default uncond context is zeros [1, 77, d]."""
    _, rt = runtimes
    seen = []
    real = rt.unet.forward

    def forward(latents, ts, context, *a, **k):
        seen.append(context.shape[1])
        return real(latents, ts, context, *a, **k)

    monkeypatch.setattr(rt.unet, "forward", forward)
    ctx = np.ones((1, 16, 32), np.float32)
    gen = torch.Generator().manual_seed(0)
    img, _ = generate.generate_images(rt, ctx, 1, generator=gen)
    assert seen == [16] * STEPS and img.shape == (1, 64, 64, 3)
    seen.clear()
    generate.generate_images(rt, ctx, 1, generator=gen, guidance_scale=2.0)
    assert seen == [16, 77] * STEPS


@pytest.mark.parametrize("stride", [1, 2])
def test_plain_conv_matches_conv3x3_split(stride):
    """The port runs a plain conv where JAX runs `Conv3x3Split` (H-slabs
    folded into the batch: 4 parts at these shapes) and its stride-2
    asymmetric-pad downsample form."""
    size = 128 * stride
    x = np.random.default_rng(stride).standard_normal((1, size, size, 64)).astype(np.float32)
    if stride == 1:
        jmod = Conv3x3Split(64, dtype=jnp.float32)
        port = Conv2d(64, 64, 3)
    else:
        jmod = JaxDownsample(64, asymmetric_pad=True, dtype=jnp.float32, split_conv=True)
        port = Downsample(64, asymmetric_pad=True)
    params = jmod.init(jax.random.PRNGKey(stride), x)["params"]
    params = jax.tree_util.tree_map(
        lambda p: p + 0.1 if p.ndim == 1 else p, params)  # a nonzero bias
    want = np.asarray(jax.jit(lambda p, v: jmod.apply({"params": p}, v))(params, x))
    if stride == 1:
        params = {"conv": params}
        port = torch.nn.ModuleDict({"conv": port})
    tw.copy_state(port, tw.from_jax_params(params, {})[0])
    with torch.no_grad():
        got = (port["conv"] if stride == 1 else port)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 128, 128, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_generate_cli_writes_pngs(tmp_path, runtimes):
    """`main` loads the embedding and saves generated_{i:03d}.png."""
    from stablekeypoints_tpu_torch.utils.artifacts import save_artifact

    _, rt = runtimes
    save_artifact(str(tmp_path), "embedding", np.zeros((1, 16, 32), np.float32))
    calls = []

    def create(cfg, device=None):
        calls.append((cfg.model_path, cfg.num_tokens, device))
        return dataclasses.replace(rt, cfg=dataclasses.replace(rt.cfg, seed=cfg.seed))

    import unittest.mock as mock

    with mock.patch.object(generate.Runtime, "create", staticmethod(create)):
        images = generate.main(["--save_folder", str(tmp_path), "--num_images", "2",
                                "--image_size", "64", "--device", "cpu"])
    assert calls == [(None, 16, "cpu")]
    assert images.shape == (2, 64, 64, 3)
    assert sorted(p.name for p in tmp_path.glob("generated_*.png")) == \
        ["generated_000.png", "generated_001.png"]
