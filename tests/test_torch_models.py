"""The port's UNet captures and VAE latents vs the JAX models, on the tiny
topologies in fp32, with the JAX parameters carried across through
`from_jax_params`.

Tolerances: captured maps are softmax head-means; with the x30 context the
logits reach O(10), so fp32 rounding of the logits moves the
probabilities by ~1e-5 relative (measured 8e-6): rtol 5e-5, atol 5e-6.
Latents are O(1e-2) (measured agreement ~2e-8): 1e-6 absolute leaves
fp32 summation-order room through ~20 convolutions.
"""

import torch_threads  # noqa: F401  (torch's threads: this xdist worker's share)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablekeypoints_tpu.models.unet import UNet as JaxUNet
from stablekeypoints_tpu.models.unet import tiny_unet_config as jax_tiny_unet
from stablekeypoints_tpu.models.vae import VAE as JaxVAE
from stablekeypoints_tpu.models.vae import tiny_vae_config as jax_tiny_vae
from stablekeypoints_tpu.models import weights as jw
from stablekeypoints_tpu_torch.models import weights as tw
from stablekeypoints_tpu_torch.models.unet import UNet, tiny_unet_config
from stablekeypoints_tpu_torch.models.vae import VAE, tiny_vae_config


@pytest.fixture(scope="module")
def jax_params():
    unet = jw.init_unet_params_fast(0, jax_tiny_unet(), 8)
    vae = jw.init_vae_params_fast(1, jax_tiny_vae(), 32)
    return unet, vae


@pytest.fixture(scope="module")
def port_models(jax_params):
    usd, vsd = tw.from_jax_params(*jax_params)
    unet, vae = UNet(tiny_unet_config()), VAE(tiny_vae_config())
    unet.load_state_dict(usd, strict=True)
    vae.load_state_dict(vsd, strict=True)
    return tw.cast_module(unet, torch.float32).eval(), tw.cast_module(vae, torch.float32).eval()


def test_from_jax_params_layouts(jax_params):
    usd, vsd = tw.from_jax_params(*jax_params)
    conv = np.asarray(jax_params[0]["conv_in"]["kernel"])  # HWIO
    np.testing.assert_array_equal(usd["conv_in.weight"].numpy(), conv.transpose(3, 2, 0, 1))
    dense = np.asarray(jax_params[0]["time_embedding"]["linear_1"]["kernel"])  # [in, out]
    np.testing.assert_array_equal(usd["time_embedding.linear_1.weight"].numpy(), dense.T)
    assert "down_0.resnets_0.norm1.weight" in usd  # scale -> weight
    assert {k.split(".")[0] for k in vsd} == {"encoder", "decoder"}  # the decoder too


@pytest.mark.parametrize("truncate", [True, False])
def test_unet_captures_match(jax_params, port_models, truncate):
    rng = np.random.default_rng(0)
    noisy = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ts = np.array([1, 1], np.int32)
    ctx = (30 * rng.standard_normal((2, 16, 32))).astype(np.float32)
    unet = JaxUNet(jax_tiny_unet(), dtype=jnp.float32)
    eps_j, cap_j = jax.jit(lambda p, x, t, c: unet.apply(
        {"params": p}, x, t, c, capture_res=16, truncate=truncate
    ))(jax_params[0], noisy, ts, ctx)
    with torch.no_grad():
        eps_t, cap_t = port_models[0](torch.from_numpy(noisy), torch.from_numpy(ts),
                                      torch.from_numpy(ctx), capture_res=16, truncate=truncate)
    assert len(cap_t) == len(cap_j) == 4
    for a, b in zip(cap_j, cap_t):
        assert b.shape == (2, 256, 16)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=5e-5, atol=5e-6)
    if truncate:
        assert eps_t is None and eps_j is None
    else:
        np.testing.assert_allclose(eps_t.numpy(), np.asarray(eps_j), atol=1e-5)


def test_vae_latents_match(jax_params, port_models):
    rng = np.random.default_rng(1)
    img = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    vae = JaxVAE(jax_tiny_vae(), dtype=jnp.float32)
    want = jax.jit(lambda p, x: vae.apply({"params": p}, x, method=JaxVAE.encode_mean))(
        jax_params[1], img
    )
    with torch.no_grad():
        got = port_models[1].encode_mean(torch.from_numpy(img))
    assert got.shape == (2, 4, 4, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
