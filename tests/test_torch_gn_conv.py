"""K7 (fused GroupNorm-affine + SiLU + 3x3 conv + residual) in the port vs
the JAX package: the plain version against the JAX kernel in interpret
mode and its defining composition, the gate, the ResnetBlock routing and
the VAE encoder with the kernel on.

Tolerances: fp32 1e-5 absolute (both sides accumulate the conv in fp32 in
another order; outputs are O(1)), as tests/test_gn_conv.py holds the JAX
kernel to its composition. bf16: one bf16 ulp of the output's largest
magnitude (2^-7 relative): XLA does not round bf16 elementwise chains the
same way in every execution context (tests/test_gn_conv.py:48-66), and the
port's plain version rounds after every op. The VAE latents in fp32: 1e-5
absolute on O(1e-2..1) values through 6 convs and the mid attention.
"""

import torch_threads  # noqa: F401  (torch's threads: this xdist worker's share)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablekeypoints_tpu.kernels.gn_conv import _jnp_reference
from stablekeypoints_tpu.kernels.gn_conv import fused_gn_conv_supported as jax_supported
from stablekeypoints_tpu.kernels.gn_conv import fused_gn_silu_conv3x3 as jax_gn_conv
from stablekeypoints_tpu.models import weights as jw
from stablekeypoints_tpu.models.layers import _group_norm_coeffs
from stablekeypoints_tpu.models.vae import VAE as JaxVAE
from stablekeypoints_tpu.models.vae import VAEConfig as JaxVAEConfig
from stablekeypoints_tpu_torch.kernels import gn_conv
from stablekeypoints_tpu_torch.kernels.groupnorm import gn_affine_coeffs_plain
from stablekeypoints_tpu_torch.models import layers
from stablekeypoints_tpu_torch.models import weights as tw
from stablekeypoints_tpu_torch.models.layers import ResnetBlock
from stablekeypoints_tpu_torch.models.vae import VAE, VAEConfig


def _make(b=2, h=24, w=16, cin=16, cout=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (b, h, w, cin)).astype(np.float32)
    scale = rng.normal(1.0, 0.2, (cin,)).astype(np.float32)
    bias = rng.normal(0.0, 0.2, (cin,)).astype(np.float32)
    k = rng.normal(0, 0.1, (3, 3, cin, cout)).astype(np.float32)
    cb = rng.normal(0, 0.1, (cout,)).astype(np.float32)
    res = rng.normal(0, 1, (b, h, w, cout)).astype(np.float32)
    return x, scale, bias, k, cb, res


def _port(x, m, a, b, k, cb, res, dtype):
    t = lambda v: torch.from_numpy(np.array(v, np.float32))  # noqa: E731
    return gn_conv.fused_gn_silu_conv3x3(
        t(x).to(dtype), t(m), t(a), t(b), t(k).to(dtype), t(cb).to(dtype),
        None if res is None else t(res).to(dtype))


@pytest.mark.parametrize("with_res", [False, True])
def test_plain_matches_jax_kernel_fp32(with_res):
    # h 24 -> the JAX kernel's 3 row blocks of 8: both halo directions and edges
    x, scale, bias, k, cb, res = _make()
    res = res if with_res else None
    m, a, b = _group_norm_coeffs(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), groups=8)
    got = _port(x, m, a, b, k, cb, res, torch.float32).numpy()
    want = jax_gn_conv(jnp.asarray(x), m, a, b, jnp.asarray(k), jnp.asarray(cb),
                       residual=None if res is None else jnp.asarray(res), interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    ref = _jnp_reference(jnp.asarray(x), m, a, b, jnp.asarray(k), jnp.asarray(cb),
                         None if res is None else jnp.asarray(res))
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("with_res", [False, True])
def test_plain_matches_jax_kernel_bf16(with_res):
    x, scale, bias, k, cb, res = _make(seed=1)
    res = res if with_res else None
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    m, a, b = _group_norm_coeffs(xb, jnp.asarray(scale), jnp.asarray(bias), groups=8)
    got = _port(np.asarray(xb, np.float32), m, a, b, k, cb, res, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    rb = None if res is None else jnp.asarray(res).astype(jnp.bfloat16)
    for want in (jax_gn_conv(xb, m, a, b, jnp.asarray(k), jnp.asarray(cb), residual=rb,
                             interpret=True),
                 _jnp_reference(xb, m, a, b, jnp.asarray(k), jnp.asarray(cb), rb)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-7 * np.abs(want).max())


@pytest.mark.parametrize("h,w,cin,cout,stride", [
    (64, 64, 128, 128, 1), (64, 64, 128, 256, 1), (32, 24, 256, 128, 1), (8, 8, 128, 128, 1),
    (64, 64, 128, 128, 2),  # stride 2
    (7, 64, 128, 128, 1), (64, 7, 128, 128, 1),  # below 8 pixels
    (64, 64, 64, 128, 1), (64, 64, 128, 96, 1),  # channels not 128-aligned
    (64, 20, 128, 128, 1),  # width not 8-aligned
])
def test_gate_matches_jax_on_geometry_and_alignment(h, w, cin, cout, stride):
    for has_res in (False, True):
        assert gn_conv.fused_gn_conv_supported(h, w, cin, cout, stride, has_res) == \
            jax_supported(h, w, cin, cout, stride, False, has_res)


def _count_gn_conv(monkeypatch):
    calls = []
    real = layers.k_gn_conv.fused_gn_silu_conv3x3

    def counted(x, m, a, b, kernel, bias, residual=None):
        calls.append(residual is not None)
        return real(x, m, a, b, kernel, bias, residual)

    monkeypatch.setattr(layers.k_gn_conv, "fused_gn_silu_conv3x3", counted)
    return calls


@pytest.mark.parametrize("cin,cout,want_calls", [
    (128, 128, [False, True]),  # conv1, then conv2 with the residual fused
    (128, 256, [False, True]),  # the residual through conv_shortcut
    (64, 128, [True]),  # conv1 (cin 64) unfused, conv2 fused: the gates are independent
])
def test_resnet_block_fused_matches_unfused(monkeypatch, cin, cout, want_calls):
    torch.manual_seed(0)
    fused = ResnetBlock(cin, cout, eps=1e-6, fused_norm=True, fused_gn_conv=True)
    plain = ResnetBlock(cin, cout, eps=1e-6, fused_norm=True)
    with torch.no_grad():
        for p in fused.parameters():
            p.normal_(0.0, 0.05)
    plain.load_state_dict(fused.state_dict())
    x = torch.from_numpy(np.random.default_rng(1).normal(0, 1, (2, 8, 16, cin)).astype(np.float32))
    calls = _count_gn_conv(monkeypatch)
    with torch.no_grad():
        got, want = fused(x), plain(x)
    assert calls == want_calls
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_time_embedding_blocks_never_fuse(monkeypatch):
    block = ResnetBlock(128, 128, temb_dim=32, fused_gn_conv=True)
    calls = _count_gn_conv(monkeypatch)
    with torch.no_grad():
        block(torch.zeros(1, 8, 8, 128), torch.zeros(1, 32))
    assert calls == []


def test_vae_encoder_with_k7_matches_jax():
    """Channels 128/256 so the gate admits every resnet conv of both levels
    (the tiny test VAE's 16-32 channels never would)."""
    jcfg = JaxVAEConfig(block_channels=(128, 256), layers_per_block=1)
    params = jw.init_vae_params_fast(1, jcfg, 16)
    img = np.random.default_rng(2).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    jvae = JaxVAE(jcfg, dtype=jnp.float32, fused_gn=True, fused_gn_interpret=True,
                  fused_gn_conv=True)
    want = jax.jit(lambda p, x: jvae.apply({"params": p}, x, method=JaxVAE.encode_mean))(
        params, img)
    vae = VAE(VAEConfig(block_channels=(128, 256), layers_per_block=1), fused_gn=True,
              fused_gn_conv=True)
    vae.load_state_dict(tw.from_jax_params({}, params)[1], strict=True)
    vae = tw.cast_module(vae, torch.float32).eval()
    with torch.no_grad():
        got = vae.encode_mean(torch.from_numpy(img))
    assert got.shape == (2, 8, 8, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert all(getattr(vae.encoder, n).fused_gn_conv for n in ("down_0_resnets_0", "mid_resnets_1"))


def test_coefficients_of_the_port_match_jax():
    x, scale, bias, *_ = _make(cin=64, seed=3)
    want = _group_norm_coeffs(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 32, 1e-6)
    got = gn_affine_coeffs_plain(torch.from_numpy(x), torch.from_numpy(scale),
                                 torch.from_numpy(bias), 32, 1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
