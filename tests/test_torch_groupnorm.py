"""K6: the port's GroupNorm plain version vs the JAX Pallas GroupNorm
(interpret mode on the CPU) on the same seeded inputs.

Tolerances: fp32 inputs, 1e-5 absolute on O(1) outputs (both sides take
fp32 statistics; the JAX kernel uses shifted sums, the plain version two
passes). The shifted case (mean 30, std 0.5) is where the naive
E[x^2] - E[x]^2 fails; 1e-3 as in the JAX package's own test of it. bf16
inputs: both apply (x - m_q) * a + b_comp (+SiLU) in bf16, so outputs
agree to 2 bf16 ulps of O(4) values (0.0625).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablekeypoints_tpu.kernels import groupnorm as jgn
from stablekeypoints_tpu_torch.kernels import groupnorm as k6


def _make(b=2, h=16, w=16, c=128, seed=0, mean=0.0, std=1.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(mean, std, (b, h, w, c)).astype(np.float32)
    scale = rng.normal(1.0, 0.2, (c,)).astype(np.float32)
    bias = rng.normal(0.0, 0.2, (c,)).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("mean,std,atol", [(0.0, 1.0, 1e-5), (30.0, 0.5, 1e-3)])
def test_group_norm_plain_matches_pallas_kernel(act, mean, std, atol):
    x, s, bb = _make(mean=mean, std=std)
    want = np.asarray(jgn.fused_group_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(bb),
                                           32, 1e-6, act, interpret=True))
    got = k6.fused_group_norm(*map(torch.from_numpy, (x, s, bb)), 32, 1e-6, act)
    np.testing.assert_allclose(got.numpy(), want, atol=atol)


@pytest.mark.parametrize("mean,std", [(0.0, 1.0), (30.0, 0.5)])
def test_affine_coeffs_match(mean, std):
    x, s, bb = _make(c=256, mean=mean, std=std, seed=1)
    want = jgn.gn_affine_coeffs(jnp.asarray(x), jnp.asarray(s), jnp.asarray(bb), 32, 1e-6, True)
    got = k6.gn_affine_coeffs(*map(torch.from_numpy, (x, s, bb)), 32, 1e-6)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max())


def test_bf16_apply_matches_pallas_kernel():
    x, s, bb = _make(seed=2)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jgn.fused_group_norm(xb, jnp.asarray(s), jnp.asarray(bb), 32, 1e-6,
                                           "silu", interpret=True), np.float32)
    got = k6.fused_group_norm(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(s),
                              torch.from_numpy(bb), 32, 1e-6, "silu")
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() <= 0.0625


def test_gate_follows_jax_rule():
    for hw, c, g in ((64 * 64, 128, 32), (64 * 64, 96, 32), (64 * 64, 128, 48), (60, 128, 32)):
        assert k6.fused_group_norm_supported(hw, c, g) == jgn.fused_group_norm_supported(hw, c, g)
