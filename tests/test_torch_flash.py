"""K4/K5: the port's flash plain version vs JAX's Pallas flash kernels
(forced TPU interpret mode on the CPU), fp32, on the same seeded inputs.

Tolerance 1e-5 absolute on O(1) outputs: the kernel's online softmax and
the plain one-pass softmax agree to fp32 rounding over 1024 keys (the JAX
package's own flash tests use 5e-6 to 1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from stablekeypoints_tpu.kernels import flash as jflash
from stablekeypoints_tpu_torch.kernels import flash as k45


def _qkv(n, m, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((1, n, h, d), (1, m, h, d), (1, m, h, d))]


def test_flash_self_plain_matches_pallas_kernel_d40():
    q, k, v = _qkv(1024, 1024, 2, 40, seed=0)
    scale = 1.0 / np.sqrt(40)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jflash.flash_self_attention(*map(jnp.asarray, (q, k, v)), scale))
    got = k45.flash_self_attention(*map(torch.from_numpy, (q, k, v)), scale)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("m,d", [(500, 80), (77, 40)])
def test_flash_cross_plain_matches_pallas_kernel(m, d):
    """kv not a multiple of 128: the JAX kernel pads and masks by segment ids."""
    q, k, v = _qkv(1024, m, 2, d, seed=m)
    scale = 1.0 / np.sqrt(d)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jflash.flash_cross_attention(*map(jnp.asarray, (q, k, v)), scale))
    got = k45.flash_cross_attention(*map(torch.from_numpy, (q, k, v)), scale)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("seq,kv,d,want", [
    (4096, 4096, 40, True), (1024, 1024, 80, True), (4096, 4096, 512, True),
    (256, 256, 160, False), (4096, 500, 40, False), (4096, 4096, 160, False),
    (1024, 1024, 64, True),  # SD-2.x / SDXL heads: compiled
    (4096, 4096, 128, True),  # not compiled: the wrapper raises
])
def test_flash_gate_follows_jax_rule(seq, kv, d, want):
    assert k45.flash_supported(seq, kv, d) is want
    assert jflash.flash_supported(seq, kv, d) is want
