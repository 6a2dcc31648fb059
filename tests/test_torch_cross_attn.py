"""K3: the port's resident cross-attention plain version vs the JAX Pallas
kernel (interpret mode on the CPU), fp32, on the same seeded inputs.

Tolerance 1e-5 absolute on O(1) outputs: fp32 logits, softmax and p.v on
both sides, other summation order over <= 512 tokens.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablekeypoints_tpu.kernels.cross_attn import cross_attention_resident as jax_cross
from stablekeypoints_tpu_torch.kernels import cross_attn as k3


@pytest.mark.parametrize("n,m,h,d", [(256, 500, 2, 40), (128, 77, 2, 64)])
def test_cross_plain_matches_pallas_kernel(n, m, h, d):
    rng = np.random.default_rng(n + m)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, n, h, d), (2, m, h, d), (2, m, h, d)))
    scale = 1.0 / np.sqrt(d)
    want = np.asarray(jax_cross(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                                interpret=True))
    got = k3.cross_attention_resident(*(torch.from_numpy(a) for a in (q, k, v)), scale)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_cross_gate():
    """The JAX package's band, whatever the head dim (the wrapper raises on
    CUDA for head dims its kernel does not take)."""
    from stablekeypoints_tpu.kernels.cross_attn import cross_resident_supported as jax_gate

    for seq in (1024, 2048, 4096, 4160):
        for kv in (77, 500, 513):
            for d in (40, 64, 80, 160, 192):
                assert k3.cross_resident_supported(seq, kv, d) is jax_gate(seq, kv, d)
    assert k3.cross_resident_supported(4096, 500, 40)  # SD-1.5 64^2 cross layers
    assert not k3.cross_resident_supported(1024, 500, 80)  # the flash band
