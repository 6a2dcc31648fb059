"""K1: the port's capture plain version vs the JAX Pallas capture kernel
(interpret mode on the CPU), fp32, on the same seeded inputs.

Tolerance 2e-6 absolute: outputs are softmax probabilities (<= 1), both
sides take fp32 logits over the same products; only the order of the
d- and x-sums differs (the JAX test of the kernel itself uses 2e-6).
"""

import torch_threads  # noqa: F401  (torch's threads: this xdist worker's share)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablekeypoints_tpu.kernels.attn_capture import capture_attention_fused as jax_capture
from stablekeypoints_tpu.ops.resize import resize_matrix as jax_resize_matrix
from stablekeypoints_tpu_torch.kernels import attn_capture as k1


def _inputs(b, s, res, h, d, t, seed):
    rng = np.random.default_rng(seed)
    q5 = rng.standard_normal((b, s, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, t, h, d)).astype(np.float32)
    ww = np.array(jax_resize_matrix(s, res, "bicubic"))
    tt = np.einsum("Oy,byxkd->bkOxd", ww, q5).astype(np.float32)
    return tt, ww, k


@pytest.mark.parametrize(
    "b,s,res,h,d,t",
    [(2, 4, 16, 2, 16, 20), (1, 8, 32, 2, 40, 500), (1, 4, 32, 1, 80, 77)],
)
def test_capture_plain_matches_pallas_kernel(b, s, res, h, d, t):
    tt, ww, k = _inputs(b, s, res, h, d, t, seed=b * 100 + d)
    scale = 1.0 / np.sqrt(d)
    want = np.asarray(jax_capture(jnp.asarray(tt), jnp.asarray(ww), jnp.asarray(k), scale,
                                  interpret=True))
    got = k1.capture_attention_fused(torch.from_numpy(tt), torch.from_numpy(ww),
                                     torch.from_numpy(k), scale)
    assert got.shape == (b, res * res, t) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)
    assert np.allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)  # a head-mean of softmaxes


def test_capture_gate():
    """The port routes the capture by the JAX package's rule, whatever the
    head dim or token count (the wrapper raises on CUDA for shapes its
    kernel does not take)."""
    from stablekeypoints_tpu.kernels.attn_capture import fused_capture_ok as jax_ok

    for res in (8, 16, 32, 48, 64, 96, 128, 160, 192, 256):
        assert k1.fused_capture_ok(res, res) is jax_ok(res, res), res
    assert k1.fused_capture_ok(128, 128) and not k1.fused_capture_ok(96, 96)


@pytest.mark.parametrize("t", [500, 30, 77])
def test_g_rows_aligns_the_cotangent_rows(t):
    """The backward kernels read g by TMA, whose rows must be 16-byte
    aligned: rows of T % 4 != 0 floats get zero columns up to a multiple of
    4, and the valid columns are unchanged."""
    g = torch.randn((2, 5, t), generator=torch.Generator().manual_seed(t))
    got, ldg = k1.g_rows(g)
    assert ldg % 4 == 0 and t <= ldg < t + 4
    assert got.shape == (2, 5, ldg) and got.is_contiguous()
    torch.testing.assert_close(got[..., :t], g, rtol=0, atol=0)
    assert not got[..., t:].any()
    assert (got is g) == (t % 4 == 0)
