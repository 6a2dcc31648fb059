"""K3 at head dim 160: one SD-1.5-shaped cross-attention layer on its
routed path against the JAX layer (Pallas interpret mode on the CPU).

SD-1.5's 1280-channel transformers (down_2, up_1) have 8 heads of 160; at
1536^2 they run at 48^2 = 2304 queries, where both packages send the
cross-attention to K3. Here the layer is cut in width (1 and 2 heads, a
48-wide context) and kept at 2048+ queries, so the JAX layer reaches its
Pallas kernel (`cross_attention_resident`, interpret mode) and the port's
reaches `attention("cross", ...)` (the plain version on CPU tensors, its
plain backward through `AttentionFn`), forward and `jax.vjp` against
autograd, with the learned 500 tokens and the guidance's 77.

Tolerances: fp32 on both sides, 2e-5 of each output's or gradient's largest
magnitude (softmax and products in fp32, sums in another order over <= 512
keys and 160 columns), as the d 40/64/80 kernel tests hold the plain
versions.
"""

import torch_threads  # noqa: F401  (torch's threads: this xdist worker's share)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablekeypoints_tpu.models.layers import CrossAttention as JaxCrossAttention
from stablekeypoints_tpu_torch.kernels import cross_attn
from stablekeypoints_tpu_torch.models import layers

D, CTX = 160, 48


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, rel=2e-5):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("n,m,heads", [(2048, 500, 1), (2304, 77, 2)])
def test_d160_cross_layer_matches_jax_layer(n, m, heads, monkeypatch):
    assert D in cross_attn.KERNEL_DIMS and cross_attn.cross_resident_supported(n, m, D)
    rng = np.random.default_rng(n + m)
    inner = heads * D
    x, ctx = _rand(rng, 1, n, inner), _rand(rng, 1, m, CTX)
    dout = _rand(rng, 1, n, inner)
    wq, wk, wv = (_rand(rng, i, inner, scale=i ** -0.5) for i in (inner, CTX, CTX))
    wo, bo = _rand(rng, inner, inner, scale=inner ** -0.5), _rand(rng, inner, scale=0.1)

    jlayer = JaxCrossAttention(heads=heads, dim_head=D, dtype=jnp.float32, flash=True,
                               pallas_interpret=True)
    params = {"params": {"to_q": {"kernel": wq}, "to_k": {"kernel": wk},
                         "to_v": {"kernel": wv}, "to_out": {"kernel": wo, "bias": bo}}}
    (jout, _), vjp = jax.vjp(lambda a, c: jlayer.apply(params, a, c), jnp.asarray(x),
                             jnp.asarray(ctx))
    jdx, jdctx = vjp((jnp.asarray(dout), None))

    routed = []
    attention = layers.attention
    monkeypatch.setattr(layers, "attention", lambda k, *a: routed.append(k) or attention(k, *a))
    layer = layers.CrossAttention(inner, heads, D, CTX, flash=True)
    with torch.no_grad():
        for lin, w in ((layer.to_q, wq), (layer.to_k, wk), (layer.to_v, wv), (layer.to_out, wo)):
            lin.weight.copy_(torch.from_numpy(w.T))
        layer.to_out.bias.copy_(torch.from_numpy(bo))
    xt, ct = (torch.from_numpy(a).requires_grad_() for a in (x, ctx))
    out, _ = layer(xt, ct)
    (out * torch.from_numpy(dout)).sum().backward()
    assert routed == ["cross"]
    _close(out, jout)
    _close(xt.grad, jdx)
    _close(ct.grad, jdctx)
