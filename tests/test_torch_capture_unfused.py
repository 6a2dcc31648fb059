"""K2, the unfused capture (upsampled head-major queries -> QK^T -> softmax
-> head-mean), in the port vs the JAX package: the plain forward and
backward against the JAX kernel in interpret mode and `jax.vjp` of it, the
autograd Function, the CrossAttention layer and the training step at a
capture grid that `fused_capture_ok` rejects (12^2: n = 144, query blocks
of 8 rows do not tile rows of 12).

Tolerances: forward maps 2e-6 absolute (probabilities <= 1, fp32 logits
summed in another order), as K1's test. Backward: fp32 2e-5 of each
gradient's largest magnitude; bf16 2^-6 (both sides round dsim to bf16
import torch_threads  # noqa: F401  (torch's threads: this xdist worker's share)
from logits summed in another order), as tests/test_torch_backward.py.
The layer's capture gradient: 2e-5 of its largest magnitude (fp32 through
the upsample and the softmax VJP). The training step: the tolerances of
tests/test_torch_train_slice.py (loss and aux rtol 1e-5, the context
gradient 1e-4 of its largest magnitude).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablekeypoints_tpu.config import Config as JaxConfig
from stablekeypoints_tpu.kernels import attn_capture as jcap
from stablekeypoints_tpu.models.layers import CrossAttention as JaxCrossAttention
from stablekeypoints_tpu.models.unet import tiny_unet_config as jax_tiny_unet
from stablekeypoints_tpu.models.vae import tiny_vae_config as jax_tiny_vae
from stablekeypoints_tpu.parallel import mesh as pmesh
from stablekeypoints_tpu.pipeline.runtime import Runtime as JaxRuntime
from stablekeypoints_tpu_torch.config import Config
from stablekeypoints_tpu_torch.kernels import attn_capture
from stablekeypoints_tpu_torch.models import layers
from stablekeypoints_tpu_torch.models.unet import tiny_unet_config
from stablekeypoints_tpu_torch.models.vae import tiny_vae_config
from stablekeypoints_tpu_torch.models.weights import from_jax_params
from stablekeypoints_tpu_torch.pipeline.runtime import Runtime
from test_torch_train_slice import (
    GRAB,
    _assert_aux_close,
    _assert_grad_close,
    _inputs,
    _random_from_key,
)

DTYPES = {"fp32": (jnp.float32, torch.float32, 2e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 2.0**-6)}


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, rel):
    for g, w in zip(got, want):
        w = np.asarray(jnp.asarray(w, jnp.float32))
        g = g.float().numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * np.abs(w).max())


@pytest.mark.parametrize("b,h,n,d,t", [(2, 2, 144, 16, 20), (1, 2, 100, 40, 77), (1, 1, 81, 80, 500)])
def test_capture_plain_matches_pallas_kernel(b, h, n, d, t):
    rng = np.random.default_rng(n + d + t)
    q, k = _rand(rng, b, h, n, d), _rand(rng, b, t, h, d)
    scale = d ** -0.5
    want = np.asarray(jcap.capture_attention(jnp.asarray(q), jnp.asarray(k), scale, interpret=True))
    got = attn_capture.capture_attention(torch.from_numpy(q), torch.from_numpy(k), scale)
    assert got.shape == (b, n, t) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,h,n,d,t", [(1, 2, 144, 16, 20), (2, 2, 100, 40, 77)])
def test_capture_bwd_plain_matches_jax_vjp(b, h, n, d, t, dtype):
    jdt, tdt, rel = DTYPES[dtype]
    rng = np.random.default_rng(b * 10 + n + d)
    q, k, g = _rand(rng, b, h, n, d), _rand(rng, b, t, h, d), _rand(rng, b, n, t) * 1e-2
    scale = d ** -0.5
    fn = lambda a, c: jcap.capture_attention(a, c, scale, interpret=True)  # noqa: E731
    want = jax.vjp(fn, jnp.asarray(q, jdt), jnp.asarray(k, jdt))[1](jnp.asarray(g))
    got = attn_capture.capture_attention_bwd(torch.from_numpy(q).to(tdt),
                                             torch.from_numpy(k).to(tdt), torch.from_numpy(g), scale)
    assert [x.dtype for x in got] == [tdt, tdt]
    _close(got, want, rel)


def test_capture_bwd_plain_precise_matches_jax():
    """capture_fp32_bwd: dsim stays fp32 through the products."""
    rng = np.random.default_rng(4)
    q, k, g = _rand(rng, 1, 2, 144, 16), _rand(rng, 1, 20, 2, 16), _rand(rng, 1, 144, 20) * 1e-2
    fn = lambda a, c: jcap.capture_attention(a, c, 0.25, interpret=True, precise_bwd=True)  # noqa: E731
    want = jax.vjp(fn, jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16))[1](jnp.asarray(g))
    got = attn_capture.capture_attention_bwd(torch.from_numpy(q).to(torch.bfloat16),
                                             torch.from_numpy(k).to(torch.bfloat16),
                                             torch.from_numpy(g), 0.25, precise=True)
    _close(got, want, 2.0**-6)


def test_capture_unfused_fn_matches_autograd_of_plain():
    rng = np.random.default_rng(5)
    q, k = torch.from_numpy(_rand(rng, 2, 2, 144, 16)), torch.from_numpy(_rand(rng, 2, 20, 2, 16))
    g = torch.from_numpy(_rand(rng, 2, 144, 20))
    grads = []
    for fn in (lambda a, c: layers.CaptureUnfusedFn.apply(a, c, 0.25, False),
               lambda a, c: attn_capture.capture_plain(a, c, 0.25)):
        leaves = [x.clone().requires_grad_() for x in (q, k)]
        # a strided cotangent, as collect_maps hands it on
        (fn(*leaves).transpose(1, 2) * g.transpose(1, 2)).sum().backward()
        grads.append([x.grad for x in leaves])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())


def test_cross_attention_layer_at_an_unfused_grid_matches_jax(monkeypatch):
    """capture_res 12 from a 4^2 query grid: the JAX layer runs its unfused
    kernel (interpret mode), the port's layer routes to K2 (plain on the
    CPU, through CaptureUnfusedFn under autograd)."""
    heads, dim_head, dim, cdim = 2, 16, 32, 24
    assert not attn_capture.fused_capture_ok(12, 12)
    rng = np.random.default_rng(6)
    x, ctx, g = _rand(rng, 2, 16, dim), _rand(rng, 2, 20, cdim), _rand(rng, 2, 144, 20)
    jlayer = JaxCrossAttention(heads, dim_head, dtype=jnp.float32, capture_res=12,
                               pallas_capture=True, pallas_interpret=True)
    params = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(ctx))["params"]

    def jfn(c):
        return jlayer.apply({"params": params}, jnp.asarray(x), c)[1]

    want, vjp = jax.vjp(jfn, jnp.asarray(ctx))
    (want_grad,) = vjp(jnp.asarray(g))

    layer = layers.CrossAttention(dim, heads, dim_head, cdim, pallas_capture=True)
    with torch.no_grad():
        for name in ("to_q", "to_k", "to_v", "to_out"):
            getattr(layer, name).weight.copy_(torch.from_numpy(np.array(params[name]["kernel"]).T))
        layer.to_out.bias.copy_(torch.from_numpy(np.array(params["to_out"]["bias"])))
    context = torch.from_numpy(ctx).requires_grad_()
    calls = []
    real = attn_capture.capture_attention_bwd
    monkeypatch.setattr(attn_capture, "capture_attention_bwd",
                        lambda *a: calls.append(1) or real(*a))
    _, got = layer(torch.from_numpy(x), context, capture_res=12)
    (got * torch.from_numpy(g)).sum().backward()
    assert calls == [1]  # the gradient went through K2's backward wrapper
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-6)
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(context.grad.numpy(), want_grad, rtol=0,
                               atol=2e-5 * np.abs(want_grad).max())


@functools.lru_cache(maxsize=None)
def _runtimes_at_12():
    kw = dict(image_size=64, num_tokens=16, feature_upsample_res=12, top_k=4,
              furthest_point_num_samples=8, batch_size=2, dtype="float32", pallas_capture="on")
    jrt = JaxRuntime.create(JaxConfig(jax_cache_dir="", **kw), jax_tiny_unet(), jax_tiny_vae(),
                            mesh=pmesh.make_mesh(1))
    rt = Runtime.create(Config(**kw), tiny_unet_config(), tiny_vae_config(), device="cpu")
    rt.load_weights(*from_jax_params(jax.device_get(jrt.unet_params),
                                     jax.device_get(jrt.vae_params)))
    return jrt, rt


def test_train_step_fill_at_an_unfused_grid_matches_jax():
    """The stage-1 step at a 12^2 capture grid: JAX runs its unfused capture
    kernel forward and backward (interpret mode), the port K2's plain
    versions through CaptureUnfusedFn."""
    jrt, rt = _runtimes_at_12()
    # the inputs of the train slice's test: well-separated token rankings
    # (a near tie can select other tokens under jit's fused rounding)
    images, ctx = _inputs(seed=7)
    key = jax.random.PRNGKey(5)

    @jax.jit
    def fill(c, imgs, k):
        _, grads, _, aux, lat = jrt._train_step(
            jrt.unet_params, jrt.vae_params, GRAB, c, GRAB.init(c), imgs, k, return_latents=True)
        return grads, aux

    want_g, want_aux = fill(jnp.asarray(ctx), jnp.asarray(images), key)
    context = rt.train_context(ctx)
    opt = rt.optimizer(context)
    _, _, aux, _ = rt.train_step_fill(context, opt, images, **_random_from_key(key))
    _assert_aux_close(aux, want_aux)
    _assert_grad_close(context.grad.numpy(), want_g)
    assert np.abs(np.asarray(want_g)).max() > 0
