"""The capture past 512 learned tokens and past 128 output columns a row.

The JAX package's K1/K2 (`capture_attention_fused`, `capture_attention`)
pad the tokens to a multiple of 128 and take any count, and its fused
backward any row width that `fused_capture_ok` lets through (256^2 and
512^2 captures: 256 and 512 columns a row). The port's CUDA kernels take
up to 4096 tokens (clusters of up to 8 blocks of 512) and 512 columns; on
the CPU their plain versions run. Here those plain versions, and a training
step of the tiny topology at 600 tokens, are held against the JAX kernels
in interpret mode (`jax.vjp` for the backward) on the same seeded inputs:

- forward maps: 2e-6 absolute (softmax probabilities <= 1, fp32 logits
  over the same products on both sides, sums in another order), as
  tests/test_torch_attn_capture.py;
- backward, fp32: 2e-5 of each gradient's largest magnitude; bf16: 2^-6
  (both sides round dsim to bf16 from logits summed in another order), as
  tests/test_torch_backward.py;
- the training step (fp32): loss and aux rtol 1e-5, the context gradient
  1e-4 of its largest magnitude, as tests/test_torch_train_slice.py.
"""

import torch_threads  # noqa: F401  (torch's threads: this xdist worker's share)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablekeypoints_tpu.config import Config as JaxConfig
from stablekeypoints_tpu.kernels import attn_capture as jcap
from stablekeypoints_tpu.models.unet import tiny_unet_config as jax_tiny_unet
from stablekeypoints_tpu.models.vae import tiny_vae_config as jax_tiny_vae
from stablekeypoints_tpu.ops.resize import resize_matrix as jax_resize_matrix
from stablekeypoints_tpu.parallel import mesh as pmesh
from stablekeypoints_tpu.pipeline.runtime import Runtime as JaxRuntime
from stablekeypoints_tpu_torch.config import Config
from stablekeypoints_tpu_torch.kernels import attn_capture
from stablekeypoints_tpu_torch.models.unet import tiny_unet_config
from stablekeypoints_tpu_torch.models.vae import tiny_vae_config
from stablekeypoints_tpu_torch.models.weights import from_jax_params
from stablekeypoints_tpu_torch.pipeline.runtime import Runtime
from test_torch_train_slice import GRAB, SIZE, _assert_aux_close, _assert_grad_close, _random_from_key

DTYPES = {"fp32": (jnp.float32, torch.float32, 2e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 2.0**-6)}


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, rel):
    for g, w in zip(got, want):
        w = np.asarray(jnp.asarray(w, jnp.float32))
        g = g.float().numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * np.abs(w).max())


def _fused_inputs(b, s, res, h, d, t, seed):
    rng = np.random.default_rng(seed)
    q5 = _rand(rng, b, s, s, h, d)
    ww = np.array(jax_resize_matrix(s, res, "bicubic"))
    tt = np.einsum("Oy,byxkd->bkOxd", ww, q5).astype(np.float32)
    return tt, ww, _rand(rng, b, t, h, d), rng


def test_limits_cover_the_new_shapes():
    """The wrappers' limits: 4096 tokens (8 blocks of 512), 512 columns."""
    assert attn_capture.MAX_TOKENS == 4096 and attn_capture.MAX_COLS == 512
    for res in (256, 512):  # the JAX routing sends both to the fused capture
        assert attn_capture.fused_capture_ok(res, res)


# (b, s, res, h, d, t): 600 and 1000 tokens at a 16^2 capture; 256 columns
# a row (res 256) at 20 tokens
FUSED = [(1, 4, 16, 2, 16, 600), (1, 4, 16, 1, 40, 1000), (1, 4, 256, 1, 16, 20)]


@pytest.mark.parametrize("b,s,res,h,d,t", FUSED)
def test_fused_capture_plain_matches_pallas_kernel(b, s, res, h, d, t):
    tt, ww, k, _ = _fused_inputs(b, s, res, h, d, t, seed=res + t)
    scale = d ** -0.5
    want = np.asarray(jcap.capture_attention_fused(jnp.asarray(tt), jnp.asarray(ww), jnp.asarray(k),
                                                   scale, interpret=True))
    got = attn_capture.capture_attention_fused(torch.from_numpy(tt), torch.from_numpy(ww),
                                               torch.from_numpy(k), scale)
    assert got.shape == (b, res * res, t) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,s,res,h,d,t", FUSED)
def test_fused_capture_bwd_plain_matches_jax_vjp(b, s, res, h, d, t, dtype):
    jdt, tdt, rel = DTYPES[dtype]
    tt, ww, k, rng = _fused_inputs(b, s, res, h, d, t, seed=res + t + 1)
    g = _rand(rng, b, res * res, t) * 1e-2
    scale = d ** -0.5
    fn = lambda a, w, c: jcap.capture_attention_fused(a, w, c, scale, interpret=True)  # noqa: E731
    want_dt, _, want_dk = jax.vjp(fn, *(jnp.asarray(a, jdt) for a in (tt, ww, k)))[1](jnp.asarray(g))
    got = attn_capture.capture_attention_fused_bwd(
        *(torch.from_numpy(a).to(tdt) for a in (tt, ww, k)), torch.from_numpy(g), scale)
    assert [x.dtype for x in got] == [tdt, tdt]
    _close(got, (want_dt, want_dk), rel)


def test_fused_capture_bwd_plain_precise_matches_jax_past_512_tokens():
    """capture_fp32_bwd at 1000 tokens: dsim stays fp32 through the products."""
    tt, ww, k, rng = _fused_inputs(1, 4, 16, 2, 16, 1000, seed=11)
    g = _rand(rng, 1, 256, 1000) * 1e-2
    fn = lambda a, w, c: jcap.capture_attention_fused(  # noqa: E731
        a, w, c, 0.25, interpret=True, precise_bwd=True)
    want_dt, _, want_dk = jax.vjp(fn, *(jnp.asarray(a, jnp.bfloat16) for a in (tt, ww, k)))[1](
        jnp.asarray(g))
    got = attn_capture.capture_attention_fused_bwd(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (tt, ww, k)), torch.from_numpy(g), 0.25,
        precise=True)
    _close(got, (want_dt, want_dk), 2.0**-6)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,h,n,d,t", [(1, 2, 144, 16, 600), (1, 1, 81, 80, 1000)])
def test_unfused_capture_plain_matches_jax_past_512_tokens(b, h, n, d, t, dtype):
    """K2 (a grid fused_capture_ok rejects): forward maps and jax.vjp."""
    jdt, tdt, rel = DTYPES[dtype]
    rng = np.random.default_rng(n + t)
    q, k, g = _rand(rng, b, h, n, d), _rand(rng, b, t, h, d), _rand(rng, b, n, t) * 1e-2
    scale = d ** -0.5
    fn = lambda a, c: jcap.capture_attention(a, c, scale, interpret=True)  # noqa: E731
    want, vjp = jax.vjp(fn, jnp.asarray(q, jdt), jnp.asarray(k, jdt))
    tq, tk = torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt)
    got = attn_capture.capture_attention(tq, tk, scale)
    assert got.shape == (b, n, t)
    if dtype == "fp32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
    _close(attn_capture.capture_attention_bwd(tq, tk, torch.from_numpy(g), scale),
           vjp(jnp.asarray(g)), rel)


TOKENS = 600


@functools.lru_cache(maxsize=None)
def _runtimes():
    kw = dict(SIZE, num_tokens=TOKENS, pallas_capture="on")
    jrt = JaxRuntime.create(JaxConfig(jax_cache_dir="", **kw), jax_tiny_unet(), jax_tiny_vae(),
                            mesh=pmesh.make_mesh(1))
    rt = Runtime.create(Config(**kw), tiny_unet_config(), tiny_vae_config(), device="cpu")
    rt.load_weights(*from_jax_params(jax.device_get(jrt.unet_params),
                                     jax.device_get(jrt.vae_params)))
    return jrt, rt


def test_train_step_fill_at_600_tokens_matches_jax():
    """The stage-1 step with a 600-token context: JAX runs its fused capture
    kernel forward and backward (interpret mode) over the padded tokens, the
    port K1's plain versions through CaptureFn; loss, aux and the context
    gradient agree."""
    jrt, rt = _runtimes()
    rng = np.random.default_rng(7)
    images = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    # x10: peaked maps, so the token rankings are well separated
    ctx = rng.standard_normal((1, TOKENS, 32)).astype(np.float32) * 10.0
    key = jax.random.PRNGKey(5)

    @jax.jit
    def fill(c, imgs, k):
        _, grads, _, aux, _ = jrt._train_step(
            jrt.unet_params, jrt.vae_params, GRAB, c, GRAB.init(c), imgs, k, return_latents=True)
        return grads, aux

    want_g, want_aux = fill(jnp.asarray(ctx), jnp.asarray(images), key)
    context = rt.train_context(ctx)
    assert tuple(context.shape) == (1, TOKENS, 32)
    opt = rt.optimizer(context)
    _, _, aux, _ = rt.train_step_fill(context, opt, images, **_random_from_key(key))
    _assert_aux_close(aux, want_aux)
    _assert_grad_close(context.grad.numpy(), want_g)
    assert np.abs(np.asarray(want_g)).max() > 0
