"""The plain versions of K1-K5 at the SD-2.x / SDXL head dim (64), forward
and backward, against the JAX kernels (Pallas interpret mode on the CPU,
`jax.vjp` for the backward), on the same seeded inputs.

Shapes follow the two backbones' layers, cut in sequence length: 5, 10 and
20 heads; K5 at the learned 500 tokens and the unconditional 77; K1 at
SD-2.1's 24^2 capture source (X 24: a full and a ragged 16-row x-step in
the CUDA kernel) and SDXL's 32^2 one, with 20 heads.

Tolerances are those of the d 40/80 tests: forward 1e-5 absolute (K3/K4/K5,
O(1) outputs) and 2e-6 (K1/K2, probabilities); backward 2e-5 of each
gradient's largest magnitude in fp32 and 2^-6 in bf16 (dsim rounded to
bf16 on both sides, from logits summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from stablekeypoints_tpu.kernels import attn_capture as jcap
from stablekeypoints_tpu.kernels import cross_attn as jcross
from stablekeypoints_tpu.kernels import flash as jflash
from stablekeypoints_tpu.ops.resize import resize_matrix as jax_resize_matrix
from stablekeypoints_tpu_torch.kernels import attn_capture, cross_attn, flash

D = 64
DTYPES = {"fp32": (jnp.float32, torch.float32, 2e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 2.0**-6)}


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, rel):
    for g, w in zip(got, want):
        w = np.asarray(jnp.asarray(w, jnp.float32))
        g = g.float().numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * np.abs(w).max())


@pytest.mark.parametrize("kind,n,m,h", [
    ("flash_self", 1024, 1024, 5),  # SD-2.1's 96^2 self-attention heads
    ("flash_self", 1024, 1024, 20),  # SDXL's 32^2 ones
    ("flash_cross", 1024, 500, 20),  # SDXL's 32^2 cross-attention (K5)
    ("flash_cross", 1024, 77, 10),  # the guidance's unconditional tokens
    ("cross", 256, 500, 10),  # K3 (SDXL 64^2, SD-2.1 96^2 / 48^2)
    ("cross", 256, 77, 5),
])
def test_attention_plain_matches_pallas_kernel_d64(kind, n, m, h):
    rng = np.random.default_rng(n + m + h)
    q, k, v = _rand(rng, 1, n, h, D), _rand(rng, 1, m, h, D), _rand(rng, 1, m, h, D)
    scale = D ** -0.5
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    if kind == "cross":
        want = jcross.cross_attention_resident(jq, jk, jv, scale, interpret=True)
        got = cross_attn.cross_attention_resident(*map(torch.from_numpy, (q, k, v)), scale)
    else:
        jfn = jflash.flash_self_attention if kind == "flash_self" else jflash.flash_cross_attention
        with pltpu.force_tpu_interpret_mode():
            want = jfn(jq, jk, jv, scale)
        fn = flash.flash_self_attention if kind == "flash_self" else flash.flash_cross_attention
        got = fn(*map(torch.from_numpy, (q, k, v)), scale)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("kind,n,m,h", [("flash_self", 256, 256, 10),
                                        ("flash_cross", 256, 500, 5),
                                        ("flash_cross", 256, 77, 20),
                                        ("cross", 256, 500, 10)])
def test_attention_bwd_plain_matches_jax_vjp_d64(kind, n, m, h, dtype):
    jdt, tdt, rel = DTYPES[dtype]
    rng = np.random.default_rng(n + m + h)
    arrays = [_rand(rng, 1, n, h, D), _rand(rng, 1, m, h, D), _rand(rng, 1, m, h, D),
              _rand(rng, 1, n, h, D)]
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in arrays)
    q, k, v, do = (torch.from_numpy(a).to(tdt) for a in arrays)
    scale = D ** -0.5
    if kind == "cross":
        fn = lambda a, b, c: jcross.cross_attention_resident(a, b, c, scale, interpret=True)  # noqa: E731
        _, vjp = jax.vjp(fn, jq, jk, jv)
        want = vjp(jdo)
        got = cross_attn.cross_attention_bwd_plain(q, k, v, do, scale)
    else:
        jfn = jflash.flash_self_attention if kind == "flash_self" else jflash.flash_cross_attention
        with pltpu.force_tpu_interpret_mode():
            out, vjp = jax.vjp(lambda a, b, c: jfn(a, b, c, scale), jq, jk, jv)
            want = vjp(jdo)
        o = torch.from_numpy(np.array(jnp.asarray(out, jnp.float32))).to(tdt)
        got = flash.attention_bwd_plain(q, k, v, o, do, scale)
    assert [g.dtype for g in got] == [tdt] * 3
    _close(got, want, rel)


def _capture_inputs(rng, b, s, res, h, t):
    q5 = _rand(rng, b, s, s, h, D)
    ww = np.array(jax_resize_matrix(s, res, "bicubic"))
    tt = np.einsum("Oy,byxkd->bkOxd", ww, q5).astype(np.float32)
    return tt, ww, _rand(rng, b, t, h, D)


# (source width X, capture grid, heads, tokens): SD-2.1's up_1 (24^2, 20
# heads) and SDXL's up_0 (32^2, 20 heads), the grid cut from 128^2
CAPTURES = [(24, 32, 20, 77), (32, 32, 20, 500), (24, 64, 4, 500)]


@pytest.mark.parametrize("s,res,h,t", CAPTURES)
def test_capture_plain_matches_pallas_kernel_d64(s, res, h, t):
    rng = np.random.default_rng(s + res + h + t)
    tt, ww, k = _capture_inputs(rng, 1, s, res, h, t)
    scale = D ** -0.5
    want = jcap.capture_attention_fused(jnp.asarray(tt), jnp.asarray(ww), jnp.asarray(k), scale,
                                        interpret=True)
    got = attn_capture.capture_attention_fused(*map(torch.from_numpy, (tt, ww, k)), scale)
    assert got.shape == (1, res * res, t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("s,res,h,t", CAPTURES[:2])
def test_capture_bwd_plain_matches_jax_vjp_d64(s, res, h, t, dtype):
    jdt, tdt, rel = DTYPES[dtype]
    rng = np.random.default_rng(s + res + h + t + 1)
    tt, ww, k = _capture_inputs(rng, 1, s, res, h, t)
    g = _rand(rng, 1, res * res, t) * 1e-2
    scale = D ** -0.5
    jtt, jww, jk = (jnp.asarray(a, jdt) for a in (tt, ww, k))
    fn = lambda a, w, c: jcap.capture_attention_fused(a, w, c, scale, interpret=True)  # noqa: E731
    _, vjp = jax.vjp(fn, jtt, jww, jk)
    want_dt, _, want_dk = vjp(jnp.asarray(g))
    ttt, tww, tk = (torch.from_numpy(a).to(tdt) for a in (tt, ww, k))
    got = attn_capture.capture_fused_bwd_plain(ttt, tww, tk, torch.from_numpy(g), scale)
    _close(got, (want_dt, want_dk), rel)


@pytest.mark.parametrize("h,n,t", [(20, 144, 77), (10, 100, 500)])
def test_unfused_capture_plain_matches_pallas_kernel_d64(h, n, t):
    """K2 (the capture at grids K1's query blocks do not tile), forward."""
    rng = np.random.default_rng(h + n + t)
    q, k = _rand(rng, 1, h, n, D), _rand(rng, 1, t, h, D)
    scale = D ** -0.5
    want = jcap.capture_attention(jnp.asarray(q), jnp.asarray(k), scale, interpret=True)
    got = attn_capture.capture_attention(torch.from_numpy(q), torch.from_numpy(k), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_unfused_capture_bwd_plain_matches_jax_vjp_d64(dtype):
    jdt, tdt, rel = DTYPES[dtype]
    rng = np.random.default_rng(20)
    q, k, g = _rand(rng, 1, 20, 144, D), _rand(rng, 1, 77, 20, D), _rand(rng, 1, 144, 77) * 1e-2
    scale = D ** -0.5
    fn = lambda a, b: jcap.capture_attention(a, b, scale, interpret=True)  # noqa: E731
    _, vjp = jax.vjp(fn, jnp.asarray(q, jdt), jnp.asarray(k, jdt))
    want = vjp(jnp.asarray(g))
    got = attn_capture.capture_bwd_plain(torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
                                         torch.from_numpy(g), scale)
    _close(got, want, rel)
