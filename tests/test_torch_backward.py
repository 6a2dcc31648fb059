"""The plain backward versions of K1, K3, K4 and K5 vs `jax.vjp` of the JAX
kernels (Pallas TPU interpret mode on the CPU), and the port's
`torch.autograd.Function`s on CPU tensors vs autograd through the plain
forward.

fp32 cases: 2e-5 of each gradient's largest magnitude (both sides
contract in fp32; sums in another order over up to 1024 keys). bf16 cases:
2^-6 of the largest magnitude, the tolerance `chip_smoke.py` holds the
backward kernels to on the card: both sides round dsim (and p for dv) to
bf16 before the products, from logits summed in another order, so an
element near a rounding boundary can round the other way. The Functions
vs autograd through the plain forward: 1e-5 relative (fp32; the plain
backward contracts the same products in another association).
"""

import torch_threads  # noqa: F401  (torch's threads: this xdist worker's share)
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
from stablekeypoints_tpu_torch.models.layers import AttentionFn, CaptureFn

DTYPES = {"fp32": (np.float32, jnp.float32, torch.float32, 2e-5),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16, 2.0**-6)}


def _close(got, want, rel):
    for g, w in zip(got, want):
        w = np.asarray(jnp.asarray(w, jnp.float32))
        g = g.float().numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * np.abs(w).max())


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(arrays, jdt, tdt):
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("kind,n,m,d", [("flash_self", 256, 256, 40),
                                        ("flash_cross", 256, 77, 80),
                                        ("cross", 256, 100, 40)])
def test_attention_bwd_plain_matches_jax_vjp(kind, n, m, d, dtype):
    _, jdt, tdt, rel = DTYPES[dtype]
    rng = np.random.default_rng(n + m + d)
    arrays = [_rand(rng, 1, n, 2, d), _rand(rng, 1, m, 2, d), _rand(rng, 1, m, 2, d),
              _rand(rng, 1, n, 2, d)]
    (jq, jk, jv, jdo), (q, k, v, do) = _both(arrays, jdt, tdt)
    scale = d ** -0.5
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
        # the plain backward reads the forward output, as the kernel's di does
        o = torch.from_numpy(np.asarray(jnp.asarray(out, jnp.float32))).to(tdt)
        got = flash.attention_bwd_plain(q, k, v, o, do, scale)
    assert [g.dtype for g in got] == [tdt] * 3
    _close(got, want, rel)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,s,res,h,d,t", [(1, 4, 16, 2, 16, 20), (1, 8, 32, 2, 40, 100)])
def test_capture_bwd_plain_matches_jax_vjp(b, s, res, h, d, t, dtype):
    _, jdt, tdt, rel = DTYPES[dtype]
    rng = np.random.default_rng(b * 100 + d + t)
    q5 = _rand(rng, b, s, s, h, d)
    ww = np.array(jax_resize_matrix(s, res, "bicubic"))
    tt = np.einsum("Oy,byxkd->bkOxd", ww, q5).astype(np.float32)
    k = _rand(rng, b, t, h, d)
    g = _rand(rng, b, res * res, t) * 1e-2
    scale = d ** -0.5
    (jtt, jww, jk), (ttt, tww, tk) = _both([tt, ww, k], jdt, tdt)
    fn = lambda a, w, c: jcap.capture_attention_fused(a, w, c, scale, interpret=True)  # noqa: E731
    _, vjp = jax.vjp(fn, jtt, jww, jk)
    want_dt, want_dww, want_dk = vjp(jnp.asarray(g))
    assert not np.asarray(want_dww).any()
    got = attn_capture.capture_fused_bwd_plain(ttt, tww, tk, torch.from_numpy(g), scale)
    assert [x.dtype for x in got] == [tdt, tdt]
    _close(got, (want_dt, want_dk), rel)


def test_capture_bwd_plain_precise_matches_jax():
    """capture_fp32_bwd: dsim stays fp32 through the bf16 products."""
    rng = np.random.default_rng(3)
    tt, k = _rand(rng, 1, 2, 16, 4, 16), _rand(rng, 1, 20, 2, 16)
    ww = np.array(jax_resize_matrix(4, 16, "bicubic"))
    g = _rand(rng, 1, 256, 20) * 1e-2
    (jtt, jww, jk), (ttt, tww, tk) = _both([tt, ww, k], jnp.bfloat16, torch.bfloat16)
    fn = lambda a, w, c: jcap.capture_attention_fused(  # noqa: E731
        a, w, c, 0.25, interpret=True, precise_bwd=True)
    want_dt, _, want_dk = jax.vjp(fn, jtt, jww, jk)[1](jnp.asarray(g))
    got = attn_capture.capture_fused_bwd_plain(ttt, tww, tk, torch.from_numpy(g), 0.25,
                                               precise=True)
    _close(got, (want_dt, want_dk), 2.0**-6)


@pytest.mark.parametrize("kind", ["flash_self", "flash_cross", "cross"])
def test_attention_fn_matches_autograd_of_plain(kind):
    rng = np.random.default_rng(1)
    m = 64 if kind == "flash_self" else 30
    q, do = torch.from_numpy(_rand(rng, 2, 64, 2, 40)), torch.from_numpy(_rand(rng, 2, 64, 2, 40))
    k, v = torch.from_numpy(_rand(rng, 2, m, 2, 40)), torch.from_numpy(_rand(rng, 2, m, 2, 40))
    grads = []
    for fn in (lambda a, b, c: AttentionFn.apply(a, b, c, 0.2, kind),
               lambda a, b, c: flash.attention_plain(a, b, c, 0.2)):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        (fn(*leaves) * do).sum().backward()
        grads.append([x.grad for x in leaves])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())


def test_capture_fn_matches_autograd_of_plain():
    rng = np.random.default_rng(2)
    tt, k = torch.from_numpy(_rand(rng, 2, 2, 16, 4, 16)), torch.from_numpy(_rand(rng, 2, 20, 2, 16))
    ww = torch.from_numpy(np.array(jax_resize_matrix(4, 16, "bicubic")))
    g = torch.from_numpy(_rand(rng, 2, 256, 20))
    grads = []
    for fn in (lambda a, c: CaptureFn.apply(a, ww, c, 0.25, False),
               lambda a, c: attn_capture.capture_fused_plain(a, ww, c, 0.25)):
        leaves = [x.clone().requires_grad_() for x in (tt, k)]
        # a strided cotangent, as collect_maps hands it on
        (fn(*leaves).transpose(1, 2) * g.transpose(1, 2)).sum().backward()
        grads.append([x.grad for x in leaves])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("n,kind", [(1024, "flash_self"), (2048, "cross"), (1024, "flash_cross")])
def test_attention_layer_takes_its_gradient_through_the_functions(n, kind, monkeypatch):
    """A CrossAttention layer at a length the kernel gates take: with
    flash on, its gradients (through `AttentionFn` and the plain backward
    on CPU tensors) equal those of the plain layer, within 1e-5 of each
    gradient's largest magnitude (fp32)."""
    from stablekeypoints_tpu_torch.models import layers

    routed = []
    attention = layers.attention
    monkeypatch.setattr(layers, "attention",
                        lambda k, *a: routed.append(k) or attention(k, *a))
    torch.manual_seed(0)
    context_dim = None if kind == "flash_self" else 24
    flash_layer = layers.CrossAttention(16, 2, 40, context_dim, flash=True)
    plain_layer = layers.CrossAttention(16, 2, 40, context_dim, flash=False)
    plain_layer.load_state_dict(flash_layer.state_dict())
    rng = np.random.default_rng(n)
    x = torch.from_numpy(_rand(rng, 1, n, 16))
    ctx = None if context_dim is None else torch.from_numpy(_rand(rng, 1, 30, 24))
    dout = torch.from_numpy(_rand(rng, 1, n, 16))
    grads = []
    for layer in (flash_layer, plain_layer):
        leaves = [t.clone().requires_grad_() for t in (x, ctx) if t is not None]
        out, _ = layer(*leaves)
        (out * dout).sum().backward()
        grads.append([t.grad for t in leaves] + [p.grad for p in layer.parameters()])
    assert routed == [kind]
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())
