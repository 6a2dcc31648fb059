"""The stage-1 training slice: the port's Runtime vs the JAX Runtime.

Both sides run the tiny UNet/VAE topologies at 64^2 in fp32 on the CPU
(16 tokens, 16^2 capture, batch 2) with the same parameters (carried across
by `from_jax_params`) and the same random inputs: the affine thetas and the
latent noise are recomputed here from the JAX key exactly as `_train_step`
splits it (`key, k_noise, k_theta = split(key, 3)`), and handed to the port.

The JAX gradient is read before any optimizer update: `_train_step` runs
with an optax transformation that returns zero updates and keeps the
gradient as its state. Tolerances (fp32 through the VAE, UNet, capture,
selection and losses on both sides; measured well inside them):
- loss and aux: rtol 1e-5;
- the context gradient: 1e-4 of its largest magnitude, elementwise;
- the context after 3 Adam steps: 1e-6 absolute plus 2e-6 relative (a few
  fp32 ulps of the context's own values, which reach ~10; lr is 5e-3 per
  step), on the elements whose gradient stands clear of the gradient
  tolerance (10x) in every step: an element whose gradient is ~0 may move
  by +lr on one side and -lr on the other, and both are right;
- torch.optim.Adam vs optax.adam on the same gradients: 4 fp32 ulps of the
  parameter (rtol 4.8e-7) plus 1e-4 of lr (atol 5e-7): optax forms the bias
  correction 1 - 0.999^t in fp32, where it cancels to ~1e-5 relative, and
  torch in double.
"""

import torch_threads  # noqa: F401  (torch's threads: this xdist worker's share)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stablekeypoints_tpu.config import Config as JaxConfig
from stablekeypoints_tpu.models.unet import tiny_unet_config as jax_tiny_unet
from stablekeypoints_tpu.models.vae import tiny_vae_config as jax_tiny_vae
from stablekeypoints_tpu.ops.transforms import AffineParams as JaxAffine
from stablekeypoints_tpu.ops.transforms import sample_thetas as jax_sample_thetas
from stablekeypoints_tpu.parallel import mesh as pmesh
from stablekeypoints_tpu.pipeline.runtime import Runtime as JaxRuntime
from stablekeypoints_tpu_torch.config import Config
from stablekeypoints_tpu_torch.data.synthetic import SyntheticBlobs
from stablekeypoints_tpu_torch.models.unet import tiny_unet_config
from stablekeypoints_tpu_torch.models.vae import tiny_vae_config
from stablekeypoints_tpu_torch.models.weights import from_jax_params, load_adam_state
from stablekeypoints_tpu_torch.pipeline.optimize import optimize_embedding
from stablekeypoints_tpu_torch.pipeline.runtime import Runtime

SIZE = dict(image_size=64, num_tokens=16, feature_upsample_res=16, top_k=4,
            furthest_point_num_samples=8, batch_size=2, dtype="float32")
GRAD_RTOL = 1e-4

# zero updates; the state after `update` is the gradient itself
GRAB = optax.GradientTransformation(lambda p: jnp.zeros_like(p),
                                    lambda g, s, p=None: (jnp.zeros_like(g), g))


@functools.lru_cache(maxsize=None)
def _runtimes(pallas_capture):
    kw = dict(SIZE, pallas_capture=pallas_capture)
    jrt = JaxRuntime.create(JaxConfig(jax_cache_dir="", **kw), jax_tiny_unet(),
                            jax_tiny_vae(), mesh=pmesh.make_mesh(1))
    rt = Runtime.create(Config(**kw), tiny_unet_config(), tiny_vae_config(), device="cpu")
    rt.load_weights(*from_jax_params(jax.device_get(jrt.unet_params),
                                     jax.device_get(jrt.vae_params)))

    @jax.jit
    def fill(ctx, images, key):
        ctx, grads, key, aux, lat = jrt._train_step(
            jrt.unet_params, jrt.vae_params, GRAB, ctx, GRAB.init(ctx), images, key,
            return_latents=True)
        return grads, key, aux, lat

    @jax.jit
    def cached(ctx, lat, images, key):
        _, grads, key, aux = jrt._train_step(
            jrt.unet_params, jrt.vae_params, GRAB, ctx, GRAB.init(ctx), images, key,
            latents_orig=lat)
        return grads, key, aux

    return jrt, rt, fill, cached


def _inputs(seed=7):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    # x10: peaked maps, so the token rankings are well separated
    ctx = rng.standard_normal((1, 16, 32)).astype(np.float32) * 10.0
    return images, ctx


def _random_from_key(key, b=2):
    """The thetas and noise `_train_step` draws from `key`."""
    _, k_noise, k_theta = jax.random.split(key, 3)
    thetas = np.array(jax_sample_thetas(k_theta, b, JaxAffine()))
    noise = np.array(jax.random.normal(k_noise, (2 * b, 8, 8, 4), jnp.float32))
    return dict(thetas=torch.from_numpy(thetas), noise=torch.from_numpy(noise))


def _assert_aux_close(got, want):
    for name in ("loss", "sharpening", "equivariance"):
        np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-5, err_msg=name)


def _assert_grad_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_RTOL * np.abs(want).max())


@pytest.mark.parametrize("pallas_capture", ["off", "on"])
def test_train_step_fill_and_cached_match_jax(pallas_capture):
    """pallas_capture='on' runs the JAX capture kernel (forward and backward)
    in interpret mode, and the port's CaptureFn with the plain backward."""
    jrt, rt, fill, cached = _runtimes(pallas_capture)
    images, ctx = _inputs()
    key = jax.random.PRNGKey(5)

    want_g, key2, want_aux, want_lat = fill(jnp.asarray(ctx), jnp.asarray(images), key)
    context = rt.train_context(ctx)
    opt = rt.optimizer(context)
    _, _, aux, lat = rt.train_step_fill(context, opt, images, **_random_from_key(key))
    _assert_aux_close(aux, want_aux)
    _assert_grad_close(context.grad.numpy(), want_g)
    np.testing.assert_allclose(lat.numpy(), np.asarray(want_lat), atol=1e-5)
    assert np.abs(np.asarray(want_g)).max() > 0
    if pallas_capture == "on":
        return  # the cached step differs from the fill step only before the UNet

    # a cache-hit step on the JAX latents, with the next key's inputs
    want_g, _, want_aux = cached(jnp.asarray(ctx), want_lat, jnp.asarray(images), key2)
    context = rt.train_context(ctx)
    opt = rt.optimizer(context)
    _, _, aux = rt.train_step_cached(context, opt, torch.from_numpy(np.asarray(want_lat)),
                                     images, **_random_from_key(key2))
    _assert_aux_close(aux, want_aux)
    _assert_grad_close(context.grad.numpy(), want_g)


def test_context_after_three_adam_steps_matches_jax():
    jrt, rt, fill, _ = _runtimes("off")
    images, ctx = _inputs(seed=8)
    key = jax.random.PRNGKey(9)
    adam = optax.adam(rt.cfg.lr)
    jctx = jnp.asarray(ctx)
    state = adam.init(jctx)
    context = rt.train_context(ctx)
    opt = rt.optimizer(context)
    clear = np.ones(ctx.shape, bool)
    for _ in range(3):
        random = _random_from_key(key)
        grads, key, _, _ = fill(jctx, jnp.asarray(images), key)
        updates, state = adam.update(grads, state, jctx)
        jctx = optax.apply_updates(jctx, updates)
        g = np.asarray(grads)
        clear &= np.abs(g) > 10 * GRAD_RTOL * np.abs(g).max()
        rt.train_step(context, opt, images, **random)
    assert clear.mean() > 0.5
    assert np.abs(context.detach().numpy() - ctx).max() > 1e-2  # 3 steps of ~lr each
    np.testing.assert_allclose(context.detach().numpy()[clear], np.asarray(jctx)[clear],
                               rtol=2e-6, atol=1e-6)


def test_torch_adam_matches_optax_adam():
    """Identical gradients for 5 steps, then optax's state carried into a
    fresh torch.optim.Adam by `load_adam_state` for 3 more."""
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((1, 16, 32)).astype(np.float32)
    grads = [rng.standard_normal(p0.shape).astype(np.float32) * 10.0 ** -i for i in range(8)]
    adam = optax.adam(5e-3)
    jp, state = jnp.asarray(p0), adam.init(jnp.asarray(p0))
    tp = torch.from_numpy(p0.copy()).requires_grad_()
    opt = torch.optim.Adam([tp], lr=5e-3, betas=(0.9, 0.999), eps=1e-8)
    for i, g in enumerate(grads):
        if i == 5:  # continue from the JAX side's state
            tp = torch.from_numpy(np.array(jp)).requires_grad_()
            opt = torch.optim.Adam([tp], lr=5e-3, betas=(0.9, 0.999), eps=1e-8)
            s = state[0]
            load_adam_state(opt, s.count, s.mu, s.nu)
        updates, state = adam.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        tp.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=4.8e-7, atol=5e-7)


def test_fill_and_cached_steps_agree():
    """A cached step on the latents a fill step returned is the same step."""
    _, rt, _, _ = _runtimes("off")
    images, ctx = _inputs(seed=3)
    random = _random_from_key(jax.random.PRNGKey(1))
    results = []
    for mode in ("fill", "cached"):
        context = rt.train_context(ctx)
        opt = rt.optimizer(context)
        if mode == "fill":
            _, _, aux, lat = rt.train_step_fill(context, opt, images, **random)
        else:
            _, _, aux = rt.train_step_cached(context, opt, lat, images, **random)
        results.append((aux, context.grad.clone(), context.detach().clone()))
    (aux_f, g_f, c_f), (aux_c, g_c, c_c) = results
    _assert_aux_close(aux_c, aux_f)
    _assert_grad_close(g_c.numpy(), g_f.numpy())
    assert not torch.equal(c_f, torch.from_numpy(ctx))


def test_optimize_embedding_fills_then_hits_the_cache(tmp_path):
    cfg = Config(**dict(SIZE, num_steps=4, log_every=1, checkpoint_every=2,
                        save_folder=str(tmp_path)))
    _, rt0, _, _ = _runtimes("off")
    rt = Runtime(cfg, rt0.unet, rt0.vae, rt0.schedule, rt0.device)
    calls = {"fill": 0, "cached": 0}
    for name in calls:
        method = getattr(rt, f"train_step_{name}")

        def counted(*a, _m=method, _n=name, **k):
            calls[_n] += 1
            return _m(*a, **k)

        setattr(rt, f"train_step_{name}", counted)
    from stablekeypoints_tpu_torch.utils.logging import MetricsLogger

    logger = MetricsLogger(str(tmp_path))
    ctx0 = rt.init_context()
    out = optimize_embedding(rt, SyntheticBlobs(length=4, image_size=64), logger,
                             context=ctx0 * 10.0)
    logger.close()
    assert calls == {"fill": 2, "cached": 2}  # one epoch of 2 batches, then cache hits
    assert out.shape == (1, 16, 32) and not out.requires_grad
    assert not torch.allclose(out, ctx0 * 10.0)
    import json

    lines = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in lines if "loss" in r]
    assert [r["step"] for r in steps] == [0, 1, 2, 3]
    for r in steps:
        assert np.isfinite(r["loss"]) and r["iteration time"] >= 0
        assert {"running_sharpening_loss", "running_equivariance_attn_loss"} <= set(r)
    assert lines[-1]["event"] == "done"
    assert (tmp_path / "embedding.npy").exists()
