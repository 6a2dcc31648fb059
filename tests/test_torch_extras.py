"""`ops/extras.py`: the port's alternative ops against the JAX package's,
on the same inputs (numpy seeds), with gradients where they are
differentiated (`jax.grad` against autograd).

Tolerances: fp32 values and gradients within 1e-5 relative / 1e-6
absolute (sums over a few hundred elements in another order); index and
pixel outputs equal.
"""

import torch_threads  # noqa: F401  (torch's threads: this xdist worker's share)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablekeypoints_tpu.ops import extras as jx
from stablekeypoints_tpu_torch.ops import extras as tx


def _maps(seed, shape=(3, 12, 16), peaked=True):
    rng = np.random.default_rng(seed)
    m = rng.uniform(0, 1, shape).astype(np.float32)
    if peaked:
        m = m**6  # distinct maxima
    return m


@pytest.mark.parametrize("size,sigma", [(5, 1.0), (7, 2.5)])
def test_gaussian_kernel_2d(size, sigma):
    got = tx.gaussian_kernel_2d(size, sigma).numpy()
    np.testing.assert_allclose(got, np.asarray(jx.gaussian_kernel_2d(size, sigma)), rtol=1e-6,
                               atol=1e-7)
    assert abs(got.sum() - 1) < 1e-6


@pytest.mark.parametrize("name", ["gaussian_loss", "variance_loss", "differentiable_argmax"])
def test_differentiable_ops_and_gradients(name):
    m = _maps(1) * 0.01 if name == "gaussian_loss" else _maps(1)
    jfn, tfn = getattr(jx, name), getattr(tx, name)
    x = torch.from_numpy(m).requires_grad_()
    got = tfn(x)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jfn(jnp.asarray(m))),
                               rtol=1e-5, atol=1e-6)
    # the gradient of a fixed weighting of the output
    w = np.random.default_rng(2).standard_normal(got.shape).astype(np.float32)
    (g,) = torch.autograd.grad((got * torch.from_numpy(w)).sum(), x)
    want = jax.grad(lambda a: jnp.sum(jfn(a) * w))(jnp.asarray(m))
    want = np.asarray(want)
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_find_corresponding_points():
    a, b = _maps(3), _maps(4)
    order, pa, pb = tx.find_corresponding_points(torch.from_numpy(a), torch.from_numpy(b), 2)
    jo, jpa, jpb = jx.find_corresponding_points(jnp.asarray(a), jnp.asarray(b), 2)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(pa.numpy(), np.asarray(jpa))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jpb))


def test_mask_attn():
    rng = np.random.default_rng(5)
    image = rng.uniform(0.1, 1, (32, 48, 3)).astype(np.float32)
    image[:, :20] = 0.0  # background
    maps = _maps(6, (2, 8, 12), peaked=False)
    got = tx.mask_attn(torch.from_numpy(image), torch.from_numpy(maps)).numpy()
    want = np.asarray(jx.mask_attn(jnp.asarray(image), jnp.asarray(maps)))
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    assert (got == 0).any() and (got != 0).any()


def test_find_pos_from_index():
    m = _maps(7)
    got = tx.find_pos_from_index(torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, np.asarray(jx.find_pos_from_index(jnp.asarray(m))),
                               rtol=0, atol=1e-7)
