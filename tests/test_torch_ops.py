"""Port ops vs the JAX package's ops on the same seeded inputs (CPU, fp32).

Tolerances: the two sides run the same fp32 formulas with different
summation orders and libm implementations; 1e-5..1e-6 absolute on O(1)
values is a few fp32 ulps times the contraction length.
"""

import torch_threads  # noqa: F401  (torch's threads: this xdist worker's share)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablekeypoints_tpu.models.scheduler import DDIMSchedule as JaxDDIM
from stablekeypoints_tpu.ops import keypoints as jkp
from stablekeypoints_tpu.ops import resize as jrs
from stablekeypoints_tpu.ops import transforms as jtf
from stablekeypoints_tpu_torch.models.scheduler import DDIMSchedule
from stablekeypoints_tpu_torch.ops import keypoints as tkp
from stablekeypoints_tpu_torch.ops import resize as trs
from stablekeypoints_tpu_torch.ops import transforms as ttf


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def test_scheduler_tables_and_add_noise():
    js, ts = JaxDDIM.create(), DDIMSchedule.create()
    np.testing.assert_array_equal(js.alphas_cumprod, ts.alphas_cumprod)
    np.testing.assert_array_equal(js.timesteps, ts.timesteps)
    assert ts.timestep_at(-1) == js.timestep_at(-1) == 0
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    n = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    for t in (0, 980):
        want = np.asarray(js.add_noise(jnp.asarray(x), jnp.asarray(n), t))
        got = ts.add_noise(_t(x), _t(n), t).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
@pytest.mark.parametrize("sizes", [(16, 128), (32, 128), (128, 512), (64, 24)])
def test_resize_matrices_equal(method, sizes):
    a = trs.resize_matrix(*sizes, method).numpy()
    b = np.asarray(jrs.resize_matrix(*sizes, method))
    np.testing.assert_array_equal(a, b)


def test_resize_hw_and_headmajor_upsample():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 16, 16)).astype(np.float32)
    got = trs.resize_hw(_t(x), 64, 64, "bilinear").numpy()
    want = np.asarray(jrs.resize_hw(jnp.asarray(x), 64, 64, "bilinear"))
    np.testing.assert_allclose(got, want, atol=1e-5)
    q5 = rng.standard_normal((2, 4, 4, 3, 8)).astype(np.float32)
    got = trs.upsample_bicubic_headmajor(_t(q5), 16, 16).numpy()
    want = np.asarray(jrs.upsample_bicubic_headmajor(jnp.asarray(q5), 16, 16))
    np.testing.assert_allclose(got, want, atol=1e-5)


def _thetas(n=4, seed=2):
    aff = jtf.AffineParams()
    return np.asarray(jtf.sample_thetas(jax.random.PRNGKey(seed), n, aff)), aff


def test_theta_construction_and_inverse():
    rng = np.random.default_rng(3)
    ang, sc, tx, ty = (rng.uniform(-1, 1, 5).astype(np.float32) for _ in range(4))
    want = np.asarray(jtf.make_theta(ang * 15, 0.9 + 0.1 * sc, tx, ty))
    got = ttf.make_theta(_t(ang * 15), _t(0.9 + 0.1 * sc), _t(tx), _t(ty)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    th, _ = _thetas()
    np.testing.assert_allclose(
        ttf.invert_theta(_t(th)).numpy(), np.asarray(jtf.invert_theta(jnp.asarray(th))), atol=1e-6
    )
    np.testing.assert_allclose(
        ttf.affine_grid(_t(th), 8, 12).numpy(),
        np.asarray(jtf.affine_grid(jnp.asarray(th), 8, 12)), atol=1e-6,
    )


def test_sampled_thetas_within_ranges():
    gen = torch.Generator().manual_seed(0)
    aff = ttf.AffineParams()
    th = ttf.sample_thetas(gen, 256, aff)
    scale = torch.sqrt(th[:, 0, 0] ** 2 + th[:, 0, 1] ** 2)
    angle = torch.rad2deg(torch.atan2(th[:, 0, 1], th[:, 0, 0]))
    assert th.shape == (256, 2, 3)
    assert float(scale.min()) >= 0.8 - 1e-6 and float(scale.max()) <= 1.0 + 1e-6
    assert float(angle.abs().max()) <= 15.0 + 1e-4
    assert float(th[:, :, 2].abs().max()) <= 0.25


@pytest.mark.parametrize("size", [64, 128])
def test_affine_warps_match(size):
    """Forward and inverse warps (the JAX side takes its matmul form at
    these sizes; same taps and weights, other summation order)."""
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1, (4, size, size, 3)).astype(np.float32)
    th, aff = _thetas()
    for jfn, tfn in ((jtf.apply_affine, ttf.apply_affine),
                     (jtf.apply_inverse_affine, ttf.apply_inverse_affine)):
        want = np.asarray(jfn(jnp.asarray(img), jnp.asarray(th), params=aff))
        got = tfn(_t(img), _t(th)).numpy()
        np.testing.assert_allclose(got, want, atol=2e-5)
    want = np.asarray(jtf.grid_sample_bilinear(
        jnp.asarray(img), jtf.affine_grid(jnp.asarray(th), size, size)))
    got = ttf.grid_sample_bilinear(_t(img), ttf.affine_grid(_t(th), size, size)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_keypoint_extraction():
    rng = np.random.default_rng(5)
    maps = rng.uniform(0, 1, (6, 32, 32)).astype(np.float32)
    maps[0, 3, 7] = 5.0
    maps[1, 3, 7] = maps[1, 10, 2] = 5.0  # tie: first maximum wins
    np.testing.assert_array_equal(
        tkp.find_max_pixel(_t(maps)).numpy(), np.asarray(jkp.find_max_pixel(jnp.asarray(maps)))
    )
    for dist in (5.0, -1):
        np.testing.assert_allclose(
            tkp.pixel_from_weighted_avg(_t(maps), dist).numpy(),
            np.asarray(jkp.pixel_from_weighted_avg(jnp.asarray(maps), dist)),
            atol=1e-4,
        )
