"""The port's training ops vs the JAX package's, fp32 on the CPU, on the
same seeded numpy inputs.

Index outputs (argmax positions, candidate rankings, furthest-point
selections) must be equal, including on ties: sorts are stable and argmax
takes the first maximum on both sides. Gaussians and loss values agree to
fp32 rounding (atol 1e-6 on values <= 1); loss gradients, taken by
`torch.autograd` and `jax.grad`, within 1e-7 absolute (the gradients are
O(1e-4): 2 * (map - target) / numel).
"""

import torch_threads  # noqa: F401  (torch's threads: this xdist worker's share)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablekeypoints_tpu.ops import gaussians as jg
from stablekeypoints_tpu.ops import keypoints as jk
from stablekeypoints_tpu.ops import losses as jl
from stablekeypoints_tpu.ops import selection as js
from stablekeypoints_tpu.ops.transforms import AffineParams as JaxAffine
from stablekeypoints_tpu.ops.transforms import sample_thetas as jax_sample_thetas
from stablekeypoints_tpu_torch.ops import gaussians, keypoints, losses, selection


def _maps(seed, t=20, size=16, peak=4.0):
    """Maps with one clear bump per token plus noise (a learned context's
    shape), so argmaxes and rankings are well separated."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32)
    centres = rng.uniform(0, size, (t, 2))
    widths = rng.uniform(1.0, 4.0, (t, 1, 1))
    bump = np.exp(-((ys - centres[:, :1, None]) ** 2 + (xs - centres[:, 1:, None]) ** 2)
                  / (2 * widths**2))
    return (peak * bump + rng.uniform(0, 1, (t, size, size))).astype(np.float32)


def _tied_maps():
    """Tokens 1 and 4 are copies of token 0, token 5 of token 2: their
    rankings tie exactly; token 3's map has two equal maxima."""
    m = _maps(3, t=8)
    m[1] = m[4] = m[0]
    m[5] = m[2]
    m[3, 2, 9] = m[3, 11, 4] = m[3].max() + 1.0
    return m


def test_gaussian_circles_match_jax():
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, 1, (3, 5, 2)).astype(np.float32)
    want = np.asarray(jg.gaussian_circles(jnp.asarray(pos), 16, 2.0))
    got = gaussians.gaussian_circles(torch.from_numpy(pos), 16, 2.0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    one = gaussians.gaussian_circle(torch.from_numpy(pos[0]), 16, 1.5).numpy()
    np.testing.assert_allclose(one, np.asarray(jg.gaussian_circle(jnp.asarray(pos[0]), 16, 1.5)),
                               atol=1e-6)


@pytest.mark.parametrize("num", [1, 3])
def test_find_k_max_pixels_matches_jax(num):
    maps = np.concatenate([_maps(1), _tied_maps()])
    want = np.asarray(jk.find_k_max_pixels(jnp.asarray(maps), num))
    got = keypoints.find_k_max_pixels(torch.from_numpy(maps), num).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 20 + 3].tolist() == [2.5, 9.5]  # the first of two equal maxima


def test_mask_radius_matches_jax():
    maps = _maps(2)
    coords = np.random.default_rng(2).uniform(0, 16, (20, 2)).astype(np.float32)
    want = np.asarray(jk.mask_radius(jnp.asarray(maps), jnp.asarray(coords), 2.5))
    got = keypoints.mask_radius(torch.from_numpy(maps), torch.from_numpy(coords), 2.5).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("maps_fn", [lambda: _maps(4), _tied_maps], ids=["random", "ties"])
@pytest.mark.parametrize("strategy,num_subjects", [("gaussian", 1), ("gaussian", 2),
                                                   ("entropy", 1), ("consistent", 1)])
def test_select_candidates_equal_jax(maps_fn, strategy, num_subjects):
    maps = maps_fn()
    k = min(6, maps.shape[0])
    want = np.asarray(js.select_candidates(jnp.asarray(maps), strategy, k, sigma=2.0,
                                           num_subjects=num_subjects))
    got = selection.select_candidates(torch.from_numpy(maps), strategy, k, sigma=2.0,
                                      num_subjects=num_subjects).numpy()
    np.testing.assert_array_equal(got, want)


def test_stable_order_on_exact_ties():
    """Copies of one map tie exactly; both sides keep them in index order."""
    maps = _tied_maps()
    for fn_t, fn_j in ((selection.entropy_sort, js.entropy_sort),
                       (lambda m, k: selection.find_top_k_gaussian(m, k, sigma=2.0),
                        lambda m, k: js.find_top_k_gaussian(m, k, sigma=2.0))):
        got = fn_t(torch.from_numpy(maps), 8).numpy().tolist()
        assert got == np.asarray(fn_j(jnp.asarray(maps), 8)).tolist()
        for a, b in ((0, 1), (1, 4), (2, 5)):
            assert got.index(a) < got.index(b)


def _corner_maps():
    """Eight maps whose argmaxes sit on the corners of two nested squares:
    distances tie both for the seed pair and in the greedy steps."""
    maps = np.zeros((8, 16, 16), np.float32)
    corners = [(2, 2), (2, 13), (13, 2), (13, 13), (5, 5), (5, 10), (10, 5), (10, 10)]
    for i, (y, x) in enumerate(corners):
        maps[i, y, x] = 1.0
    return maps


@pytest.mark.parametrize("maps_fn,cands", [
    (lambda: _maps(5), [3, 0, 7, 12, 19, 4, 9, 1, 15, 6]),
    (_corner_maps, [0, 1, 2, 3, 4, 5, 6, 7]),
    (_corner_maps, [6, 2, 5, 0, 7, 3, 1, 4]),
])
def test_furthest_point_sampling_equals_jax(maps_fn, cands):
    maps, cands = maps_fn(), np.asarray(cands, np.int32)
    top_k = min(6, len(cands))
    want = np.asarray(js.furthest_point_sampling(jnp.asarray(maps), top_k, jnp.asarray(cands)))
    got = selection.furthest_point_sampling(torch.from_numpy(maps), top_k,
                                            torch.from_numpy(cands).long()).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist())) == top_k


@pytest.mark.parametrize("num_subjects", [1, 2])
def test_sharpening_loss_and_grad_match_jax(num_subjects):
    maps = _maps(6, t=5) / 10.0
    fn = lambda m: jl.sharpening_loss(m, sigma=2.0, num_subjects=num_subjects)  # noqa: E731
    want, want_g = jax.value_and_grad(fn)(jnp.asarray(maps))
    x = torch.from_numpy(maps).requires_grad_()
    got = losses.sharpening_loss(x, sigma=2.0, num_subjects=num_subjects)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), atol=1e-7)


def test_equivariance_loss_and_grad_match_jax():
    maps, maps_t = _maps(7, t=5) / 10.0, _maps(8, t=5) / 10.0
    theta = np.asarray(jax_sample_thetas(jax.random.PRNGKey(3), 1, JaxAffine()))[0]
    fn = lambda a, b: jl.equivariance_loss(a, b, jnp.asarray(theta), params=JaxAffine())  # noqa: E731
    want, (ga, gb) = jax.value_and_grad(fn, argnums=(0, 1))(jnp.asarray(maps), jnp.asarray(maps_t))
    a = torch.from_numpy(maps).requires_grad_()
    b = torch.from_numpy(maps_t).requires_grad_()
    got = losses.equivariance_loss(a, b, torch.from_numpy(theta))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(ga), atol=1e-7)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(gb), atol=1e-7)
