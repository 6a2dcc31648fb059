"""Stages 3-5 in the port vs the JAX package, on the host side.

- Metrics (`compute_metric` for all five methods, `swap_points`,
  `apply_regressor`): within 1e-12 (the same float64 numpy on both sides).
- The three regressors and `fit_regressor`: equal after the float32 cast.
- `ensemble_chunks`: the prefetch contract of tests/test_ensemble_loop.py
  (tail at its true size, order kept, chunk i+1's decode submitted before
  chunk i's dispatch, a single chunk), the generator advanced once a chunk
  in chunk order, and chunk i's host copy after chunk i+1's dispatch.
- `precompute_all_keypoints` and `evaluate` with stand-in runtimes whose
  keypoints depend only on the image: the same order, source, target,
  visible, regressor, `all_errors` and mean distance as JAX's.
- `extract_keypoints`: argmax equal, soft-argmax within 1e-5 (float32
  sums in another order).
"""

import torch_threads  # noqa: F401  (torch's threads: this xdist worker's share)
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from stablekeypoints_tpu.config import Config as JaxConfig
from stablekeypoints_tpu.pipeline import metrics as jmetrics
from stablekeypoints_tpu.pipeline import regressor as jregressor
from stablekeypoints_tpu.pipeline.evaluate import evaluate as jax_evaluate
from stablekeypoints_tpu_torch.config import Config
from stablekeypoints_tpu_torch.parallel.mesh import make_mesh
from stablekeypoints_tpu_torch.pipeline import metrics, regressor
from stablekeypoints_tpu_torch.pipeline.ensemble_loop import ensemble_chunks
from stablekeypoints_tpu_torch.pipeline.evaluate import evaluate
from stablekeypoints_tpu_torch.utils.artifacts import load_artifact

METHODS = ["inter_eye_distance", "visible", "mean_average_error", "pck", "orientation_invariant"]


def _points(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, shape)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("seed", [0, 1])
def test_compute_metric_equal_jax(method, seed):
    k = 32
    est, gt = _points(seed, (k, 2)), _points(seed + 10, (k, 2))
    if method == "orientation_invariant" and seed == 1:
        est = jmetrics.swap_points(gt[None])[0] + 1e-3  # the swapped branch wins
    vis = (_points(seed + 20, (k,)) > 0.3).astype(np.float32)
    for visible in (None, vis):
        got = metrics.compute_metric(method, est.astype(np.float32), gt.astype(np.float32), visible)
        want = jmetrics.compute_metric(method, est.astype(np.float32), gt.astype(np.float32), visible)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    with pytest.raises(NotImplementedError):
        metrics.compute_metric("l1", est, gt)


def test_swap_points_and_apply_regressor_equal_jax():
    pts = np.arange(3 * 32 * 2, dtype=np.float64).reshape(3, 32, 2)
    np.testing.assert_array_equal(metrics.swap_points(pts), jmetrics.swap_points(pts))
    assert metrics.HUMAN36M_SWAPS == jmetrics.HUMAN36M_SWAPS
    # the duplicated (21, 28) pair overwrites perm[28]: not an involution at 20/21/28
    twice = metrics.swap_points(metrics.swap_points(pts))
    assert not np.array_equal(twice[:, 20], pts[:, 20])
    found, w = _points(2, (10, 2)), np.random.default_rng(3).standard_normal((20, 10))
    np.testing.assert_allclose(metrics.apply_regressor(found, w),
                               jmetrics.apply_regressor(found, w), rtol=0, atol=1e-12)


def _regression_data(n=40, k=4, kk=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 2 * k)).astype(np.float32)
    y = rng.uniform(0, 1, (n, kk, 2)).astype(np.float32)
    vis = (rng.uniform(0, 1, (n, kk)) > 0.25).astype(np.float32)
    return x, y, vis


def test_regressors_equal_jax():
    x, y, vis = _regression_data()
    yf = y.reshape(len(y), -1)
    vis2 = np.repeat(vis, 2, axis=1)
    for ours, theirs in (
        (regressor.return_regressor(x, yf), jregressor.return_regressor(x, yf)),
        (regressor.return_regressor_visible(x, yf, vis2),
         jregressor.return_regressor_visible(x, yf, vis2)),
        (regressor.return_regressor_human36m(x, yf.copy()),
         jregressor.return_regressor_human36m(x, yf.copy())),
    ):
        assert ours.shape == (8, 64)
        np.testing.assert_array_equal(ours.astype(np.float32), theirs.astype(np.float32))


def test_human36m_regressor_relabels_swapped_rows():
    """Half the ground truth is left/right swapped: the loop relabels them
    (more than 10 rows prefer the swap) and stops when 10 or fewer do."""
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (60, 64)).astype(np.float32)
    y = (x.reshape(60, 32, 2) + rng.normal(0, 0.01, (60, 32, 2))).astype(np.float32)
    y[:30] = jmetrics.swap_points(y[:30])
    yf = y.reshape(60, -1)
    got = regressor.return_regressor_human36m(x, yf.copy())
    want = jregressor.return_regressor_human36m(x, yf.copy())
    np.testing.assert_array_equal(got.astype(np.float32), want.astype(np.float32))
    plain = regressor.return_regressor(x, yf)
    assert not np.allclose(got, plain)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("with_visible", [True, False])
def test_fit_regressor_equal_jax(method, with_visible):
    x, y, vis = _regression_data(seed=1)
    source = x.reshape(len(x), 4, 2)
    visible = vis if with_visible else None
    got = regressor.fit_regressor(Config(evaluation_method=method), source, y, visible)
    want = jregressor.fit_regressor(JaxConfig(evaluation_method=method), source, y, visible)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("strategy", ["argmax", "weighted_avg"])
def test_extract_keypoints_equal_jax(strategy):
    maps = np.random.default_rng(4).uniform(0, 1, (5, 16, 16)).astype(np.float32) ** 8
    got = regressor.extract_keypoints(torch.from_numpy(maps), strategy)
    want = np.asarray(jregressor.extract_keypoints(maps, strategy))
    assert got.shape == (5, 2)
    if strategy == "argmax":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# ensemble_chunks


class _RecordingDataset:
    def __init__(self, n, size=8, delay=0.0, kpts=4):
        self.n, self.size, self.delay, self.kpts = n, size, delay, kpts
        self.calls: list[tuple[int, float]] = []
        self._lock = threading.Lock()

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if self.delay:
            time.sleep(self.delay)
        with self._lock:
            self.calls.append((i, time.monotonic()))
        rng = np.random.default_rng(i)
        return {
            "img": rng.uniform(0, 1, (self.size, self.size, 3)).astype(np.float32),
            "kpts": rng.uniform(0, 1, (self.kpts, 2)).astype(np.float32),
            "visibility": (rng.uniform(0, 1, (self.kpts,)) > 0.2).astype(np.float32),
            "tag": np.float32(i),
        }


def _image_keypoints(images, k):
    """Keypoints [M, k, 2] in [0, 1) that depend only on each image."""
    means = images.reshape(len(images), -1, 3).mean(axis=1)  # [M, 3]
    j = np.arange(1, k + 1)[None, :, None]
    return np.mod(means[:, None, :2] * j * 7.31, 1.0).astype(np.float32)


class _Pending:
    """A device result: records when the host copies it."""

    def __init__(self, rt, pts):
        self.rt, self.pts = rt, pts

    def cpu(self):
        self.rt.events.append(("copy", len(self.rt.dispatches) - 1))
        return torch.from_numpy(self.pts)


class _PortRuntime:
    def __init__(self, cfg=None, pending=False):
        self.cfg, self.device, self.pending = cfg, torch.device("cpu"), pending
        self.mesh = make_mesh(-1, device="cpu")  # one process
        self.dispatches: list[tuple[int, float]] = []
        self.draws: list[torch.Tensor] = []
        self.events: list[tuple[str, int]] = []

    def augmented_keypoints(self, context, images, indices, generator):
        self.dispatches.append((images.shape[0], time.monotonic()))
        self.events.append(("dispatch", len(self.dispatches) - 1))
        self.draws.append(torch.rand(3, generator=generator))
        pts = _image_keypoints(np.asarray(images), len(indices))
        return _Pending(self, pts) if self.pending else torch.from_numpy(pts)


class _JaxRuntime:
    def __init__(self, cfg):
        self.cfg = cfg

    def augmented_keypoints_fn(self, context, images, idx_arr, key):
        return _image_keypoints(np.asarray(images), len(idx_arr))


def _run(n, m, delay=0.0, pending=False):
    ds, rt = _RecordingDataset(n, delay=delay), _PortRuntime(pending=pending)
    out = list(ensemble_chunks(rt, ds, np.arange(n), None, np.arange(3),
                               torch.Generator().manual_seed(0), m))
    return ds, rt, out


def test_tail_dispatches_true_size():
    _, rt, out = _run(n=5, m=2)
    assert [s for s, _ in rt.dispatches] == [2, 2, 1]
    assert [len(s) for s, _ in out] == [2, 2, 1]
    for samples, pts in out:
        assert isinstance(pts, np.ndarray) and pts.shape == (len(samples), 3, 2)
        np.testing.assert_array_equal(pts, _image_keypoints(np.stack([s["img"] for s in samples]), 3))


def test_all_samples_covered_in_order():
    _, _, out = _run(n=7, m=3)
    assert [int(s["tag"]) for samples, _ in out for s in samples] == list(range(7))


def test_next_chunk_decode_submitted_before_current_dispatch():
    ds, rt, out = _run(n=8, m=2, delay=0.02)
    assert len(out) == 4
    chunk1_decode_starts = [t for i, t in ds.calls if i in (2, 3)]
    assert min(chunk1_decode_starts) < rt.dispatches[1][1]


def test_single_chunk_dataset():
    _, rt, out = _run(n=2, m=4)
    assert [s for s, _ in rt.dispatches] == [2]
    assert len(out) == 1 and len(out[0][0]) == 2


def test_host_copy_after_next_dispatch_and_generator_in_chunk_order():
    _, rt, _ = _run(n=7, m=2, pending=True)
    assert rt.events == [("dispatch", 0), ("dispatch", 1), ("copy", 1), ("dispatch", 2),
                         ("copy", 2), ("dispatch", 3), ("copy", 3), ("copy", 3)]
    gen = torch.Generator().manual_seed(0)
    for got in rt.draws:
        torch.testing.assert_close(got, torch.rand(3, generator=gen), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# stages 3 and 5 against the JAX package's, with stand-in runtimes


@pytest.mark.parametrize("method", METHODS)
def test_precompute_and_evaluate_equal_jax(tmp_path, method):
    """23 regression images cut to max_num_points 20 (chunks of 3, the tail
    of 2); 11 test images; 32 keypoints, so every method applies."""
    kw = dict(seed=3, max_num_points=20, eval_batch_images=3, evaluation_method=method,
              top_k=4)
    indices = np.array([3, 1, 4, 0])
    results = {}
    for side, cfg_cls in (("port", Config), ("jax", JaxConfig)):
        cfg = cfg_cls(save_folder=str(tmp_path / side), **kw)
        reg_ds, test_ds = _RecordingDataset(23, kpts=32), _RecordingDataset(11, kpts=32)
        if side == "port":
            rt = _PortRuntime(cfg)
            src, tgt, vis = regressor.precompute_all_keypoints(rt, reg_ds, None, indices)
            reg = regressor.fit_regressor(cfg, src, tgt, vis)
            mean, values = evaluate(rt, test_ds, None, indices, reg)
        else:
            rt = _JaxRuntime(cfg)
            src, tgt, vis = jregressor.precompute_all_keypoints(rt, reg_ds, None, indices)
            reg = jregressor.fit_regressor(cfg, src, tgt, vis)
            mean, values = jax_evaluate(rt, test_ds, None, indices, reg)
        results[side] = dict(src=src, tgt=tgt, vis=vis, reg=reg, mean=mean, values=values,
                             all_errors=load_artifact(cfg.save_folder, "all_errors"))
    ours, theirs = results["port"], results["jax"]
    assert ours["src"].shape == (20, 4, 2) and ours["tgt"].shape == (20, 32, 2)
    # each image's target keypoints are its own: equal targets mean the same order
    for key in ("src", "tgt", "vis", "reg", "values", "all_errors"):
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)
    assert ours["mean"] == theirs["mean"] and np.isfinite(ours["mean"])


def test_precompute_order_is_the_seeded_permutation():
    """The 20 regression images are default_rng(seed + 4)'s permutation of
    the 23, cut to 20, in that order (the stand-in's source keypoints
    identify each image)."""
    cfg = Config(seed=3, max_num_points=20, eval_batch_images=3, top_k=2)
    ds = _RecordingDataset(23)
    src, tgt, _ = regressor.precompute_all_keypoints(_PortRuntime(cfg), ds, None, np.arange(2))
    order = np.random.default_rng(7).permutation(23)[:20]
    np.testing.assert_array_equal(tgt, np.stack([ds[int(i)]["kpts"] for i in order]))
    np.testing.assert_array_equal(
        src, _image_keypoints(np.stack([ds[int(i)]["img"] for i in order]), 2))


def test_evaluate_visualize_raises(tmp_path, monkeypatch):
    """With --visualize, stage 5 first plots the ensemble's panel: without
    matplotlib it raises before any chunk runs."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    cfg = Config(visualize=True, save_folder=str(tmp_path))
    with pytest.raises(ImportError):
        evaluate(_PortRuntime(cfg), _RecordingDataset(2), None, np.arange(2), np.eye(4))
    assert os.listdir(tmp_path) == []


def test_stage_logs_equal_jax(tmp_path):
    """The stage-3 and stage-5 log records carry the JAX package's fields."""
    from stablekeypoints_tpu.utils.logging import MetricsLogger as JaxLogger
    from stablekeypoints_tpu_torch.utils.logging import MetricsLogger

    records = {}
    for side in ("port", "jax"):
        cfg_cls, logger_cls = (Config, MetricsLogger) if side == "port" else (JaxConfig, JaxLogger)
        cfg = cfg_cls(save_folder=str(tmp_path / side), eval_batch_images=2, top_k=2,
                      evaluation_method="pck")
        logger = logger_cls(cfg.save_folder)
        ds = _RecordingDataset(5)
        if side == "port":
            rt = _PortRuntime(cfg)
            regressor.precompute_all_keypoints(rt, ds, None, np.arange(2), logger)
            evaluate(rt, ds, None, np.arange(2), np.eye(4, 8), logger)
        else:
            rt = _JaxRuntime(cfg)
            jregressor.precompute_all_keypoints(rt, ds, None, np.arange(2), logger)
            jax_evaluate(rt, ds, None, np.arange(2), np.eye(4, 8), logger)
        logger.close()
        with open(tmp_path / side / "metrics.jsonl") as f:
            records[side] = [{k: v for k, v in json.loads(line).items() if k != "t"} for line in f]
    assert records["port"] == records["jax"]
    assert [r.get("stage") for r in records["port"]] == [3, 5, 5, 5]  # first, last, done

