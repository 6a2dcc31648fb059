"""The port's data and logging copies vs the JAX package's originals.

`SyntheticBlobs` must give the same samples (bit for bit: the same numpy
calls on the same seeds), and `Loader` the same batches in the same order
(the same numpy generator draws), so a training run sees the same images
in the same steps on both sides. `MetricsLogger` writes the same JSONL
records, and `iteration_time` is the same function.
"""

import torch_threads  # noqa: F401  (torch's threads: this xdist worker's share)
import json
import warnings

import numpy as np
import pytest

from stablekeypoints_tpu.data import base as jbase
from stablekeypoints_tpu.data.synthetic import SyntheticBlobs as JaxBlobs
from stablekeypoints_tpu.pipeline.optimize import iteration_time as jax_iteration_time
from stablekeypoints_tpu.utils.logging import MetricsLogger as JaxLogger
from stablekeypoints_tpu_torch.data import base
from stablekeypoints_tpu_torch.data.synthetic import SyntheticBlobs
from stablekeypoints_tpu_torch.pipeline.optimize import iteration_time
from stablekeypoints_tpu_torch.utils.logging import MetricsLogger


@pytest.mark.parametrize("kw", [dict(), dict(image_size=48, num_kpts=6, seed=3, jitter=0.1)])
def test_synthetic_blobs_equal_jax(kw):
    ours, theirs = SyntheticBlobs(length=5, **kw), JaxBlobs(length=5, **kw)
    assert len(ours) == len(theirs) == 5
    for i in range(5):
        a, b = ours[i], theirs[i]
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
            assert a[key].dtype == b[key].dtype


def _batches(loader, n):
    it = iter(loader)
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("length,batch_size,shuffle,drop_last,infinite,n", [
    (10, 4, True, True, True, 6),     # shuffled epochs, the tail dropped
    (10, 4, False, False, False, 3),  # in order, the ragged tail kept
    (3, 4, True, True, True, 3),      # smaller than a batch: with replacement
])
def test_loader_batches_equal_jax(length, batch_size, shuffle, drop_last, infinite, n):
    kw = dict(batch_size=batch_size, shuffle=shuffle, seed=4, drop_last=drop_last,
              infinite=infinite, num_workers=2)
    ours = base.Loader(SyntheticBlobs(length=length, image_size=16), **kw)
    theirs = jbase.Loader(JaxBlobs(length=length, image_size=16), **kw)
    assert len(ours) == len(theirs)
    got, want = _batches(ours, n), _batches(theirs, n)
    for a, b in zip(got, want):
        assert a.keys() == b.keys() and "_idx" in a
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    if not infinite:
        assert list(iter(ours))[-1]["img"].shape[0] == length % batch_size


class _Flaky(SyntheticBlobs):
    def __getitem__(self, idx):
        if idx == 2:
            raise OSError("truncated file")
        return super().__getitem__(idx)


def test_loader_substitutes_a_failing_sample():
    loader = base.Loader(_Flaky(length=4, image_size=8), batch_size=4, shuffle=False,
                         num_workers=1)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        (batch,) = list(loader)
    idx = batch["_idx"].tolist()
    assert 2 not in idx and len(idx) == 4 and idx[:2] + idx[3:] == [0, 1, 3]
    assert any("substituted" in str(w.message) for w in caught)
    with pytest.raises(ValueError, match="empty"):
        base.Loader(SyntheticBlobs(length=0), batch_size=1)


def test_loader_close_stops_the_prefetch_threads():
    loader = base.Loader(SyntheticBlobs(length=8, image_size=8), batch_size=2, infinite=True,
                         num_workers=2)
    batches = iter(loader)
    assert next(batches)["img"].shape == (2, 8, 8, 3)
    loader.close()
    with pytest.raises(RuntimeError, match="shutdown"):
        next(iter(loader))


def test_is_deterministic_matches_jax():
    class Random(SyntheticBlobs):
        deterministic = False

    for ds in (SyntheticBlobs(length=1), Random(length=1)):
        assert base.is_deterministic(ds) == jbase.is_deterministic(ds)
    assert not base.is_deterministic(Random(length=1))


def test_metrics_logger_writes_the_jax_records(tmp_path):
    records = [{"stage": 1, "step": 0, "loss": np.float32(1.5), "iteration time": 0.25},
               {"stage": 1, "event": "done", "seconds": 3}]
    for name, cls in (("ours", MetricsLogger), ("theirs", JaxLogger)):
        logger = cls(str(tmp_path / name), config={"lr": 5e-3})
        for r in records:
            logger.log(r)
        logger.close()
    read = {name: [json.loads(line) for line in (tmp_path / name / "metrics.jsonl").open()]
            for name in ("ours", "theirs")}
    for a, b in zip(read["ours"], read["theirs"], strict=True):
        a.pop("t"), b.pop("t")
        assert a == b
    assert read["ours"][0] == {"event": "config", "lr": 5e-3}


@pytest.mark.parametrize("now,start,step,last", [(10.0, 4.0, 5, 2), (1.0, 1.0, 0, -1),
                                                  (3.0, 1.0, 7, 7)])
def test_iteration_time_matches_jax(now, start, step, last):
    assert iteration_time(now, start, step, last) == jax_iteration_time(now, start, step, last)
