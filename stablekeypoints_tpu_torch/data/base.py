"""Dataset protocol, image decoding and the host-side batch loader (the
JAX package's `data/base.py`).

Every dataset returns `{'img': [H, W, 3] float32 in [0, 1] (NHWC),
'kpts': [K, 2] normalized (y, x), 'visibility': [K]}`. The loader gives
shuffled epochs of fixed-shape batches, prefetched by a thread pool, and
adds each batch's dataset indices as `_idx` (the training loop keys its
latent cache on them). PIL is imported where an image is decoded, so the
training path, which decodes nothing, does not load it.
"""

from __future__ import annotations

import concurrent.futures as cf
import warnings
from typing import Iterator, Protocol

import numpy as np

__all__ = ["KeypointDataset", "Loader", "is_deterministic", "load_image_rgb", "set_native_io"]


class KeypointDataset(Protocol):
    def __len__(self) -> int: ...

    def __getitem__(self, idx: int) -> dict: ...


def is_deterministic(dataset) -> bool:
    """True when __getitem__(i) always returns the same sample, the
    precondition for index-keyed caching. Datasets with per-access
    randomness set `deterministic = False`."""
    return bool(getattr(dataset, "deterministic", True))


def set_native_io(mode: str) -> None:
    """Check `Config.native_io`. "off" and "auto" both decode with PIL here:
    the JAX package's "auto" takes its native JPEG decoder only where that is
    bit-identical to PIL, so the pixels are the same. "on" (the native
    decode + resize, not bit-identical) needs `utils/native.py`, not ported."""
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"native_io must be auto|on|off, got {mode!r}")
    if mode == "on":
        raise NotImplementedError("native_io='on': the native image decoder is not ported yet")


def load_image_rgb(path: str, image_size: int) -> np.ndarray:
    """PIL decode, RGB, bilinear resize when the size differs ->
    [image_size, image_size, 3] float32 in [0, 1]."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if img.size != (image_size, image_size):
        img = img.resize((image_size, image_size), Image.BILINEAR)
    return np.asarray(img, dtype=np.float32) / 255.0


def _stack(samples: list[dict]) -> dict:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class Loader:
    """Shuffled, prefetched, fixed-shape batch iterator."""

    def __init__(self, dataset: KeypointDataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, infinite: bool = False,
                 num_workers: int = 8, prefetch: int = 2):
        if len(dataset) == 0:
            raise ValueError("empty dataset")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.infinite = infinite
        self.prefetch = prefetch
        self._rng = np.random.default_rng(seed)
        self._pool = cf.ThreadPoolExecutor(max_workers=num_workers)

    def _index_stream(self) -> Iterator[np.ndarray]:
        n = len(self.dataset)
        while True:
            order = self._rng.permutation(n) if self.shuffle else np.arange(n)
            end = n - (n % self.batch_size) if self.drop_last else n
            if end == 0:  # dataset smaller than a batch: sample with replacement
                yield self._rng.choice(n, size=self.batch_size)
                if not self.infinite:
                    return
                continue
            for i in range(0, end, self.batch_size):
                yield order[i : i + self.batch_size]
            if not self.infinite:
                return

    def _result_or_substitute(self, i: int, fut: cf.Future) -> tuple[int, dict]:
        """A sample that fails to load is replaced by a random other one
        (bounded retries, one warning), so a long run keeps its batch shape."""
        try:
            return i, fut.result()
        except Exception as e:  # noqa: BLE001 - dataset errors of any kind
            n = len(self.dataset)
            for _ in range(8):
                j = int(self._rng.integers(n))
                if j == i:
                    continue
                try:
                    sample = self.dataset[j]
                except Exception:  # noqa: BLE001
                    continue
                warnings.warn(f"sample {i} failed ({type(e).__name__}: {e}); substituted {j}")
                return j, sample
            raise

    def __iter__(self) -> Iterator[dict]:
        stream = self._index_stream()
        pending: list = []

        def submit() -> bool:
            idxs = next(stream, None)
            if idxs is None:
                return False
            pending.append((idxs, [self._pool.submit(self.dataset.__getitem__, int(i))
                                   for i in idxs]))
            return True

        for _ in range(self.prefetch + 1):
            if not submit():
                break
        while pending:
            idxs, futs = pending.pop(0)
            resolved = [self._result_or_substitute(int(i), f) for i, f in zip(idxs, futs)]
            batch = _stack([s for _, s in resolved])
            batch["_idx"] = np.asarray([i for i, _ in resolved], np.int64)
            submit()
            yield batch

    def close(self) -> None:
        """Stop the prefetch threads; loads not yet started are dropped."""
        self._pool.shutdown(wait=True, cancel_futures=True)

    def __len__(self) -> int:
        n = len(self.dataset)
        if n < self.batch_size:
            return 1
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)
