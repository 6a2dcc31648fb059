"""Dataset protocol, image decoding and the host-side batch loader (the
JAX package's `data/base.py`).

Every dataset returns `{'img': [H, W, 3] float32 in [0, 1] (NHWC),
'kpts': [K, 2] normalized (y, x), 'visibility': [K]}`. The loader gives
shuffled epochs of fixed-shape batches, prefetched by a thread pool, and
adds each batch's dataset indices as `_idx` (the training loop keys its
latent cache on them). PIL is imported where an image is decoded, so the
training path, which decodes nothing, does not load it.

`load_image_rgb` decodes by the `native_io` policy (`set_native_io`, from
`Config.native_io`), as the JAX package routes it:
  off  - PIL decode + bilinear resize (the reference's pixels);
  auto - the native libjpeg decoder (`utils/native.py`) only for a JPEG
         already at the target size, where no resize happens and both
         paths give libjpeg's pixels / 255: bit-identical to PIL, and the
         decode releases the GIL, so the prefetch threads run in parallel;
  on   - the native decode + resize for every JPEG (torch bilinear,
         align_corners=False, no antialias: not PIL's pixels when it
         resizes), `load_image_rgb_fast`.
Where the native library cannot be built, every mode decodes with PIL (a
warning says so, once).
"""

from __future__ import annotations

import concurrent.futures as cf
import io
import warnings
from typing import Iterator, Protocol

import numpy as np

__all__ = ["KeypointDataset", "Loader", "is_deterministic", "load_image_rgb",
           "load_image_rgb_fast", "set_native_io"]


class KeypointDataset(Protocol):
    def __len__(self) -> int: ...

    def __getitem__(self, idx: int) -> dict: ...


def is_deterministic(dataset) -> bool:
    """True when __getitem__(i) always returns the same sample, the
    precondition for index-keyed caching. Datasets with per-access
    randomness set `deterministic = False`."""
    return bool(getattr(dataset, "deterministic", True))


_NATIVE_IO_MODE = "auto"
_warned_no_native = False


def set_native_io(mode: str) -> None:
    """Set the decoding policy of `load_image_rgb` (`Config.native_io`)."""
    global _NATIVE_IO_MODE
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"native_io must be auto|on|off, got {mode!r}")
    _NATIVE_IO_MODE = mode


def _native():
    """utils/native.py when its library loads, else None (warned once)."""
    global _warned_no_native
    from stablekeypoints_tpu_torch.utils import native

    if native.available():
        return native
    if not _warned_no_native:
        _warned_no_native = True
        warnings.warn("the native JPEG decoder could not be built (g++ or libjpeg missing): "
                      "decoding with PIL")
    return None


def _load_image_pil(path: str, image_size: int) -> np.ndarray:
    """PIL decode, RGB, bilinear resize when the size differs ->
    [image_size, image_size, 3] float32 in [0, 1]."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if img.size != (image_size, image_size):
        img = img.resize((image_size, image_size), Image.BILINEAR)
    return np.asarray(img, dtype=np.float32) / 255.0


def _is_jpeg(path: str) -> bool:
    return path.lower().endswith((".jpg", ".jpeg"))


def load_image_rgb(path: str, image_size: int) -> np.ndarray:
    """Decode + bilinear resize to [image_size, image_size, 3] float32 in
    [0, 1], by the `set_native_io` policy (see the module note)."""
    mode = _NATIVE_IO_MODE
    if mode == "on" and _is_jpeg(path):
        return load_image_rgb_fast(path, image_size)
    if mode == "auto" and _is_jpeg(path):
        native = _native()
        if native is not None:
            from PIL import Image

            # the bytes are read once: the size comes from the header in them
            with open(path, "rb") as f:
                buf = f.read()
            try:
                with Image.open(io.BytesIO(buf)) as im:
                    at_size = im.size == (image_size, image_size)
            except OSError:
                at_size = False
            if at_size:
                out = native.decode_resize_jpeg(buf, image_size, image_size)
                if out is not None:
                    return out
    return _load_image_pil(path, image_size)


def load_image_rgb_fast(path: str, image_size: int) -> np.ndarray:
    """The native decode + resize of a JPEG (torch bilinear, align_corners=
    False, no antialias: not PIL's pixels when it resizes); PIL for other
    files, bytes the decoder refuses, or without the native library."""
    if _is_jpeg(path):
        native = _native()
        if native is not None:
            with open(path, "rb") as f:
                out = native.decode_resize_jpeg(f.read(), image_size, image_size)
            if out is not None:
                return out
    return _load_image_pil(path, image_size)


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
