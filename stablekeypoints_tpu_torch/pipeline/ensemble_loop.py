"""Prefetched host loop for the stage-3/5 ensembles (the JAX package's
`pipeline/ensemble_loop.py`).

Three things overlap: a thread pool decodes chunk i+1 (submitted before
chunk i is dispatched), the device runs chunk i's ensemble (CUDA launches
are asynchronous), and the caller consumes chunk i-1 on the host. Chunk
i's keypoints are copied to the host only after chunk i+1's launches are
queued. The tail chunk goes at its true size, with no repeat padding.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Iterator

import numpy as np
import torch

__all__ = ["ensemble_chunks"]


def ensemble_chunks(runtime, dataset, order, context, indices, generator: torch.Generator,
                    chunk_size: int, num_workers: int = 8
                    ) -> Iterator[tuple[list[dict], np.ndarray]]:
    """Yield `(samples, keypoints [len(samples), k, 2])` per chunk of
    `order`. Each chunk's thetas and noise come from `generator`, advanced
    in chunk order."""
    order = np.asarray(order)
    m = max(1, int(chunk_size))
    chunks = [order[lo : lo + m] for lo in range(0, len(order), m)]
    if not chunks:
        return
    pool = cf.ThreadPoolExecutor(max_workers=num_workers)
    try:
        futs = [pool.submit(dataset.__getitem__, int(i)) for i in chunks[0]]
        prev = None
        for ci in range(len(chunks)):
            samples = [f.result() for f in futs]
            if ci + 1 < len(chunks):
                futs = [pool.submit(dataset.__getitem__, int(i)) for i in chunks[ci + 1]]
            images = np.stack([np.asarray(s["img"], np.float32) for s in samples])
            pts = runtime.augmented_keypoints(context, images, indices, generator=generator)
            if prev is not None:
                yield prev[0], prev[1].cpu().numpy()  # waits for chunk i-1 only
            prev = (samples, pts)
        yield prev[0], prev[1].cpu().numpy()
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
