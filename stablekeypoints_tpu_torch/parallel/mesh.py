"""Data and tensor parallel over GPUs, one process a device (the JAX
package's `parallel/mesh.py`, there one controller over a
`jax.sharding.Mesh` of axes ('data', 'model')).

Launch one process per GPU (`torchrun --nproc_per_node N -m
stablekeypoints_tpu_torch.main ...`, or `torch.multiprocessing` in tests);
each joins a `torch.distributed` group, NCCL for CUDA and gloo for the CPU.
Every rank holds the whole model and the replicated state (the context,
the Adam state), runs the same entry points on the same global batch and
takes its rows of it (`shard_batch`: rank r gets rows [r·B/n, (r+1)·B/n),
what `P("data")` places on device r). Then:

- a training step averages the context gradient and its three aux
  scalars in one all-reduce of one flat fp32 buffer (`all_reduce_mean`)
  before the optimizer's step, as XLA reduces the gradient over 'data';
- an entry point's per-image outputs are gathered in rank order
  (`gather_rows`), so every rank holds what a one-process run holds, as
  the JAX package's single controller does;
- state made on one rank is broadcast from rank 0 (`replicate`, the JAX
  module's `replicated`).

Where the world does not divide a batch, the entry points do what the JAX
package does on its CPU mesh: a batch placed on the 'data' axis (a training
step, a vote batch) raises (`check_divides`), and a test-time ensemble,
whose views the JAX package shards inside its program (padded by the
partitioner), takes ceil(B/n) rows a rank, the last ranks fewer or none.

The world is an n_data x n_model mesh: rank r has data coordinate
r // n_model and model coordinate r % n_model (the JAX module's
`devices.reshape(n_data, n_model)`). Everything above runs over the data
coordinate: a batch splits into n_data row blocks (`Mesh.rows`), and the
gathers run over the data group of the ranks that share a model
coordinate. The n_model ranks of a data coordinate (its model group) take
the same rows and hold slices of one UNet (`parallel/tensor.py`); the
training step's one all-reduce runs over the whole world (the model
ranks' context gradients are parts of one gradient, summed there).
n_model 1, the default, is the data-parallel mesh above.
"""

from __future__ import annotations

import dataclasses
import gc
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from stablekeypoints_tpu_torch.parallel.tensor import GROUPS, ModelAxis

__all__ = ["Mesh", "all_reduce_mean", "barrier", "check_divides", "destroy_group",
           "gather_rows", "init_from_launch", "make_mesh", "replicate", "resolve_device",
           "shard_batch", "stacked_shard_batch"]


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names another device; no silent CPU run."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU; pass device='cpu' "
                "to run the plain PyTorch versions of its kernels on the CPU"
            )
        device = "cuda"
    return torch.device(device)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the world. `group` (the world's) is None for
    one process without a process group: then no collective runs.
    `data_group` gathers over the data coordinate (the world's group when
    n_model is 1; None when there is one data coordinate), `model_group`
    reduces over the model coordinate (None when n_model is 1)."""

    rank: int
    world: int
    group: Optional[dist.ProcessGroup]
    device: torch.device
    n_model: int = 1
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None

    def __post_init__(self):
        if self.n_model == 1 and self.data_group is None:
            object.__setattr__(self, "data_group", self.group)

    @property
    def n_data(self) -> int:
        return self.world // self.n_model

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_model

    @property
    def model_rank(self) -> int:
        return self.rank % self.n_model

    @property
    def model_axis(self) -> Optional[ModelAxis]:
        """This rank's model axis, None without tensor parallelism."""
        if self.n_model == 1:
            return None
        return ModelAxis(self.model_rank, self.n_model, self.model_group)

    def rows(self, n: int) -> slice:
        """This rank's rows of a batch of n: ceil(n / n_data) a data
        coordinate."""
        per = -(-n // self.n_data)
        return slice(min(self.data_rank * per, n), min((self.data_rank + 1) * per, n))

    @property
    def writer(self) -> bool:
        """World rank 0 writes artifacts, logs and checkpoints."""
        return self.rank == 0


def make_mesh(n_data: int = -1, n_model: int = 1, device=None) -> Mesh:
    """The (n_data, n_model) mesh of this launch. n_data -1 is the world
    size of the running process group (1 without one) over n_model; the
    product must equal it, and n_model must divide the UNet's 32 GroupNorm
    groups. Without `device`, rank r runs on cuda:LOCAL_RANK, which must
    exist: nothing shares a card unless the caller names the device, and
    under NCCL no two ranks share one. Every rank makes the data and model
    groups, in the same order."""
    running = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if running else 1
    if n_model < 1 or GROUPS % n_model:
        raise ValueError(f"model_parallel={n_model} must divide the UNet's {GROUPS} GroupNorm "
                         f"groups")
    if n_data == -1:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(
            f"data_parallel={n_data} x model_parallel={n_model}, but this launch has {world} "
            f"process(es): start one process a device (torchrun --nproc_per_node "
            f"{n_data * n_model} ...) or pass -1"
        )
    if not running:
        return Mesh(0, 1, None, resolve_device(device))
    rank = dist.get_rank()
    if device is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        count = torch.cuda.device_count()
        if local >= count:
            raise RuntimeError(
                f"rank {rank} (local rank {local}) has no GPU of its own ({count} visible): "
                f"name the device to share one"
            )
        device = f"cuda:{local}"
    device = torch.device(device)
    if dist.get_backend() == "nccl":
        if device.type != "cuda":
            raise ValueError(f"an NCCL group runs on CUDA devices, not {device}")
        local = int(os.environ.get("LOCAL_RANK", rank))
        if world > 1 and device.index is not None and device.index != local:
            raise ValueError(f"rank {rank} (local rank {local}) named {device}: an NCCL group "
                             f"takes one device a rank, cuda:LOCAL_RANK")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if n_model == 1:
        return Mesh(rank, world, dist.group.WORLD, device)
    data_group = model_group = None
    for d in range(n_data):  # every rank makes every group, in this order
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if d == rank // n_model:
            model_group = g
    if n_data > 1:
        for m in range(n_model):
            g = dist.new_group([d * n_model + m for d in range(n_data)])
            if m == rank % n_model:
                data_group = g
    return Mesh(rank, world, dist.group.WORLD, device, n_model, data_group, model_group)


def init_from_launch(device=None) -> bool:
    """Join the process group a launcher (torchrun) describes in the
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT): NCCL for CUDA,
    gloo for the CPU. Returns whether this call initialized it (False when
    there is no launcher or the group already runs)."""
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return False
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method="env://")
    return True


def destroy_group() -> None:
    """Leave the process group. A CUDA graph that captured an NCCL
    collective holds the communicator (NCCL's persistent plan), and the
    communicator is not torn down while such a graph lives: the training
    step's graphs, which their runtime keeps in a reference cycle, are
    collected first."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    dist.destroy_process_group()


def _active(mesh: Mesh) -> bool:
    return mesh.group is not None


def check_divides(mesh: Mesh, n: int, what: str) -> None:
    """A batch placed on the 'data' axis must divide over it (the JAX
    package's device_put and jit raise the same way)."""
    if n % mesh.n_data:
        raise ValueError(f"{what} of {n} does not divide over {mesh.n_data} data-parallel ranks")


def shard_batch(mesh: Mesh, x, axis: int = 0):
    """This rank's rows of `x` (a tensor or an array) along `axis`."""
    if mesh.n_data == 1:
        return x
    index = [slice(None)] * axis + [mesh.rows(x.shape[axis])]
    return x[tuple(index)]


def stacked_shard_batch(mesh: Mesh, x):
    """This rank's rows of a [K, B, ...] stack of K per-step batches (the
    JAX module's `stacked_batch_sharding`: K replicated, B sharded)."""
    return shard_batch(mesh, x, axis=1)


def all_reduce_mean(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The mean over ranks of each tensor, by one all-reduce of one flat
    fp32 buffer; returns views of that buffer in the tensors' shapes. NCCL
    averages in the collective; gloo, which has no average, sums and the
    sum is divided here."""
    if not _active(mesh):
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    if dist.get_backend(mesh.group) == "nccl":
        dist.all_reduce(flat, op=dist.ReduceOp.AVG, group=mesh.group)
    else:
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
        flat /= mesh.world
    out, start = [], 0
    for t in tensors:
        out.append(flat[start:start + t.numel()].view(t.shape))
        start += t.numel()
    return out


def gather_rows(mesh: Mesh, x: torch.Tensor, n: int) -> torch.Tensor:
    """Every data coordinate's rows (`Mesh.rows(n)`) of a batch of n, in
    order, on every rank, gathered over the data group (the model ranks of
    a data coordinate hold the same rows). Each part is padded to
    ceil(n / n_data) rows for the gather and cut back after it."""
    if mesh.data_group is None:
        return x
    per = -(-n // mesh.n_data)
    padded = x.new_zeros((per, *x.shape[1:]))
    padded[: x.shape[0]] = x
    parts = [torch.empty_like(padded) for _ in range(mesh.n_data)]
    dist.all_gather(parts, padded.contiguous(), group=mesh.data_group)
    return torch.cat(parts)[:n]


def replicate(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> None:
    """Rank 0's values of `tensors` on every rank, in place."""
    if not _active(mesh):
        return
    for t in tensors:
        dist.broadcast(t.data, src=0, group=mesh.group)


def barrier(mesh: Mesh) -> None:
    """Wait for every rank (after rank 0 has written)."""
    if _active(mesh):
        dist.barrier(group=mesh.group)
