"""Tensor parallelism over a mesh's 'model' axis: the Megatron split of the
UNet (the JAX package's `parallel/mesh.py` `_param_spec` /
`tensor_parallel_shardings`, there a layout that GSPMD partitions).

Each of the n ranks of a model group holds a slice of the UNet:

- transformer blocks: to_q / to_k / to_v and the GEGLU's proj_in are
  column-parallel (a rank holds h/n heads, and F/n rows of *each* half
  [a | g] of proj_in, so that its a and g halves pair up); to_out and the
  GEGLU's proj_out are row-parallel, their biases added once after the
  all-reduce. The capture (K1/K2) sums the rank's heads' softmaxes over the
  layer's total heads and one all-reduce completes the head-mean;
- resnets: conv1, time_emb_proj and norm2 are column-parallel (norm2 runs
  on the rank's channels with 32/n groups, whole groups: n must divide the
  32 groups), conv2 is row-parallel, its bias added after the all-reduce;
- everything else is replicated: norm1, conv_shortcut, the transformers'
  LayerNorms (their norm2 included, which the JAX rules guard against),
  GroupNorm and 1x1 proj_in / proj_out, the time and SDXL added
  embeddings, conv_in / conv_out and the samplers, and the VAE.

A transformer stack whose head count n does not divide (SD-2.x's 5-head
stacks at n = 2 and 4, SDXL's 10-head stacks at n = 4) stays whole on every
rank, as the JAX kernels fall back to their replicated call there; its
weights are then replicated on every rank, where the JAX layout still
shards them and GSPMD gathers them for the call.

The activations stay replicated between the blocks. Two autograd functions
carry them across a split block: `copy_to_model` (identity forward,
all-reduce of the gradient backward) at the input of each column-parallel
block, and `reduce_from_model` (all-reduce forward, identity backward)
after each row-parallel block and after the capture's partial head-mean.
The learned context enters the cross-attentions' column-parallel to_k /
to_v without `copy_to_model`: each model rank's context gradient is its
heads' part, and the training step's one all-reduce over the world sums
the parts (`pipeline/runtime.py`); a stack kept whole scales its context
gradient by 1/n (`whole_context`) so that the sum counts it once.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Mapping, Optional

import torch
import torch.distributed as dist

__all__ = ["GROUPS", "ModelAxis", "all_reduce_counts", "check_groups", "copy_to_model",
           "full_unet_shapes", "predicted_all_reduces", "reduce_from_model", "shard_unet_state",
           "split_plan", "splits_heads", "take_slice", "whole_context", "whole_stacks"]

GROUPS = 32  # the UNet's GroupNorm groups


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """This rank's place in its model group: `size` ranks, this one `rank`.
    `group` is None for an axis that only shapes modules (no collective)."""

    rank: int
    size: int
    group: Optional[dist.ProcessGroup] = None


# model-group all-reduces issued by this process, by direction (a forward's
# row-parallel outputs and captures; a backward's column-parallel inputs)
all_reduce_counts = {"forward": 0, "backward": 0}


def splits_heads(heads: int, axis: Optional[ModelAxis]) -> bool:
    """Whether a transformer stack of `heads` heads is split over `axis`."""
    return axis is not None and axis.size > 1 and heads % axis.size == 0


def check_groups(channels: int, axis: ModelAxis) -> int:
    """The GroupNorm groups of a resnet's norm2 on one rank's channels
    (the whole width's gcd(32, C) groups over axis.size ranks)."""
    groups = math.gcd(GROUPS, channels)
    if groups % axis.size:
        raise ValueError(f"{axis.size} model ranks do not divide the {groups} GroupNorm groups "
                         f"of {channels} channels")
    return groups // axis.size


def _all_reduce(x: torch.Tensor, axis: ModelAxis, direction: str) -> None:
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=axis.group)
    all_reduce_counts[direction] += 1


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient's parts summed over the model group."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # the gradient of a split block's input is the sum of its
        # projections' gradients: a fresh tensor, reduced in place
        g = g.contiguous()
        _all_reduce(g, ctx.axis, "backward")
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce forward (in place: the partial is a fresh product that no
    backward reads); the gradient passes unchanged to every rank's part."""

    @staticmethod
    def forward(ctx, x, axis):
        _all_reduce(x, axis, "forward")
        ctx.mark_dirty(x)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to_model(x: torch.Tensor, axis: Optional[ModelAxis]) -> torch.Tensor:
    """A split block's replicated input: the gradient all-reduced backward."""
    if axis is None or not _grad(x):
        return x
    return _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis: Optional[ModelAxis]) -> torch.Tensor:
    """The sum over the model group of a row-parallel partial (in place)."""
    if axis is None:
        return x
    if _grad(x):
        return _ReduceFromModel.apply(x, axis)
    _all_reduce(x, axis, "forward")
    return x


def whole_context(context: torch.Tensor, axis: Optional[ModelAxis]) -> torch.Tensor:
    """The context as a whole stack reads it: its gradient there scaled by
    1/size, since the step sums the model ranks' context gradients."""
    if axis is None or not _grad(context):
        return context
    return _ScaleGrad.apply(context, 1.0 / axis.size)


# ---------------------------------------------------------------------------
# the split plan, by the full UNet's parameter names

_COLUMN = re.compile(r"\.(attn[12]\.to_[qkv]\.weight)$")
_ROW = re.compile(r"\.(attn[12]\.to_out|ff\.proj_out)\.weight$")
_HALVES = re.compile(r"\.ff\.proj_in\.(weight|bias)$")
_RES_COLUMN = re.compile(r"\.resnets_\d+\.(conv1|time_emb_proj|norm2)\.(weight|bias)$")
_RES_ROW = re.compile(r"\.resnets_\d+\.conv2\.weight$")
_STACK = re.compile(r"^((down_\d+|mid|up_\d+)\.attentions_\d+)\.")


def _stack_channels(config, block: str) -> int:
    chans = config.block_channels
    if block == "mid":
        return chans[-1]
    kind, b = block.split("_")
    return chans[int(b)] if kind == "down" else tuple(reversed(chans))[int(b)]


def whole_stacks(config, n_model: int) -> list[str]:
    """The transformer stacks (module paths) that n_model ranks keep whole:
    those whose heads n_model does not divide."""
    axis = ModelAxis(0, n_model)
    out = []
    for name in full_unet_shapes(config):
        m = _STACK.match(name)
        if m and m.group(1) not in out:
            heads = config.heads_for(_stack_channels(config, m.group(2)))[0]
            if not splits_heads(heads, axis):
                out.append(m.group(1))
    return out


def split_plan(config, n_model: int) -> dict[str, str]:
    """{UNet parameter name: how n_model ranks hold it}: "column" (a slice
    of dim 0: output rows or channels), "row" (a slice of dim 1: input
    columns or channels), "halves" (the GEGLU proj_in: a slice of dim 0 in
    each of its two halves) or "replicated"."""
    whole = {f"{s}." for s in whole_stacks(config, n_model)}
    plan = {}
    for name in full_unet_shapes(config):
        kind = "replicated"
        if n_model > 1:
            in_whole = any(name.startswith(s) for s in whole)
            if _RES_COLUMN.search(name):
                kind = "column"
            elif _RES_ROW.search(name):
                kind = "row"
            elif not in_whole and _COLUMN.search(name):
                kind = "column"
            elif not in_whole and _ROW.search(name):
                kind = "row"
            elif not in_whole and _HALVES.search(name):
                kind = "halves"
        plan[name] = kind
    return plan


_SHAPES: dict = {}


def full_unet_shapes(config) -> dict[str, tuple[int, ...]]:
    """{parameter name: shape} of the whole UNet of `config` (meta tensors)."""
    if config not in _SHAPES:  # a frozen dataclass: hashable
        from stablekeypoints_tpu_torch.models.unet import UNet

        with torch.device("meta"):
            unet = UNet(config)
        _SHAPES[config] = {k: tuple(v.shape) for k, v in unet.named_parameters()}
    return _SHAPES[config]


def take_slice(t: torch.Tensor, kind: str, rank: int, n: int) -> torch.Tensor:
    """Rank `rank`'s part of a whole parameter `t` of plan kind `kind`."""
    if kind == "replicated" or n == 1:
        return t
    if kind == "column":
        m = t.shape[0] // n
        return t[rank * m:(rank + 1) * m]
    if kind == "row":
        m = t.shape[1] // n
        return t[:, rank * m:(rank + 1) * m]
    if kind == "halves":
        f = t.shape[0] // 2
        m = f // n
        return torch.cat([t[rank * m:(rank + 1) * m], t[f + rank * m:f + (rank + 1) * m]])
    raise ValueError(f"unknown split kind {kind!r}")


def shard_unet_state(state: Mapping[str, torch.Tensor], config,
                     axis: Optional[ModelAxis]) -> dict[str, torch.Tensor]:
    """A whole UNet state dict -> this rank's slices (views of `state`'s
    tensors, where a slice is one; a checkpoint's host tensors are read
    only where a rank keeps them)."""
    if axis is None or axis.size == 1:
        return dict(state)
    plan = split_plan(config, axis.size)
    return {name: take_slice(torch.as_tensor(t), plan.get(name, "replicated"), axis.rank,
                             axis.size)
            for name, t in state.items()}


def predicted_all_reduces(config, n_model: int, latent_hw: int, capture_res=None,
                          truncate: bool = False, grad: bool = False) -> dict[str, int]:
    """The model-group all-reduces of one UNet forward at a latent of
    latent_hw^2 (capturing as the UNet's rule does at `capture_res`,
    returning after the last map under `truncate`), and with `grad` of the
    backward of the captured maps to the context, as the training step
    takes it (remat off): {"forward": .., "backward": ..}.

    Forward: 3 a split transformer block (attn1's and attn2's to_out, the
    GEGLU's proj_out), 1 a split capture, 1 a resnet (conv2). Backward: one
    a `copy_to_model` whose input needs a gradient and that lies before the
    last capture in the forward: the hidden states need one from the first
    cross-attention on (the context flows in there), the time embedding
    never does."""
    axis = ModelAxis(0, n_model)
    n = len(config.block_channels)
    fwd = 0
    inputs: list[bool] = []  # per copy_to_model in forward order: its input needs a gradient
    state = dict(needs=False, captures=0, upto=0)

    def resnet():
        nonlocal fwd
        if n_model > 1:
            fwd += 1
            inputs.append(state["needs"])

    def transformer(ch, depth, capture):
        nonlocal fwd
        split = splits_heads(config.heads_for(ch)[0], axis)
        for i in range(depth):
            if split:
                fwd += 3
                inputs.extend([state["needs"]] * 2)  # attn1's input, attn2's queries
            if capture and i == 0:
                state["captures"] += 1
                fwd += int(split)
                state["upto"] = len(inputs)
            state["needs"] = grad
            if split:
                inputs.append(True if grad else False)  # the GEGLU's input

    for b in range(n):
        for _ in range(config.layers_per_block):
            resnet()
            if config.attn_blocks[b]:
                transformer(config.block_channels[b], config.transformer_depth[b], False)
    resnet()
    transformer(config.block_channels[-1],
                config.transformer_depth[-1] if config.attn_blocks[-1] else 1, False)
    resnet()
    rev_ch, rev_attn = tuple(reversed(config.block_channels)), tuple(reversed(config.attn_blocks))
    rev_depth = tuple(reversed(config.transformer_depth))
    done = False
    for b in range(n):
        seq = (latent_hw >> (n - 1 - b)) ** 2
        for _ in range(config.layers_per_block + 1):
            resnet()
            if rev_attn[b]:
                capture = (capture_res is not None and seq <= config.capture_max_seq
                           and state["captures"] < config.max_capture_layers)
                transformer(rev_ch[b], rev_depth[b], capture)
                if capture and truncate and state["captures"] >= config.max_capture_layers:
                    done = True
                    break
        if done:
            break
    backward = sum(inputs[:state["upto"]]) if grad else 0
    return {"forward": fwd, "backward": backward}
