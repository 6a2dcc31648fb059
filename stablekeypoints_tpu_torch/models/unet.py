"""Stable Diffusion UNet (PyTorch, NHWC) with functional attention capture.

Cross-attention layers in the up path return their upsampled-query token
attention maps; there are no hooks. Capture rule: up-path cross-attention
layers whose query sequence is <= 32^2, the first 4 in execution order
(at 512^2 inputs: the three 16^2 layers of up_1 and the first 32^2 layer of
up_2); only the first block of a transformer stack captures. With
`truncate=True` the forward returns right after the last captured map: the
rest of the up path feeds nothing the keypoints read.

Three backbones share the module: SD-1.x (8 heads), SD-2.x (fixed 64-dim
heads, 1024-dim context) and SDXL (3 blocks, transformer depths (1, 2, 10),
64-dim heads, 2048-dim context, and micro-conditioning: fourier-embedded
`time_ids` with a pooled text embedding, projected and added to the time
embedding). At SDXL 1024^2 only up_0's three 32^2 stacks qualify for
capture, so 3 maps are captured and the forward is never truncated.
SD-2.x and SDXL checkpoints store the transformers' proj_in/proj_out as
linears (`linear_projection`); the port keeps them 1x1 convs (the same
product) and the checkpoint loader reshapes (`models/weights.py`).

Built for a model axis (`UNet(config, axis)`, `parallel/tensor.py`), the
resnets and every transformer stack whose heads (`heads_for`, the global
count) the axis divides hold this rank's Megatron slice; the SDXL added
embedding, the convs outside the resnets' pair and the stacks it does not
divide stay whole.

`remat` (the JAX package's `nn.remat` of the transformers, and of the
resnets under `remat_resnets`) runs each such block through
`torch.utils.checkpoint` while a gradient is taken: the backward recomputes
the block's forward, kernels included, instead of keeping its activations.
A transformer returns its captured map beside its output, and the caller
appends it to `captures` outside the checkpointed call, so the recompute
adds no map. The `Runtime` sets `remat` from `Config.remat`
(`pipeline/runtime.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from stablekeypoints_tpu_torch.models.layers import (
    Conv2d,
    Downsample,
    GroupNorm,
    ResnetBlock,
    TimestepEmbedder,
    Transformer2D,
    Upsample,
    timestep_embedding,
)
from stablekeypoints_tpu_torch.parallel.tensor import ModelAxis

__all__ = ["UNetConfig", "UNet", "SD15_CONFIG", "SD21_CONFIG", "SDXL_CONFIG",
           "tiny_unet_config", "sd21_tiny_config", "sdxl_tiny_config"]


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Topology of the UNet; the JAX package's fields, minus its TPU knob
    pallas_interpret, which has no meaning here."""

    in_channels: int = 4
    out_channels: int = 4
    block_channels: tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    attn_blocks: tuple[bool, ...] = (True, True, True, False)
    transformer_depth: tuple[int, ...] = (1, 1, 1, 1)
    num_heads: int = 8
    # recompute in the backward instead of storing: the transformers, and
    # under remat_resnets the resnets too (the JAX package's defaults; the
    # Runtime resolves remat from Config.remat)
    remat: bool = True
    remat_resnets: bool = False
    head_dim_fixed: Optional[int] = None
    context_dim: int = 768
    time_embed_dim_mult: int = 4
    # SDXL micro-conditioning: the pooled text embedding's width (0: none)
    # and the fourier width of each of the 6 time_ids
    addition_emb_dim: int = 0
    addition_time_dim: int = 256
    # checkpoints store proj_in/proj_out as linears (SD-2.x, SDXL); read only
    # by the checkpoint loader
    linear_projection: bool = False
    # what the UNet predicts: "epsilon" (SD-1.x) or "v_prediction" (the
    # SD-2.x 768 checkpoints); generation converts v to epsilon
    prediction_type: str = "epsilon"
    max_capture_layers: int = 4
    capture_max_seq: int = 32 * 32
    pallas_capture: bool = False  # K1 capture kernel
    capture_bf16: bool = False  # captured maps in bf16 (fp32 head-mean)
    capture_fp32_bwd: bool = False  # K1/K2 backward: dsim in fp32 through the products
    flash_attention: bool = False  # K3/K4/K5 attention kernels

    def heads_for(self, channels: int) -> tuple[int, int]:
        if self.head_dim_fixed is not None:
            return channels // self.head_dim_fixed, self.head_dim_fixed
        return self.num_heads, channels // self.num_heads


SD15_CONFIG = UNetConfig()

# SD-2.x (stabilityai/stable-diffusion-2-1[-base]): SD-1.5's blocks with
# 64-dim heads (5, 10, 20, 20 of them), the 1024-dim OpenCLIP context and
# linear projections
SD21_CONFIG = UNetConfig(num_heads=0, head_dim_fixed=64, context_dim=1024,
                         linear_projection=True)

# SDXL-base (stabilityai/stable-diffusion-xl-base-1.0): 3 blocks, no
# attention in the first, transformer depths (1, 2, 10), 64-dim heads, the
# 2048-dim context, micro-conditioning
SDXL_CONFIG = UNetConfig(block_channels=(320, 640, 1280), attn_blocks=(False, True, True),
                         transformer_depth=(1, 2, 10), num_heads=0, head_dim_fixed=64,
                         context_dim=2048, addition_emb_dim=1280, linear_projection=True)


def tiny_unet_config(context_dim: int = 32, remat: bool = False) -> UNetConfig:
    """A scaled-down config with the same topology, for tests (remat off,
    as the JAX package's)."""
    return UNetConfig(block_channels=(32, 64, 128, 128), num_heads=4, context_dim=context_dim,
                      remat=remat)


def sd21_tiny_config() -> UNetConfig:
    """The SD-2.x topology scaled down, for tests: fixed 16-dim heads,
    linear projections."""
    return dataclasses.replace(tiny_unet_config(context_dim=48), num_heads=0, head_dim_fixed=16,
                               linear_projection=True)


def sdxl_tiny_config() -> UNetConfig:
    """The SDXL topology scaled down, for tests."""
    return UNetConfig(block_channels=(32, 64, 128), attn_blocks=(False, True, True),
                      transformer_depth=(1, 2, 2), num_heads=0, head_dim_fixed=16,
                      context_dim=48, addition_emb_dim=32, addition_time_dim=8, remat=False)


def _transformer(cfg: UNetConfig, ch: int, depth: int,
                 axis: Optional[ModelAxis] = None) -> Transformer2D:
    heads, dim_head = cfg.heads_for(ch)
    return Transformer2D(
        ch, heads, dim_head, cfg.context_dim, depth,
        pallas_capture=cfg.pallas_capture, capture_bf16=cfg.capture_bf16,
        flash=cfg.flash_attention, capture_fp32_bwd=cfg.capture_fp32_bwd, axis=axis,
    )


def _call(module: nn.Module, remat: bool, *args):
    """module(*args), recomputed in the backward (activation checkpointing)
    under `remat` while a gradient is taken."""
    if remat and torch.is_grad_enabled():
        # no random draws inside a block: nothing to replay, and CUDA graph
        # capture refuses reading the generator's state
        return checkpoint(module, *args, use_reentrant=False, preserve_rng_state=False)
    return module(*args)


class DownBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, b: int, cin: int, temb_dim: int,
                 axis: Optional[ModelAxis] = None):
        super().__init__()
        self.cfg = cfg
        ch = cfg.block_channels[b]
        self.n = cfg.layers_per_block
        self.has_attn = cfg.attn_blocks[b]
        for i in range(self.n):
            self.add_module(f"resnets_{i}", ResnetBlock(cin if i == 0 else ch, ch, temb_dim,
                                                        axis=axis))
            if self.has_attn:
                self.add_module(f"attentions_{i}",
                                _transformer(cfg, ch, cfg.transformer_depth[b], axis))
        self.downsample = Downsample(ch) if b < len(cfg.block_channels) - 1 else None

    def forward(self, x, temb, context):
        cfg = self.cfg
        skips = []
        for i in range(self.n):
            x = _call(getattr(self, f"resnets_{i}"), cfg.remat and cfg.remat_resnets, x, temb)
            if self.has_attn:
                x, _ = _call(getattr(self, f"attentions_{i}"), cfg.remat, x, context)
            skips.append(x)
        if self.downsample is not None:
            x = self.downsample(x)
            skips.append(x)
        return x, skips


class MidBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, temb_dim: int, axis: Optional[ModelAxis] = None):
        super().__init__()
        self.cfg = cfg
        ch = cfg.block_channels[-1]
        depth = cfg.transformer_depth[-1] if cfg.attn_blocks[-1] else 1
        self.resnets_0 = ResnetBlock(ch, ch, temb_dim, axis=axis)
        self.attentions_0 = _transformer(cfg, ch, depth, axis)
        self.resnets_1 = ResnetBlock(ch, ch, temb_dim, axis=axis)

    def forward(self, x, temb, context):
        cfg = self.cfg
        res = cfg.remat and cfg.remat_resnets
        x = _call(self.resnets_0, res, x, temb)
        x, _ = _call(self.attentions_0, cfg.remat, x, context)
        return _call(self.resnets_1, res, x, temb)


class UpBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, b: int, cin: int, skip_channels: list[int],
                 temb_dim: int, axis: Optional[ModelAxis] = None):
        super().__init__()
        rev = tuple(reversed(cfg.block_channels))
        ch = rev[b]
        self.cfg = cfg
        self.n = cfg.layers_per_block + 1
        self.has_attn = tuple(reversed(cfg.attn_blocks))[b]
        depth = tuple(reversed(cfg.transformer_depth))[b]
        for i in range(self.n):
            rin = (cin if i == 0 else ch) + skip_channels[i]
            self.add_module(f"resnets_{i}", ResnetBlock(rin, ch, temb_dim, axis=axis))
            if self.has_attn:
                self.add_module(f"attentions_{i}", _transformer(cfg, ch, depth, axis))
        self.upsample = Upsample(ch) if b < len(rev) - 1 else None

    def forward(self, x, skips, temb, context, capture_res, truncate, captures):
        """Returns (x, truncated); appends captured maps to `captures`."""
        cfg = self.cfg
        for i in range(self.n):
            skip = skips.pop()
            x = torch.cat([x, skip.to(x.dtype)], dim=-1)
            x = _call(getattr(self, f"resnets_{i}"), cfg.remat and cfg.remat_resnets, x, temb)
            if self.has_attn:
                seq = x.shape[1] * x.shape[2]
                do_capture = (
                    capture_res is not None
                    and seq <= cfg.capture_max_seq
                    and len(captures) < cfg.max_capture_layers
                )
                x, cap = _call(getattr(self, f"attentions_{i}"), cfg.remat, x, context,
                               capture_res if do_capture else None)
                if cap is not None:  # appended outside the checkpointed call
                    captures.append(cap)
                    if truncate and len(captures) >= cfg.max_capture_layers:
                        return x, True
        if self.upsample is not None:
            x = self.upsample(x)
        return x, False


class UNet(nn.Module):
    """forward returns (eps prediction, [captured maps]); eps is None when
    the forward was truncated after the last capture. `axis`: this rank's
    model axis (None: the whole UNet)."""

    def __init__(self, config: UNetConfig = SD15_CONFIG, axis: Optional[ModelAxis] = None):
        super().__init__()
        cfg = self.config = config
        self.axis = axis if axis is not None and axis.size > 1 else None
        axis = self.axis
        chans = cfg.block_channels
        model_dim = chans[0]
        temb_dim = model_dim * cfg.time_embed_dim_mult
        self.time_embedding = TimestepEmbedder(model_dim, temb_dim)
        if cfg.addition_emb_dim > 0:
            self.add_embedding_linear_1 = nn.Linear(
                cfg.addition_emb_dim + 6 * cfg.addition_time_dim, temb_dim)
            self.add_embedding_linear_2 = nn.Linear(temb_dim, temb_dim)
        self.conv_in = Conv2d(cfg.in_channels, model_dim, 3)
        skip_ch = [model_dim]
        cin = model_dim
        for b, ch in enumerate(chans):
            self.add_module(f"down_{b}", DownBlock(cfg, b, cin, temb_dim, axis))
            skip_ch += [ch] * cfg.layers_per_block
            if b < len(chans) - 1:
                skip_ch.append(ch)
            cin = ch
        self.mid = MidBlock(cfg, temb_dim, axis)
        for b, ch in enumerate(reversed(chans)):
            skips = [skip_ch.pop() for _ in range(cfg.layers_per_block + 1)]
            self.add_module(f"up_{b}", UpBlock(cfg, b, cin, skips, temb_dim, axis))
            cin = ch
        self.conv_norm_out = GroupNorm(model_dim, act="silu")
        self.conv_out = Conv2d(model_dim, cfg.out_channels, 3)

    def _added_embedding(self, batch: int, added_cond: Optional[dict], device):
        """SDXL: [text_embeds, fourier(time_ids)] -> linear -> SiLU -> linear.
        text_embeds [B, addition_emb_dim] and time_ids [B, 6] default to
        zeros (the learned context replaces the text encoders)."""
        cfg = self.config
        added_cond = added_cond or {}
        text = added_cond.get("text_embeds")
        if text is None:
            text = torch.zeros((batch, cfg.addition_emb_dim), device=device)
        time_ids = added_cond.get("time_ids")
        if time_ids is None:
            time_ids = torch.zeros((batch, 6), device=device)
        tid = timestep_embedding(time_ids.reshape(-1), cfg.addition_time_dim).reshape(batch, -1)
        aug = torch.cat([text.float(), tid], dim=-1).to(self.add_embedding_linear_1.weight.dtype)
        return self.add_embedding_linear_2(F.silu(self.add_embedding_linear_1(aug)))

    def forward(self, latents, timesteps, context, capture_res: Optional[int] = None,
                truncate: bool = False, added_cond: Optional[dict] = None):
        """latents [B, H, W, C] (NHWC), timesteps [B], context [B, T, d];
        added_cond {'text_embeds', 'time_ids'} (SDXL; ignored otherwise)."""
        cfg = self.config
        dtype = self.conv_in.weight.dtype
        temb = self.time_embedding(timesteps)
        if cfg.addition_emb_dim > 0:
            temb = temb + self._added_embedding(latents.shape[0], added_cond, latents.device)
        x = self.conv_in(latents.to(dtype))
        context = context.to(dtype)
        skips = [x]
        for b in range(len(cfg.block_channels)):
            x, block_skips = getattr(self, f"down_{b}")(x, temb, context)
            skips.extend(block_skips)
        x = self.mid(x, temb, context)
        captures: list[torch.Tensor] = []
        for b in range(len(cfg.block_channels)):
            x, truncated = getattr(self, f"up_{b}")(
                x, skips, temb, context, capture_res, truncate, captures
            )
            if truncated:
                return None, captures
        eps = self.conv_out(self.conv_norm_out(x))
        return eps.float(), captures

