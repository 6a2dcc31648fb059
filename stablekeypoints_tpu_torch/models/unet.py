"""Stable Diffusion UNet (PyTorch, NHWC) with functional attention capture.

Cross-attention layers in the up path return their upsampled-query token
attention maps; there are no hooks. Capture rule: up-path cross-attention
layers whose query sequence is <= 32^2, the first 4 in execution order
(at 512^2 inputs: the three 16^2 layers of up_1 and the first 32^2 layer of
up_2). With `truncate=True` the forward returns right after the last
captured map: the rest of the up path feeds nothing the keypoints read.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from stablekeypoints_tpu_torch.models.layers import (
    Conv2d,
    Downsample,
    GroupNorm,
    ResnetBlock,
    TimestepEmbedder,
    Transformer2D,
    Upsample,
)

__all__ = ["UNetConfig", "UNet", "SD15_CONFIG", "tiny_unet_config"]


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Topology of the UNet; the JAX package's fields, minus its TPU knobs
    (remat, pallas_interpret), which have no meaning here."""

    in_channels: int = 4
    out_channels: int = 4
    block_channels: tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    attn_blocks: tuple[bool, ...] = (True, True, True, False)
    transformer_depth: tuple[int, ...] = (1, 1, 1, 1)
    num_heads: int = 8
    head_dim_fixed: Optional[int] = None
    context_dim: int = 768
    time_embed_dim_mult: int = 4
    max_capture_layers: int = 4
    capture_max_seq: int = 32 * 32
    pallas_capture: bool = False  # K1 capture kernel
    capture_bf16: bool = False  # captured maps in bf16 (fp32 head-mean)
    capture_fp32_bwd: bool = False  # K1 backward: dsim in fp32 (plain version only)
    flash_attention: bool = False  # K3/K4/K5 attention kernels

    def heads_for(self, channels: int) -> tuple[int, int]:
        if self.head_dim_fixed is not None:
            return channels // self.head_dim_fixed, self.head_dim_fixed
        return self.num_heads, channels // self.num_heads


SD15_CONFIG = UNetConfig()


def tiny_unet_config(context_dim: int = 32) -> UNetConfig:
    """A scaled-down config with the same topology, for tests."""
    return UNetConfig(block_channels=(32, 64, 128, 128), num_heads=4, context_dim=context_dim)


def _transformer(cfg: UNetConfig, ch: int, depth: int) -> Transformer2D:
    heads, dim_head = cfg.heads_for(ch)
    return Transformer2D(
        ch, heads, dim_head, cfg.context_dim, depth,
        pallas_capture=cfg.pallas_capture, capture_bf16=cfg.capture_bf16,
        flash=cfg.flash_attention, capture_fp32_bwd=cfg.capture_fp32_bwd,
    )


class DownBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, b: int, cin: int, temb_dim: int):
        super().__init__()
        ch = cfg.block_channels[b]
        self.n = cfg.layers_per_block
        self.has_attn = cfg.attn_blocks[b]
        for i in range(self.n):
            self.add_module(f"resnets_{i}", ResnetBlock(cin if i == 0 else ch, ch, temb_dim))
            if self.has_attn:
                self.add_module(f"attentions_{i}", _transformer(cfg, ch, cfg.transformer_depth[b]))
        self.downsample = Downsample(ch) if b < len(cfg.block_channels) - 1 else None

    def forward(self, x, temb, context):
        skips = []
        for i in range(self.n):
            x = getattr(self, f"resnets_{i}")(x, temb)
            if self.has_attn:
                x, _ = getattr(self, f"attentions_{i}")(x, context)
            skips.append(x)
        if self.downsample is not None:
            x = self.downsample(x)
            skips.append(x)
        return x, skips


class MidBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, temb_dim: int):
        super().__init__()
        ch = cfg.block_channels[-1]
        depth = cfg.transformer_depth[-1] if cfg.attn_blocks[-1] else 1
        self.resnets_0 = ResnetBlock(ch, ch, temb_dim)
        self.attentions_0 = _transformer(cfg, ch, depth)
        self.resnets_1 = ResnetBlock(ch, ch, temb_dim)

    def forward(self, x, temb, context):
        x = self.resnets_0(x, temb)
        x, _ = self.attentions_0(x, context)
        return self.resnets_1(x, temb)


class UpBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, b: int, cin: int, skip_channels: list[int],
                 temb_dim: int):
        super().__init__()
        rev = tuple(reversed(cfg.block_channels))
        ch = rev[b]
        self.cfg = cfg
        self.n = cfg.layers_per_block + 1
        self.has_attn = tuple(reversed(cfg.attn_blocks))[b]
        depth = tuple(reversed(cfg.transformer_depth))[b]
        for i in range(self.n):
            rin = (cin if i == 0 else ch) + skip_channels[i]
            self.add_module(f"resnets_{i}", ResnetBlock(rin, ch, temb_dim))
            if self.has_attn:
                self.add_module(f"attentions_{i}", _transformer(cfg, ch, depth))
        self.upsample = Upsample(ch) if b < len(rev) - 1 else None

    def forward(self, x, skips, temb, context, capture_res, truncate, captures):
        """Returns (x, truncated); appends captured maps to `captures`."""
        cfg = self.cfg
        for i in range(self.n):
            skip = skips.pop()
            x = torch.cat([x, skip.to(x.dtype)], dim=-1)
            x = getattr(self, f"resnets_{i}")(x, temb)
            if self.has_attn:
                seq = x.shape[1] * x.shape[2]
                do_capture = (
                    capture_res is not None
                    and seq <= cfg.capture_max_seq
                    and len(captures) < cfg.max_capture_layers
                )
                x, cap = getattr(self, f"attentions_{i}")(
                    x, context, capture_res if do_capture else None
                )
                if cap is not None:
                    captures.append(cap)
                    if truncate and len(captures) >= cfg.max_capture_layers:
                        return x, True
        if self.upsample is not None:
            x = self.upsample(x)
        return x, False


class UNet(nn.Module):
    """forward returns (eps prediction, [captured maps]); eps is None when
    the forward was truncated after the last capture."""

    def __init__(self, config: UNetConfig = SD15_CONFIG):
        super().__init__()
        cfg = self.config = config
        chans = cfg.block_channels
        model_dim = chans[0]
        temb_dim = model_dim * cfg.time_embed_dim_mult
        self.time_embedding = TimestepEmbedder(model_dim, temb_dim)
        self.conv_in = Conv2d(cfg.in_channels, model_dim, 3)
        skip_ch = [model_dim]
        cin = model_dim
        for b, ch in enumerate(chans):
            self.add_module(f"down_{b}", DownBlock(cfg, b, cin, temb_dim))
            skip_ch += [ch] * cfg.layers_per_block
            if b < len(chans) - 1:
                skip_ch.append(ch)
            cin = ch
        self.mid = MidBlock(cfg, temb_dim)
        for b, ch in enumerate(reversed(chans)):
            skips = [skip_ch.pop() for _ in range(cfg.layers_per_block + 1)]
            self.add_module(f"up_{b}", UpBlock(cfg, b, cin, skips, temb_dim))
            cin = ch
        self.conv_norm_out = GroupNorm(model_dim, act="silu")
        self.conv_out = Conv2d(model_dim, cfg.out_channels, 3)

    def forward(self, latents, timesteps, context, capture_res: Optional[int] = None,
                truncate: bool = False):
        """latents [B, H, W, C] (NHWC), timesteps [B], context [B, T, d]."""
        cfg = self.config
        dtype = self.conv_in.weight.dtype
        temb = self.time_embedding(timesteps)
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

