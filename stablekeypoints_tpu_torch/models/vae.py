"""AutoencoderKL (SD VAE), PyTorch, NHWC.

The keypoint path needs the encoder's posterior mean, scaled by the
config's scaling factor (0.18215 for SD-1.x and SD-2.x, 0.13025 for
SDXL); generation decodes latents back to images. Encoder and decoder route alike: GroupNorms to K6,
resnet GroupNorm + SiLU + 3x3 convs to K7, the mid attention to the d-512
flash kernel (K4). Where the JAX package runs `Conv3x3Split` (a TPU
workaround that folds H-slabs into the batch: the same conv), the port
runs a plain conv.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn

from stablekeypoints_tpu_torch.kernels import flash as k_flash
from stablekeypoints_tpu_torch.models.layers import (
    Conv2d,
    Downsample,
    GroupNorm,
    ResnetBlock,
    Upsample,
)

__all__ = ["VAEConfig", "AttnBlock", "Decoder", "Encoder", "VAE", "SD_VAE_CONFIG",
           "SDXL_VAE_CONFIG", "tiny_vae_config"]

SCALING_FACTOR = 0.18215


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_channels: tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    scaling_factor: float = SCALING_FACTOR


SD_VAE_CONFIG = VAEConfig()

# SDXL's retrained VAE: the same topology, latents scaled by 0.13025 (with
# SD's 0.18215 the UNet would see latents ~1.4x off its training scale)
SDXL_VAE_CONFIG = VAEConfig(scaling_factor=0.13025)


def tiny_vae_config() -> VAEConfig:
    return VAEConfig(block_channels=(16, 32, 32, 32), layers_per_block=1)


class AttnBlock(nn.Module):
    """Single-head self-attention over spatial positions (mid block); flash
    (K4) at d = channels = 512 and seq 4096 on 512^2 inputs."""

    def __init__(self, channels: int, flash: bool = False, fused_gn: bool = False):
        super().__init__()
        self.flash = flash
        self.norm = GroupNorm(channels, eps=1e-6, fused=fused_gn)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.Linear(channels, channels)

    def forward(self, x):
        b, h, w, c = x.shape
        residual = x
        x = self.norm(x).reshape(b, h * w, c)
        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        n = h * w
        scale = 1.0 / math.sqrt(c)
        q4, k4, v4 = (t.reshape(b, n, 1, c) for t in (q, k, v))
        if self.flash and k_flash.flash_supported(n, n, c):
            out = k_flash.flash_self_attention(q4, k4, v4, scale)
        else:
            out = k_flash.attention_plain(q4, k4, v4, scale)
        out = self.to_out(out.reshape(b, n, c).to(x.dtype))
        return residual + out.reshape(b, h, w, c)


class Encoder(nn.Module):
    """`fused_gn` routes the GroupNorms to K6; `fused_gn_conv` the resnets'
    GroupNorm + SiLU + 3x3 convs to K7 (JAX `Encoder`)."""

    def __init__(self, config: VAEConfig = SD_VAE_CONFIG, flash: bool = False,
                 fused_gn: bool = False, fused_gn_conv: bool = False):
        super().__init__()
        cfg = self.config = config
        chans = cfg.block_channels
        self.conv_in = Conv2d(cfg.in_channels, chans[0], 3)
        fused = dict(eps=1e-6, fused_norm=fused_gn, fused_gn_conv=fused_gn_conv)
        cin = chans[0]
        for b, ch in enumerate(chans):
            for i in range(cfg.layers_per_block):
                self.add_module(f"down_{b}_resnets_{i}", ResnetBlock(cin, ch, **fused))
                cin = ch
            if b < len(chans) - 1:
                self.add_module(f"down_{b}_downsample", Downsample(ch, asymmetric_pad=True))
        ch = chans[-1]
        self.mid_resnets_0 = ResnetBlock(ch, ch, **fused)
        self.mid_attn = AttnBlock(ch, flash=flash, fused_gn=fused_gn)
        self.mid_resnets_1 = ResnetBlock(ch, ch, **fused)
        self.conv_norm_out = GroupNorm(ch, eps=1e-6, act="silu", fused=fused_gn)
        self.conv_out = Conv2d(ch, cfg.latent_channels * 2, 3)
        self.quant_conv = Conv2d(cfg.latent_channels * 2, cfg.latent_channels * 2, 1)

    def forward(self, x):
        cfg = self.config
        x = self.conv_in(x)
        for b in range(len(cfg.block_channels)):
            for i in range(cfg.layers_per_block):
                x = getattr(self, f"down_{b}_resnets_{i}")(x)
            if b < len(cfg.block_channels) - 1:
                x = getattr(self, f"down_{b}_downsample")(x)
        x = self.mid_resnets_1(self.mid_attn(self.mid_resnets_0(x)))
        moments = self.quant_conv(self.conv_out(self.conv_norm_out(x)))
        return moments.float()  # [B, h/8, w/8, 2*latent]


class Decoder(nn.Module):
    """Latents -> images in [-1, 1] (JAX `Decoder`): post_quant_conv,
    conv_in, the mid resnets and attention, `len(block_channels)` up levels
    of layers_per_block + 1 resnets with a nearest-x2 upsample between
    levels, then GroupNorm + SiLU and conv_out. Routed as the encoder."""

    def __init__(self, config: VAEConfig = SD_VAE_CONFIG, flash: bool = False,
                 fused_gn: bool = False, fused_gn_conv: bool = False):
        super().__init__()
        cfg = self.config = config
        chans = cfg.block_channels
        fused = dict(eps=1e-6, fused_norm=fused_gn, fused_gn_conv=fused_gn_conv)
        ch = chans[-1]
        self.post_quant_conv = Conv2d(cfg.latent_channels, cfg.latent_channels, 1)
        self.conv_in = Conv2d(cfg.latent_channels, ch, 3)
        self.mid_resnets_0 = ResnetBlock(ch, ch, **fused)
        self.mid_attn = AttnBlock(ch, flash=flash, fused_gn=fused_gn)
        self.mid_resnets_1 = ResnetBlock(ch, ch, **fused)
        cin = ch
        for b, ch in enumerate(reversed(chans)):
            for i in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{b}_resnets_{i}", ResnetBlock(cin, ch, **fused))
                cin = ch
            if b < len(chans) - 1:
                self.add_module(f"up_{b}_upsample", Upsample(ch))
        self.conv_norm_out = GroupNorm(chans[0], eps=1e-6, act="silu", fused=fused_gn)
        self.conv_out = Conv2d(chans[0], cfg.in_channels, 3)

    def forward(self, z):
        cfg = self.config
        x = self.conv_in(self.post_quant_conv(z))
        x = self.mid_resnets_1(self.mid_attn(self.mid_resnets_0(x)))
        for b in range(len(cfg.block_channels)):
            for i in range(cfg.layers_per_block + 1):
                x = getattr(self, f"up_{b}_resnets_{i}")(x)
            if b < len(cfg.block_channels) - 1:
                x = getattr(self, f"up_{b}_upsample")(x)
        return self.conv_out(self.conv_norm_out(x)).float()  # [B, 8h, 8w, 3]


class VAE(nn.Module):
    def __init__(self, config: VAEConfig = SD_VAE_CONFIG, flash: bool = False,
                 fused_gn: bool = False, fused_gn_conv: bool = False):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config, flash, fused_gn, fused_gn_conv)
        self.decoder = Decoder(config, flash, fused_gn, fused_gn_conv)

    def encode_mean(self, images: torch.Tensor) -> torch.Tensor:
        """images in [-1, 1], NHWC -> scaled latent mean [B, H/8, W/8, 4] fp32."""
        moments = self.encoder(images)
        return moments[..., : self.config.latent_channels] * self.config.scaling_factor

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents [B, h, w, 4] -> images [B, 8h, 8w, 3] in about
        [-1, 1], fp32."""
        return self.decoder(latents / self.config.scaling_factor)
