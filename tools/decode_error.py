#!/usr/bin/env python3
"""Where a bf16 VAE decode's error arises, on the card.

    python3 tools/decode_error.py        # from the repo root, one CUDA device

Three SD VAEs with the same weights decode the same latents [2, 64, 64, 4]:
the kernel path (K4 d-512 attention, K6, K7), the plain PyTorch layers in
bf16, and the plain layers in fp32 (the reference). Two weight sets: the
fabricated checkpoint of `chip_smoke.py`'s `[weights]` phase (the VAE of
`fabricate_checkpoint(seed=11, stddev=0.02)`: N(0, 0.02) weights and biases,
convs x0.3, norm scales 1 + 0.1 N) and the seeded init (`init_random`).
Prints, end to end, each bf16 path's max abs error over the reference's max
and the cosine; then layer by layer, each bf16 module fed the reference's
input (cast to bf16), its local error over the reference output's max, and
that output's mean and std. Imports no JAX.
"""

from __future__ import annotations

import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from stablekeypoints_tpu_torch.models import weights as W  # noqa: E402
from stablekeypoints_tpu_torch.models.vae import SD_VAE_CONFIG, VAE  # noqa: E402


def build(state, dtype, kernels: bool) -> VAE:
    with torch.device("meta"):
        vae = VAE(SD_VAE_CONFIG, flash=kernels, fused_gn=kernels, fused_gn_conv=kernels)
    vae = W.cast_module(vae, dtype).to_empty(device="cuda")
    return W.copy_state(vae, state).eval()


def err(got, want):
    got, want = got.float(), want.float()
    e = ((got - want).abs().max() / want.abs().max()).item()
    cos = torch.nn.functional.cosine_similarity(got.flatten(), want.flatten(), dim=0).item()
    return e, cos


def stages(dec):
    """(name, module) in the decoder's execution order."""
    cfg = dec.config
    out = [("post_quant_conv", dec.post_quant_conv), ("conv_in", dec.conv_in),
           ("mid_resnets_0", dec.mid_resnets_0), ("mid_attn", dec.mid_attn),
           ("mid_resnets_1", dec.mid_resnets_1)]
    for b in range(len(cfg.block_channels)):
        for i in range(cfg.layers_per_block + 1):
            out.append((f"up_{b}_resnets_{i}", getattr(dec, f"up_{b}_resnets_{i}")))
        if b < len(cfg.block_channels) - 1:
            out.append((f"up_{b}_upsample", getattr(dec, f"up_{b}_upsample")))
    out += [("conv_norm_out", dec.conv_norm_out), ("conv_out", dec.conv_out)]
    return out


@torch.inference_mode()
def report(label, state, lat):
    ref = build(state, torch.float32, False)
    paths = {"kernels": build(state, torch.bfloat16, True),
             "plain": build(state, torch.bfloat16, False)}
    want = ref.decode(lat)
    for name, vae in paths.items():
        e, cos = err(vae.decode(lat), want)
        print(f"[{label}] decode, {name} bf16 vs fp32: max abs err / max {e:.3e}, cosine {cos:.5f}")
    x = lat / SD_VAE_CONFIG.scaling_factor
    for (name, m_ref), (_, m_k), (_, m_p) in zip(*(stages(v.decoder) for v in
                                                   (ref, paths["kernels"], paths["plain"]))):
        y = m_ref(x)
        xb = x.to(torch.bfloat16)
        ek, _ = err(m_k(xb), y)
        ep, _ = err(m_p(xb), y)
        print(f"[{label}] {name:<16} out mean {y.float().mean().item():+.3e} std "
              f"{y.float().std().item():.3e}: local err kernels {ek:.3e}, plain {ep:.3e}")
        x = y


def main():
    if not torch.cuda.is_available():
        print("decode_error: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"{torch.cuda.get_device_name(0)}")
    gen = torch.Generator(device="cuda").manual_seed(15)
    lat = torch.randn((2, 64, 64, 4), generator=gen, device="cuda")
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in VAE(SD_VAE_CONFIG).state_dict().items()}
    fab = W.fabricate_state_dict(W.vae_conversion_rules(SD_VAE_CONFIG), shapes, 12,
                                 conv_scale=0.3, stddev=0.02)
    rules = dict(W.vae_conversion_rules(SD_VAE_CONFIG))
    report("fabricated", {rules[k]: v for k, v in fab.items()}, lat)
    with torch.device("meta"):
        seeded = VAE(SD_VAE_CONFIG)
    seeded = W.init_random(seeded.to_empty(device="cuda"), 1)
    report("seeded", {k: v.float() for k, v in seeded.state_dict().items()}, lat)
    return 0


if __name__ == "__main__":
    sys.exit(main())
