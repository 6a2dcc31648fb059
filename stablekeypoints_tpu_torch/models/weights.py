"""Parameter initialization, diffusers checkpoints, and conversion from the
JAX package's trees.

`init_random` fills a module at full width from a seed, on the target
device (no host copy of the 860M UNet parameters is made).
`load_unet_state` / `load_vae_state` read a diffusers-layout checkpoint
directory (`unet/` and `vae/`, `*.safetensors` or `*.bin`) into this port's
state dicts by the JAX package's conversion rules, strictly: a file tensor
no rule names, a parameter the files lack, or a shape that differs raises.
Safetensors files are read by the small reader here (the format is an
8-byte little-endian header length, a JSON header of dtype, shape and
data_offsets, then the raw bytes), memory-mapped, so no package and no
second host copy is needed. `fabricate_checkpoint` writes a random
checkpoint in that layout (the load path's test input; no real weights
are needed).
`from_jax_params` turns the JAX package's parameter trees (nested dicts of
numpy arrays, as `jax.device_get` returns them) into this port's state
dicts, and `load_adam_state` puts optax's Adam state (count, mu, nu, as
numpy arrays) into a `torch.optim.Adam`, so a context and its optimizer
can continue in the port; neither imports JAX.
"""

from __future__ import annotations

import json
import mmap
import os
import re
import struct
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn as nn

from stablekeypoints_tpu_torch.models.unet import UNet
from stablekeypoints_tpu_torch.models.vae import VAE

__all__ = [
    "cast_module",
    "copy_state",
    "fabricate_checkpoint",
    "fabricate_state_dict",
    "from_jax_params",
    "init_random",
    "is_norm_param",
    "linear_projection_params",
    "load_adam_state",
    "load_safetensors",
    "load_unet_state",
    "load_vae_state",
    "read_state_dict",
    "save_safetensors",
    "unet_conversion_rules",
    "vae_conversion_rules",
]


def is_norm_param(name: str) -> bool:
    """Norm parameters (a path component containing 'norm') stay fp32."""
    return any("norm" in part for part in name.split(".")[:-1])


@torch.no_grad()
def init_random(module: nn.Module, seed: int, stddev: float = 0.02) -> nn.Module:
    """Uniform weights with the given stddev, zero biases, unit norm scales,
    drawn in parameter-name order from one generator on the module's device."""
    device = next(module.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    width = stddev * 3.46  # uniform with matching variance
    for name, p in sorted(module.named_parameters()):
        if p.dim() == 1:
            p.fill_(1.0 if is_norm_param(name) and name.endswith("weight") else 0.0)
        else:
            p.copy_((torch.rand(p.shape, generator=gen, device=device) - 0.5) * width)
    return module


@torch.no_grad()
def cast_module(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Matmul/conv weights to `dtype`, norm parameters fp32; 4-D conv
    weights in channels-last memory (what cuDNN takes for NHWC input)."""
    for name, p in module.named_parameters():
        data = p.data.float() if is_norm_param(name) else p.data.to(dtype)
        if data.dim() == 4:
            data = data.contiguous(memory_format=torch.channels_last)
        p.data = data
        p.requires_grad_(False)
    return module


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            yield from _flatten(val, path + ".")
        else:
            yield path, np.asarray(val, dtype=np.float32)


def _convert_tree(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    out = {}
    for path, arr in _flatten(tree):
        head, leaf = path.rsplit(".", 1)
        if leaf == "kernel":
            if arr.ndim == 4:  # conv HWIO -> OIHW
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:  # dense [in, out] -> [out, in]
                arr = arr.T
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        elif leaf != "bias":
            raise KeyError(f"unexpected parameter {path}")
        out[f"{head}.{leaf}"] = torch.from_numpy(np.array(arr, order="C"))
    return out


def from_jax_params(unet_tree: Mapping[str, Any], vae_tree: Mapping[str, Any]):
    """JAX parameter trees -> (UNet state dict, VAE state dict, encoder and
    decoder), of any backbone (SDXL's add_embedding_linear_1/2 included).
    Conv kernels HWIO -> OIHW (the transformers' 1x1 proj_in / proj_out too,
    which both packages hold as convs), dense kernels [in, out] -> [out,
    in], norm `scale` -> `weight`."""
    return _convert_tree(unet_tree), _convert_tree(vae_tree)


def load_adam_state(optimizer: torch.optim.Adam, count, mu, nu) -> torch.optim.Adam:
    """optax's `ScaleByAdamState` (count, mu, nu) for the optimizer's one
    parameter -> its `torch.optim.Adam` state (step, exp_avg, exp_avg_sq).
    The two keep the same moments and bias corrections."""
    (param,) = optimizer.param_groups[0]["params"]
    as_param = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(param.device).reshape(param.shape)  # noqa: E731
    optimizer.state[param] = {
        "step": torch.tensor(float(np.asarray(count))),
        "exp_avg": as_param(mu).clone(),
        "exp_avg_sq": as_param(nu).clone(),
    }
    return optimizer


@torch.no_grad()
def copy_state(module: nn.Module, state: Mapping[str, torch.Tensor]) -> nn.Module:
    """Copy a state dict into `module`, strictly (the same names and
    shapes), keeping each parameter's dtype, device and memory layout. Each
    source is cast to its parameter's dtype where it lies (on the host for
    a checkpoint) and then copied once to the parameter's device."""
    params = module.state_dict()
    missing, extra = sorted(set(params) - set(state)), sorted(set(state) - set(params))
    if missing or extra:
        raise KeyError(f"state dict does not match {type(module).__name__}: missing {missing[:8]}, "
                       f"unexpected {extra[:8]}")
    for name, p in params.items():
        src = torch.as_tensor(state[name])
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)}, the module has {tuple(p.shape)}")
        p.copy_(src.to(p.dtype))
    return module


# ---------------------------------------------------------------------------
# diffusers checkpoints
#
# The conversion rules are the JAX package's (models/weights.py
# `unet_conversion_rules` / `vae_conversion_rules`) with this port's
# parameter names on the right. diffusers stores convs OIHW and linears
# [out, in], as the port does, so every rule is a rename but one: SD-2.x
# and SDXL checkpoints (`linear_projection`) store the transformers'
# proj_in / proj_out as linears [out, in], which load into the port's 1x1
# convs [out, in, 1, 1] (the JAX rule "dense1x1"). That reshape, and no
# other, is allowed for exactly those parameters (`linear_projection_params`).


def _map_resnet() -> list[tuple[str, str]]:
    """(diffusers suffix, port suffix) for a resnet block."""
    return [(f"{m}.{p}", f"{m}.{p}")
            for m in ("norm1", "conv1", "time_emb_proj", "norm2", "conv2", "conv_shortcut")
            for p in ("weight", "bias")]


def _map_transformer(depth: int) -> list[tuple[str, str]]:
    """(diffusers suffix, port suffix) for a Transformer2DModel of `depth` blocks."""
    rules = [(f"{m}.{p}", f"{m}.{p}") for m in ("norm", "proj_in", "proj_out")
             for p in ("weight", "bias")]
    for d in range(depth):
        tb, ours = f"transformer_blocks.{d}", f"blocks_{d}"
        for attn in ("attn1", "attn2"):
            rules += [(f"{tb}.{attn}.{n}.weight", f"{ours}.{attn}.{n}.weight")
                      for n in ("to_q", "to_k", "to_v")]
            rules += [(f"{tb}.{attn}.to_out.0.{p}", f"{ours}.{attn}.to_out.{p}")
                      for p in ("weight", "bias")]
        for p in ("weight", "bias"):
            rules += [(f"{tb}.{n}.{p}", f"{ours}.{n}.{p}") for n in ("norm1", "norm2", "norm3")]
            rules += [(f"{tb}.ff.net.0.proj.{p}", f"{ours}.ff.proj_in.{p}"),
                      (f"{tb}.ff.net.2.{p}", f"{ours}.ff.proj_out.{p}")]
    return rules


def _prefixed(src: str, dst: str, rules) -> list[tuple[str, str]]:
    return [(f"{src}.{s}", f"{dst}.{d}") for s, d in rules]


_WB = [("weight", "weight"), ("bias", "bias")]


def _both(*names: str) -> list[tuple[str, str]]:
    """Weight and bias of layers whose name is the same on both sides."""
    return [(f"{n}.{p}", f"{n}.{p}") for n in names for p in ("weight", "bias")]


def unet_conversion_rules(config) -> list[tuple[str, str]]:
    """(diffusers name, port name) for every UNet parameter of `config`'s
    topology (rules for layers the topology lacks, e.g. a shortcut conv
    between equal widths, are dropped against the module at load time)."""
    rules = _both("conv_in", "time_embedding.linear_1", "time_embedding.linear_2",
                  "conv_norm_out", "conv_out")
    if config.addition_emb_dim > 0:  # SDXL micro-conditioning
        rules += [(f"add_embedding.linear_{i}.{p}", f"add_embedding_linear_{i}.{p}")
                  for i in (1, 2) for p in ("weight", "bias")]
    n_blocks = len(config.block_channels)
    for b in range(n_blocks):
        for i in range(config.layers_per_block):
            rules += _prefixed(f"down_blocks.{b}.resnets.{i}", f"down_{b}.resnets_{i}",
                               _map_resnet())
            if config.attn_blocks[b]:
                rules += _prefixed(f"down_blocks.{b}.attentions.{i}", f"down_{b}.attentions_{i}",
                                   _map_transformer(config.transformer_depth[b]))
        if b < n_blocks - 1:
            rules += _prefixed(f"down_blocks.{b}.downsamplers.0.conv", f"down_{b}.downsample.conv",
                               _WB)
    for i in (0, 1):
        rules += _prefixed(f"mid_block.resnets.{i}", f"mid.resnets_{i}", _map_resnet())
    mid_depth = config.transformer_depth[-1] if config.attn_blocks[-1] else 1
    rules += _prefixed("mid_block.attentions.0", "mid.attentions_0", _map_transformer(mid_depth))
    rev_attn = tuple(reversed(config.attn_blocks))
    rev_depth = tuple(reversed(config.transformer_depth))
    for b in range(n_blocks):
        for i in range(config.layers_per_block + 1):
            rules += _prefixed(f"up_blocks.{b}.resnets.{i}", f"up_{b}.resnets_{i}", _map_resnet())
            if rev_attn[b]:
                rules += _prefixed(f"up_blocks.{b}.attentions.{i}", f"up_{b}.attentions_{i}",
                                   _map_transformer(rev_depth[b]))
        if b < n_blocks - 1:
            rules += _prefixed(f"up_blocks.{b}.upsamplers.0.conv", f"up_{b}.upsample.conv",
                               _WB)
    return rules


def linear_projection_params(config) -> frozenset[str]:
    """Port names of the transformers' proj_in / proj_out weights that a
    `linear_projection` checkpoint stores as linears [out, in] (empty for
    SD-1.x, whose checkpoints store 1x1 convs)."""
    if not config.linear_projection:
        return frozenset()
    return frozenset(d for _, d in unet_conversion_rules(config)
                     if re.search(r"\.attentions_\d+\.proj_(in|out)\.weight$", d))


def vae_conversion_rules(config) -> list[tuple[str, str]]:
    """(diffusers name, port name) for every AutoencoderKL parameter, with
    the mid-block attention under its current names (to_q/to_k/to_v/to_out.0)."""
    rules = _both("encoder.conv_in", "encoder.conv_norm_out", "encoder.conv_out",
                  "decoder.conv_in", "decoder.conv_norm_out", "decoder.conv_out")
    rules += _prefixed("quant_conv", "encoder.quant_conv", _WB)
    rules += _prefixed("post_quant_conv", "decoder.post_quant_conv", _WB)
    resnet = [r for r in _map_resnet() if not r[0].startswith("time_emb")]
    n = len(config.block_channels)
    for b in range(n):
        for i in range(config.layers_per_block):
            rules += _prefixed(f"encoder.down_blocks.{b}.resnets.{i}",
                               f"encoder.down_{b}_resnets_{i}", resnet)
        for i in range(config.layers_per_block + 1):
            rules += _prefixed(f"decoder.up_blocks.{b}.resnets.{i}",
                               f"decoder.up_{b}_resnets_{i}", resnet)
        if b < n - 1:
            rules += _prefixed(f"encoder.down_blocks.{b}.downsamplers.0.conv",
                               f"encoder.down_{b}_downsample.conv", _WB)
            rules += _prefixed(f"decoder.up_blocks.{b}.upsamplers.0.conv",
                               f"decoder.up_{b}_upsample.conv", _WB)
    for side in ("encoder", "decoder"):
        for i in (0, 1):
            rules += _prefixed(f"{side}.mid_block.resnets.{i}", f"{side}.mid_resnets_{i}", resnet)
        a, ours = f"{side}.mid_block.attentions.0", f"{side}.mid_attn"
        rules += _prefixed(a, ours, [(f"group_norm.{p}", f"norm.{p}") for p in ("weight", "bias")]
                           + _both("to_q", "to_k", "to_v")
                           + [(f"to_out.0.{p}", f"to_out.{p}") for p in ("weight", "bias")])
    return rules


# diffusers <= 0.8 names the VAE's mid-block attention query/key/value/
# proj_attn (the reference pins diffusers 0.8.0); newer exports to_q/to_k/
# to_v/to_out.0. Checkpoints come in both layouts.
_LEGACY_VAE_ATTN = ((".query.", ".to_q."), (".key.", ".to_k."), (".value.", ".to_v."),
                    (".proj_attn.", ".to_out.0."))


def _modern_vae_name(name: str) -> str:
    if ".attentions." in name:
        for old, new in _LEGACY_VAE_ATTN:
            name = name.replace(old, new)
    return name


def _legacy_vae_name(name: str) -> str:
    if ".attentions." in name:
        for old, new in _LEGACY_VAE_ATTN:
            name = name.replace(new, old)
    return name


_ST_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}
_ST_CODES = {v: k for k, v in _ST_DTYPES.items()}


def load_safetensors(path: str) -> dict[str, torch.Tensor]:
    """A safetensors file -> {name: CPU tensor} (F32, F16, BF16), memory-
    mapped: each tensor is a view of the file's pages (copy-on-write, so
    the tensors are writable and the file is never written)."""
    with open(path, "rb") as f:
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    (n,) = struct.unpack("<Q", buf[:8])
    if 8 + n > len(buf):
        raise ValueError(f"{path}: header of {n} bytes in a file of {len(buf)}")
    header = json.loads(buf[8:8 + n])
    base, out = 8 + n, {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise TypeError(f"{path}: {name} has dtype {info['dtype']}; F32, F16 and BF16 are read")
        dtype = _ST_DTYPES[info["dtype"]]
        shape = tuple(info["shape"])
        start, end = info["data_offsets"]
        count = int(np.prod(shape, dtype=np.int64))
        if end - start != count * dtype.itemsize or base + end > len(buf):
            raise ValueError(f"{path}: {name} has offsets {start}..{end} for {shape} {dtype}")
        t = (torch.frombuffer(buf, dtype=dtype, count=count, offset=base + start) if count
             else torch.empty(0, dtype=dtype))
        out[name] = t.reshape(shape)
    return out


def save_safetensors(tensors: Mapping[str, torch.Tensor], path: str) -> str:
    """Write {name: tensor} (F32, F16, BF16) as a safetensors file, names in
    sorted order, the header padded to 8 bytes."""
    header, flat, offset = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().to("cpu").contiguous()
        if t.dtype not in _ST_CODES:
            raise TypeError(f"{name}: dtype {t.dtype}; F32, F16 and BF16 are written")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        flat.append(t.reshape(-1).view(torch.uint8).numpy())
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for a in flat:
            f.write(a.data)
    return path


def read_state_dict(component_dir: str) -> dict[str, torch.Tensor]:
    """A diffusers component directory -> {diffusers name: CPU tensor} in
    the files' dtypes: every `*.safetensors` in sorted order, else every
    `*.bin` (`torch.load`, weights only, memory-mapped)."""
    files = sorted(os.listdir(component_dir))
    sd: dict[str, torch.Tensor] = {}
    st = [f for f in files if f.endswith(".safetensors")]
    if st:
        for f in st:
            sd.update(load_safetensors(os.path.join(component_dir, f)))
        return sd
    bins = [f for f in files if f.endswith(".bin")]
    if bins:
        for f in bins:
            sd.update(torch.load(os.path.join(component_dir, f), map_location="cpu",
                                 weights_only=True, mmap=True))
        return sd
    raise FileNotFoundError(f"no safetensors/bin weights in {component_dir}")


def _module_shapes(module_cls, config) -> dict[str, tuple[int, ...]]:
    with torch.device("meta"):
        module = module_cls(config)
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def _convert(sd: Mapping[str, torch.Tensor], rules, shapes, what: str,
             linear: frozenset = frozenset()) -> dict[str, torch.Tensor]:
    """Rename by `rules` (those whose port name the module has), strictly;
    a port name in `linear` takes a linear [out, in] into its 1x1 conv
    [out, in, 1, 1], and no other shape."""
    rules = [(s, d) for s, d in rules if d in shapes]
    known = {s for s, _ in rules}
    extra = sorted(set(sd) - known)
    if extra:
        raise KeyError(f"{what}: {len(extra)} checkpoint tensors no conversion rule of this "
                       f"topology names, e.g. {extra[:5]}")
    out = {}
    for src, dst in rules:
        if src in sd:
            want = shapes[dst][:2] if dst in linear else shapes[dst]
            if tuple(sd[src].shape) != want:
                raise ValueError(f"{what}: {src} has shape {tuple(sd[src].shape)}, "
                                 f"{dst} takes {want}")
            out[dst] = sd[src].reshape(shapes[dst])
    missing = sorted(set(shapes) - set(out))
    if missing:
        raise KeyError(f"{what}: {len(missing)} parameters missing from the checkpoint, "
                       f"e.g. {missing[:5]}")
    return out


def load_unet_state(model_dir: str, config) -> dict[str, torch.Tensor]:
    """`{model_dir}/unet` -> the port's UNet state dict (CPU tensors in the
    files' dtypes; `Runtime` casts them to the parameters' dtypes)."""
    sd = read_state_dict(os.path.join(model_dir, "unet"))
    return _convert(sd, unet_conversion_rules(config), _module_shapes(UNet, config), "unet",
                    linear_projection_params(config))


def load_vae_state(model_dir: str, config) -> dict[str, torch.Tensor]:
    """`{model_dir}/vae` -> the port's VAE state dict (encoder and decoder);
    the mid-block attention may carry either generation of names."""
    sd = read_state_dict(os.path.join(model_dir, "vae"))
    sd = {_modern_vae_name(k): v for k, v in sd.items()}
    return _convert(sd, vae_conversion_rules(config), _module_shapes(VAE, config), "vae")


# ---------------------------------------------------------------------------
# checkpoint fabrication: random tensors in the exact diffusers layout, for
# testing the load path without real weights (the JAX package's
# `fabricate_checkpoint`, with shapes taken from the port's own modules)


def fabricate_state_dict(rules, shapes: Mapping[str, tuple[int, ...]], seed: int = 0,
                         conv_scale: float = 1.0, stddev: float = 0.2,
                         linear: frozenset = frozenset()) -> dict[str, torch.Tensor]:
    """{diffusers name: fp32 tensor} for the rules whose port name is in
    `shapes`: norm weights 1 + 0.1 N(0, 1), everything else stddev * N(0, 1),
    convs (4-D) damped by `conv_scale` (deep random conv stacks overflow
    otherwise); port names in `linear` are written as linears [out, in].
    Drawn from numpy's default_rng(seed) in rule order."""
    rng = np.random.default_rng(seed)
    sd = {}
    for src, dst in rules:
        if dst not in shapes:  # a layer this topology lacks (a shortcut between equal widths)
            continue
        shape = shapes[dst][:2] if dst in linear else shapes[dst]
        val = rng.standard_normal(shape, dtype=np.float32)
        if is_norm_param(dst) and dst.endswith(".weight"):
            val = 1.0 + 0.1 * val
        else:
            val *= stddev * (conv_scale if len(shape) == 4 else 1.0)
        sd[src] = torch.from_numpy(val)
    return sd


def _write_component(directory: str, sd: Mapping[str, torch.Tensor], fmt: str,
                     dtype: torch.dtype) -> None:
    os.makedirs(directory, exist_ok=True)
    sd = {k: v.to(dtype) for k, v in sd.items()}
    if fmt == "safetensors":
        save_safetensors(sd, os.path.join(directory, "diffusion_pytorch_model.safetensors"))
    elif fmt == "bin":
        torch.save(sd, os.path.join(directory, "diffusion_pytorch_model.bin"))
    else:
        raise ValueError(f"unknown checkpoint format: {fmt}")


def fabricate_checkpoint(model_dir: str, unet_config, vae_config, seed: int = 0,
                         fmt: str = "safetensors", dtype: torch.dtype = torch.float32,
                         vae_fmt: str | None = None, vae_dtype: torch.dtype | None = None,
                         legacy_vae_names: bool = False, stddev: float = 0.2) -> str:
    """Write `{model_dir}/{unet,vae}/diffusion_pytorch_model.{safetensors,bin}`
    with random weights for the given topologies (UNet from seed, VAE from
    seed + 1 with convs damped 0.3x, as the JAX package); returns model_dir.
    `vae_fmt` / `vae_dtype` default to `fmt` / `dtype`; `legacy_vae_names`
    writes the VAE attention under diffusers-0.8 names."""
    usd = fabricate_state_dict(unet_conversion_rules(unet_config),
                               _module_shapes(UNet, unet_config), seed, stddev=stddev,
                               linear=linear_projection_params(unet_config))
    _write_component(os.path.join(model_dir, "unet"), usd, fmt, dtype)
    del usd
    vsd = fabricate_state_dict(vae_conversion_rules(vae_config), _module_shapes(VAE, vae_config),
                               seed + 1, conv_scale=0.3, stddev=stddev)
    if legacy_vae_names:
        vsd = {_legacy_vae_name(k): v for k, v in vsd.items()}
    _write_component(os.path.join(model_dir, "vae"), vsd, vae_fmt or fmt, vae_dtype or dtype)
    return model_dir
