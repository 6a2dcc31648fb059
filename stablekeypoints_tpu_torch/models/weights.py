"""Parameter initialization and conversion from the JAX package's trees.

`init_random` fills a module at full width from a seed, on the target
device (no host copy of the 860M UNet parameters is made).
`from_jax_params` turns the JAX package's parameter trees (nested dicts of
numpy arrays, as `jax.device_get` returns them) into this port's state
dicts, and `load_adam_state` puts optax's Adam state (count, mu, nu, as
numpy arrays) into a `torch.optim.Adam`, so a context and its optimizer
can continue in the port; neither imports JAX.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
import torch.nn as nn

__all__ = ["cast_module", "from_jax_params", "init_random", "is_norm_param", "load_adam_state"]


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
    """JAX parameter trees -> (UNet state dict, VAE state dict).

    Conv kernels HWIO -> OIHW, dense kernels [in, out] -> [out, in], norm
    `scale` -> `weight`. The VAE decoder's parameters are dropped (the
    port's VAE holds the encoder only)."""
    vae = {k: v for k, v in vae_tree.items() if k != "decoder"}
    return _convert_tree(unet_tree), _convert_tree(vae)


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
