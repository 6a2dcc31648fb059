"""What parts two eager training steps of the PyTorch port from one state:
one cached step of SD-1.5 512^2 (batch 4), SD-2.1 768^2 (batch 2) or SDXL
1024^2 (batch 1) (full width, random weights from the seed, every kernel
auto) run several times from the same context, Adam state, inputs and
generator state, on one NVIDIA GPU.

    python3 tools/determinism_probe.py [--model sdxl|sd21|sd15] [--runs 3]

1. The context gradient and the context after the step of each run against
   the first: bitwise equal, or the largest difference over the largest
   magnitude.
2. The same runs again under torch.use_deterministic_algorithms(True,
   warn_only=True), set here and not in the program (with
   CUBLAS_WORKSPACE_CONFIG=:4096:8 for cuBLAS): PyTorch then takes its
   deterministic implementation where it has one (cuDNN's among them) and
   warns of each operation that has none, by name. The port's own CUDA
   kernels are outside what the switch sees; their backward entries are
   held bitwise across launches by chip_smoke.py's [kernels] phase.
3. One run under torch.profiler: the device kernels of the step whose names
   mark atomics (scatter, index_add, the grid sampler's backward), with
   their launches.
4. The runs of 2 again with F.grid_sample in ops/transforms.py swapped, in
   this script only, for the same bilinear taps and weights as a row
   gather: with F.grid_sample's own CUDA backward (float atomics) this
   showed it alone parted the runs; the port's sampler now sums its image
   gradient in fixed point (`scatter_add_fixed`), so 1 is bitwise equal
   too.

Prints the card's name and power limit; the last line is one JSON object
with the numbers. Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import types
import warnings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = {"sdxl": ("stabilityai/stable-diffusion-xl-base-1.0", 1024, 1),
          "sd21": ("stabilityai/stable-diffusion-2-1", 768, 2),
          "sd15": ("sd-legacy/stable-diffusion-v1-5", 512, 4)}
ATOMIC_MARKS = ("scatter", "index_add", "index_put", "grid_sampler", "atomic", "embedding_backward")


def gather_grid_sample(img, grid, mode="bilinear", padding_mode="zeros", align_corners=False):
    """F.grid_sample's bilinear taps and weights (zero padding, align_corners
    False) as a gather of NHWC rows: img [B, C, H, W], grid [B, Ho, Wo, 2]
    (x, y in [-1, 1]) -> [B, C, Ho, Wo]."""
    import torch

    assert mode == "bilinear" and padding_mode == "zeros" and not align_corners
    b, c, h, w = img.shape
    table = img.permute(0, 2, 3, 1).reshape(b * h * w, c)
    x = ((grid[..., 0].float() + 1) * w - 1) / 2
    y = ((grid[..., 1].float() + 1) * h - 1) / 2
    x0, y0 = torch.floor(x), torch.floor(y)
    base = torch.arange(b, device=img.device).view(b, 1, 1) * (h * w)
    out = 0
    for xi, wx in ((x0, x0 + 1 - x), (x0 + 1, x - x0)):
        for yi, wy in ((y0, y0 + 1 - y), (y0 + 1, y - y0)):
            ok = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            rows = base + yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
            out = out + table[rows] * (wx * wy * ok).unsqueeze(-1).to(img.dtype)
    return out.permute(0, 3, 1, 2)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", choices=sorted(MODELS), default="sdxl")
    parser.add_argument("--runs", type=int, default=3)
    args = parser.parse_args()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("determinism_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from stablekeypoints_tpu_torch.config import Config
    from stablekeypoints_tpu_torch.data.synthetic import SyntheticBlobs
    from stablekeypoints_tpu_torch.pipeline.runtime import Runtime

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    model_type, size, batch = MODELS[args.model]
    rt = Runtime.create(Config(model_type=model_type, image_size=size, batch_size=batch))
    data = SyntheticBlobs(length=batch, image_size=size)
    img = torch.from_numpy(np.stack([data[i]["img"] for i in range(batch)])).to(rt.device)
    lat = rt._encode(img)
    ctx0 = rt.init_context()
    warm = rt.train_context(ctx0)
    rt.train_step_cached(warm, rt.optimizer(warm), lat, img,
                         generator=torch.Generator(device=rt.device).manual_seed(3))
    torch.cuda.synchronize()

    def step():
        ctx = rt.train_context(ctx0)
        opt = rt.optimizer(ctx)
        rt.train_step_cached(ctx, opt, lat, img,
                             generator=torch.Generator(device=rt.device).manual_seed(3))
        torch.cuda.synchronize()
        return ctx.grad.detach().clone(), ctx.detach().clone()

    def compare(runs):
        g0, c0 = runs[0]
        out = []
        for g, c in runs[1:]:
            out.append(dict(grad_bitwise=bool(torch.equal(g, g0)),
                            grad_max_rel=((g - g0).abs().max() / g0.abs().max()).item(),
                            grad_elements_differ=int((g != g0).sum().item()),
                            context_rel=((c - c0).norm() / c0.norm()).item()))
        return out

    result = dict(model=args.model, card=card)
    result["default"] = compare([step() for _ in range(args.runs)])
    print(f"[probe] {args.model}: {args.runs} eager cached steps from one state, default "
          f"algorithms: {result['default']} | {card}", flush=True)

    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        runs = [step() for _ in range(args.runs)]
    torch.use_deterministic_algorithms(False)
    names = sorted({str(w.message).split(" does not have a deterministic")[0]
                    for w in caught if "deterministic" in str(w.message)})
    result["deterministic_switch"] = compare(runs)
    result["no_deterministic_implementation"] = names
    print(f"[probe] under use_deterministic_algorithms(True, warn_only=True): "
          f"{result['deterministic_switch']}; operations without a deterministic "
          f"implementation: {names} | {card}", flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
    kernels = {}
    for ev in prof.key_averages():
        if ev.device_type.name == "CUDA" and any(m in ev.key.lower() for m in ATOMIC_MARKS):
            kernels[ev.key[:120]] = ev.count
    result["atomic_kernels"] = kernels
    print(f"[probe] device kernels of one step named for atomics: {kernels} | {card}", flush=True)

    from stablekeypoints_tpu_torch.ops import transforms

    real_f = transforms.F
    transforms.F = types.SimpleNamespace(grid_sample=gather_grid_sample)
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        runs = [step() for _ in range(args.runs)]
    torch.use_deterministic_algorithms(False)
    transforms.F = real_f
    result["gather_sampler"] = compare(runs)
    result["gather_sampler_no_deterministic_implementation"] = sorted(
        {str(w.message).split(" does not have a deterministic")[0]
         for w in caught if "deterministic" in str(w.message)})
    print(f"[probe] the grid sampler as a row gather, under the switch: {result['gather_sampler']}; "
          f"operations without a deterministic implementation: "
          f"{result['gather_sampler_no_deterministic_implementation']} | {card}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
