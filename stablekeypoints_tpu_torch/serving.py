"""Serving export: freeze the trained detector into an artifact and serve it.

The JAX package exports the detection path with `jax.export`, one
StableHLO program per batch size with the weights baked in. PyTorch has no
`jax.export`, and the port's kernels are ctypes launches that
`torch.export` cannot trace. The port's counterpart of "one static program
per batch shape" is:

  * an artifact directory that holds the parameters the detect path reads
    (the UNet and the VAE encoder, in the dtype they run in), the learned
    context, the token indices, an optional stage-4 regressor and
    `manifest.json` (the JAX manifest's fields and the runtime's
    configuration);
  * `ServedDetector.load`, which rebuilds the runtime from the artifact and
    makes, at load, one static program per exported batch size: static
    input buffers, a warm-up on a side stream (kernel builds, driver
    lookups, Triton's JIT and every cached constant happen there, never
    inside a capture), one CUDA graph captured over the augmented ensemble,
    the argmax and the regressor product, and static outputs. `detect`
    copies the images and the random inputs in and replays the graph, so
    the card runs the whole detection without per-op host dispatch, as XLA
    runs the JAX program. The graphs share one memory pool: their replays
    never overlap. On the CPU (only with device="cpu") the same program
    calls its function eagerly on the same static buffers.

The artifact holds weights, not code: it loads with this package and no
other, on the GPU unless device="cpu" is given. A capture that fails
raises; there is no eager fallback on the card.

Artifact layout (a directory):
    unet.safetensors          the UNet's parameters (norms fp32)
    vae_encoder.safetensors   the VAE encoder's parameters
    embedding.npy / .pt       the learned context [1, T, d] fp32
    indices.npy / .pt         the selected token indices [k]
    regressor.npy / .pt       the stage-4 regressor [2k, 2K] (optional)
    manifest.json             shapes, outputs, files, versions, runtime

Signature of each exported batch size b:
    detect(images f32[b, S, S, 3] in [0, 1], seed) ->
        {"keypoints": f32[b, k, 2]}            normalized (y, x)
      + {"regressed": f32[b, K, 2]}            with a regressor (eval.py:453)

The random inputs (affine thetas, then latent noise) are drawn on the host
from `torch.Generator().manual_seed(seed)` in the order the runtime draws
them, so `detect(x, seed)` equals `Runtime.augmented_keypoints(...,
generator=torch.Generator().manual_seed(seed))`. A torch generator does not
reproduce `jax.random`, so `detect` also takes the thetas and the noise.
Inputs must match an exported batch size exactly; there is no padding.

CLI:
    python -m stablekeypoints_tpu_torch.serving --save_folder outputs \\
        --out outputs/serving --batch 1,4 [--with_regressor] [--check] [--device cpu]
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from stablekeypoints_tpu_torch.config import Config
from stablekeypoints_tpu_torch.models.unet import UNetConfig
from stablekeypoints_tpu_torch.models.vae import VAEConfig
from stablekeypoints_tpu_torch.models.weights import load_safetensors, save_safetensors
from stablekeypoints_tpu_torch.ops.transforms import sample_thetas
from stablekeypoints_tpu_torch.parallel.mesh import barrier
from stablekeypoints_tpu_torch.pipeline.runtime import Runtime, resolve_device
from stablekeypoints_tpu_torch.utils.artifacts import load_artifact, save_artifact

__all__ = ["FORMAT", "FORMAT_VERSION", "ServedDetector", "StaticProgram", "export_detector",
           "main"]

FORMAT = "stablekeypoints_tpu_torch"
FORMAT_VERSION = 1
_MANIFEST = "manifest.json"
_UNET, _VAE = "unet.safetensors", "vae_encoder.safetensors"
# the Config fields that the detect path reads
_DETECT_FIELDS = (
    "model_type", "image_size", "dtype", "noise_level", "feature_upsample_res", "layers",
    "capture_dtype", "pallas_capture", "flash_attention", "fused_groupnorm", "fused_gn_conv",
    "augment_degrees", "augment_scale", "augment_translate", "augmentation_iterations",
    "eval_views_per_pass", "eval_ensemble_res", "latent_warp", "max_loc_strategy",
)


def _host(x, dtype) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def _tuples(fields: dict) -> dict:
    """JSON lists back to the tuples the configuration dataclasses hold."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()}


def export_detector(
    runtime: Runtime,
    context,
    indices,
    out_dir: str,
    batch: "int | Sequence[int]" = 1,
    regressor=None,
) -> dict:
    """Write the detection path of `runtime` to `out_dir`; returns the
    manifest dict.

    context: [1, T, d] learned embedding (stage 1); indices: [k] selected
    token indices (stage 2); regressor: optional [2k, 2K] stage-4 linear
    map, with which the served detector also returns regressed keypoints
    (((x - 0.5) @ W) + 0.5, reference eval.py:453). `batch`: an int or a
    sequence of batch sizes, each served by its own static program."""
    batches = sorted(
        {int(b) for b in ((batch,) if isinstance(batch, (int, np.integer)) else batch)}
    )
    if not batches or any(b < 1 for b in batches):
        raise ValueError(f"batch sizes must be positive ints, got {batch!r}")
    if runtime.unet.axis is not None:
        raise ValueError("export_detector writes one whole UNet; a tensor-parallel rank holds "
                         "a slice of it: export from a runtime without a 'model' axis")
    cfg = runtime.cfg
    ctx = _host(context, np.float32)
    idx = _host(indices, np.int64)
    reg = None if regressor is None else _host(regressor, np.float32)
    if reg is not None and reg.shape[0] != 2 * idx.shape[0]:
        raise ValueError(
            f"regressor rows {reg.shape[0]} != 2 * top_k {2 * idx.shape[0]}"
        )

    # a data-parallel runtime exports from rank 0; the others wait and read
    if runtime.mesh.writer:
        os.makedirs(out_dir, exist_ok=True)
        save_safetensors(runtime.unet.state_dict(), os.path.join(out_dir, _UNET))
        save_safetensors({k: v for k, v in runtime.vae.state_dict().items()
                          if not k.startswith("decoder.")}, os.path.join(out_dir, _VAE))
        arrays = {"embedding": ctx, "indices": idx}
        if reg is not None:
            arrays["regressor"] = reg
        names = [_UNET, _VAE]
        for name, arr in arrays.items():
            save_artifact(out_dir, name, arr)
            names += [f"{name}.npy", f"{name}.pt"]

        manifest = {
            "format": FORMAT,
            "format_version": FORMAT_VERSION,
            "batches": batches,
            "files": {n: os.path.getsize(os.path.join(out_dir, n)) for n in names},
            "image_size": int(cfg.image_size),
            "top_k": int(idx.shape[0]),
            "num_regressed": None if reg is None else int(reg.shape[1] // 2),
            "outputs": ["keypoints"] + (["regressed"] if reg is not None else []),
            "platforms": ["cuda", "cpu"],
            "torch_version": torch.__version__,
            "model_type": cfg.model_type,
            "augmentation_iterations": int(cfg.augmentation_iterations),
            "max_loc_strategy": cfg.max_loc_strategy,
            "runtime": {
                "config": {f: getattr(cfg, f) for f in _DETECT_FIELDS},
                "unet": dataclasses.asdict(runtime.unet.config),
                "vae": dataclasses.asdict(runtime.vae.config),
            },
        }
        text = json.dumps(manifest, indent=1)
        with open(os.path.join(out_dir, _MANIFEST), "w") as f:
            f.write(text)
    barrier(runtime.mesh)
    with open(os.path.join(out_dir, _MANIFEST)) as f:
        return json.load(f)  # as written: tuples become lists


class StaticProgram:
    """One exported batch size: static input buffers, `fn` over them and
    its static outputs. On CUDA, `warm_up` then `capture` record `fn` as one
    CUDA graph, and `run` copies the inputs in and replays it. On the CPU
    `run` calls `fn` on the same buffers. One run at a time: the buffers
    are shared."""

    def __init__(self, fn, inputs: dict):
        self.fn, self.inputs = fn, inputs
        self._lock = threading.Lock()
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Optional[dict] = None
        self.warmup_s = self.capture_s = None

    @property
    def device(self) -> torch.device:
        return next(iter(self.inputs.values())).device

    def warm_up(self) -> None:
        """One eager call on a side stream: everything that runs once
        (kernel builds, the driver's entry points, Triton's JIT, cuDNN and
        cuBLAS plans, the cached constants) happens here."""
        t0 = time.perf_counter()
        main_stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main_stream)
        with torch.cuda.stream(side):
            self.fn(**self.inputs)
        main_stream.wait_stream(side)
        torch.cuda.synchronize(self.device)
        self.warmup_s = time.perf_counter() - t0

    def capture(self, pool) -> None:
        """Record `fn` as a CUDA graph in the memory pool `pool`."""
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool):
            self.outputs = self.fn(**self.inputs)
        torch.cuda.synchronize(self.device)
        self.graph = graph
        self.capture_s = time.perf_counter() - t0

    def run(self, **values: torch.Tensor) -> dict:
        """Copy `values` into the static inputs, run, and return host
        copies of the outputs (a later run cannot change them)."""
        for name, value in values.items():
            if tuple(value.shape) != tuple(self.inputs[name].shape):
                raise ValueError(f"{name}: shape {tuple(value.shape)}, the program takes "
                                 f"{tuple(self.inputs[name].shape)}")
        with self._lock:
            for name, value in values.items():
                self.inputs[name].copy_(value)
            if self.graph is not None:
                self.graph.replay()
            else:
                self.outputs = self.fn(**self.inputs)
            return {k: v.to("cpu", copy=True).numpy() for k, v in self.outputs.items()}


class ServedDetector:
    """An exported detector: the runtime rebuilt from the artifact and one
    static program per exported batch size (a CUDA graph on the card)."""

    def __init__(self, runtime: Runtime, context: torch.Tensor, indices: torch.Tensor,
                 regressor: Optional[torch.Tensor], manifest: dict):
        self.runtime, self.context, self.indices = runtime, context, indices
        self.regressor, self.manifest = regressor, manifest
        rt, size = runtime, manifest["image_size"]
        n, device = rt.cfg.augmentation_iterations, rt.device
        if rt.cfg.latent_warp:
            rt.black_latent  # encoded once, before any capture
        pool = torch.cuda.graph_pool_handle() if device.type == "cuda" else None
        self.programs: dict[int, StaticProgram] = {}
        for b in manifest["batches"]:
            thetas = torch.zeros((b * n, 2, 3), dtype=torch.float32, device=device)
            thetas[:, 0, 0] = thetas[:, 1, 1] = 1.0  # the warm-up's views: the identity
            program = StaticProgram(self._forward, {
                "images": torch.zeros((b, size, size, 3), dtype=torch.float32, device=device),
                "thetas": thetas,
                "noise": torch.zeros(rt.latent_shape(b * n, size), dtype=torch.float32,
                                     device=device),
            })
            if device.type == "cuda":
                program.warm_up()
                program.capture(pool)
            self.programs[b] = program

    def _forward(self, images, thetas, noise) -> dict:
        with torch.inference_mode():
            pts = self.runtime._ensembled_keypoints(self.context, images, self.indices,
                                                    thetas=thetas, noise=noise)
            out = {"keypoints": pts}
            if self.regressor is not None:
                flat = pts.reshape(pts.shape[0], -1) - 0.5
                out["regressed"] = (flat @ self.regressor + 0.5).reshape(pts.shape[0], -1, 2)
        return out

    @staticmethod
    def load(out_dir: str, device=None) -> "ServedDetector":
        """Rebuild the detector of `out_dir` on `device` (default: the GPU;
        raises without one unless device="cpu") and make its programs."""
        device = resolve_device(device)
        with open(os.path.join(out_dir, _MANIFEST)) as f:
            manifest = json.load(f)
        if manifest.get("format") != FORMAT or manifest.get("format_version") != FORMAT_VERSION:
            raise ValueError(
                f"{out_dir} is not a {FORMAT} serving artifact of format version "
                f"{FORMAT_VERSION} (format {manifest.get('format')!r}, version "
                f"{manifest.get('format_version')!r}); a JAX artifact of .stablehlo blobs "
                f"loads with the JAX package"
            )
        spec = manifest["runtime"]
        rt = Runtime.empty(Config(**_tuples(spec["config"])), UNetConfig(**_tuples(spec["unet"])),
                           VAEConfig(**_tuples(spec["vae"])), device, decoder=False)
        rt.load_weights(load_safetensors(os.path.join(out_dir, _UNET)),
                        load_safetensors(os.path.join(out_dir, _VAE)))

        def array(name, dtype):
            return torch.from_numpy(load_artifact(out_dir, name).astype(dtype)).to(device)

        regressor = array("regressor", np.float32) if "regressed" in manifest["outputs"] else None
        return ServedDetector(rt, array("embedding", np.float32), array("indices", np.int64),
                              regressor, manifest)

    def detect(self, images: np.ndarray, seed: int = 0, thetas=None, noise=None) -> dict:
        """images [b, S, S, 3] float in [0, 1] -> {"keypoints": [b, k, 2]}
        (+ "regressed" [b, K, 2]) numpy arrays. b must be an exported batch
        size. thetas [b*n, 2, 3] and noise [b*n, S/8, S/8, 4] (n views an
        image, image-major) are drawn from `seed` when not given."""
        size = self.manifest["image_size"]
        images = np.asarray(images, np.float32)
        if (images.ndim != 4 or images.shape[1:] != (size, size, 3)
                or images.shape[0] not in self.programs):
            raise ValueError(
                f"exported for images of shape [b, {size}, {size}, 3] with "
                f"b in {sorted(self.programs)}, got {images.shape}"
            )
        rt = self.runtime
        v = images.shape[0] * rt.cfg.augmentation_iterations
        gen = torch.Generator().manual_seed(int(seed))
        if thetas is None:
            thetas = sample_thetas(gen, v, rt.aff)
        if noise is None:
            noise = torch.randn(rt.latent_shape(v, size), generator=gen, dtype=torch.float32)
        return self.programs[images.shape[0]].run(
            images=torch.from_numpy(images), thetas=torch.as_tensor(thetas),
            noise=torch.as_tensor(noise))


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--save_folder", required=True,
                   help="stage artifacts (embedding/indices[/regressor])")
    p.add_argument("--out", required=True, help="output artifact directory")
    p.add_argument("--batch", default="1",
                   help="batch size(s) to export, comma-separated (e.g. 1,4,8); one "
                        "static program (a CUDA graph) per size, dispatched at serve time")
    p.add_argument("--platforms", default="",
                   help="has no meaning here and must stay empty: the artifact holds "
                        "weights, not lowered programs, and loads on the GPU or the CPU")
    p.add_argument("--with_regressor", action="store_true",
                   help="export the stage-4 regressor (emits 'regressed')")
    p.add_argument("--check", action="store_true",
                   help="load the artifact and compare it with the live runtime on "
                        "random inputs")
    p.add_argument("--model_path", default="")
    p.add_argument("--model_type", default=Config.model_type)
    p.add_argument("--image_size", type=int, default=Config.image_size)
    p.add_argument("--augmentation_iterations", type=int,
                   default=Config.augmentation_iterations)
    p.add_argument("--device", default=None,
                   help="torch device; default the GPU (raises without one), 'cpu' for "
                        "the plain kernel versions")
    a = p.parse_args(argv)
    if a.platforms:
        p.error("--platforms has no meaning in the port: the artifact holds weights and "
                "loads on the GPU, or on the CPU with --device cpu")

    cfg = Config(
        model_path=a.model_path or None, model_type=a.model_type,
        image_size=a.image_size, augmentation_iterations=a.augmentation_iterations,
    )
    rt = Runtime.create(cfg, device=a.device)
    context = load_artifact(a.save_folder, "embedding")
    indices = load_artifact(a.save_folder, "indices").astype(np.int64)
    regressor = load_artifact(a.save_folder, "regressor") if a.with_regressor else None
    manifest = export_detector(rt, context, indices, a.out,
                               batch=[int(s) for s in str(a.batch).split(",") if s],
                               regressor=regressor)
    print(json.dumps(manifest))

    if a.check:
        det = ServedDetector.load(a.out, device=a.device)
        rng = np.random.default_rng(0)
        for b in manifest["batches"]:
            imgs = rng.uniform(0, 1, (b, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
            served = det.detect(imgs, seed=3)["keypoints"]
            live = rt.augmented_keypoints(context, imgs, indices,
                                          generator=torch.Generator().manual_seed(3))
            diff = float(np.abs(served - live.cpu().numpy()).max())
            print(json.dumps({"batch": b, "check_max_abs_diff": diff}))
            if not diff < 1e-4:
                return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
