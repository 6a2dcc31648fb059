#!/usr/bin/env python3
"""Tensor parallel over GPUs (`parallel/tensor.py`): one process a GPU, NCCL,
the mesh (n_data, n_model).

    python3 -m torch.distributed.run --standalone --nproc_per_node N \\
        tools/tensor_parallel_scaling.py --n_model M        # N = n_data * M
    # the same over gloo on the CPU with the tiny models (a rehearsal):
    python3 -m torch.distributed.run --standalone --nproc_per_node 4 \\
        tools/tensor_parallel_scaling.py --n_model 2 --device cpu

Every rank runs the SDXL 1024^2 cached training step (full width, random
weights from the seed, bf16), batch 1 a data coordinate (a global batch of
n_data), with its model group's Megatron slice of the UNet (at n_model 4
SDXL's 10-head stacks stay whole on every rank):
- one cached step from one state with given thetas and noise: its loss and
  context gradient beside the n_data batch-1 steps that rank 0 runs alone
  on its GPU with the whole UNet (reported: in bf16 a map that rounds
  otherwise can turn a token of the step's selection, and that token's
  gradient row moves with it); and, held, the context gradient of
  chip_smoke's fixed loss (the whole UNet's selection and targets on the
  same draws) within 5e-2 of max, cosine >= 0.99, against rank 0's whole
  UNet;
- in an eager step: the all_reduce calls and their bytes over the world
  (the context gradient and its aux) and over the model group (the split
  blocks' activations and their gradients);
- eager cached s/step (host clock around synchronised steps, in turns with
  the grouped ones) and grouped s/step (`steps_per_call` K: one CUDA graph
  of the step with its NCCL all-reduces inside, replayed); peak device
  memory and UNet parameter bytes per rank.
Rank 0 prints one JSON line last, with the card's name and power limit
(nvidia-smi), and writes it to --out; every rank notes its progress on
stderr. One host: NCCL's bootstrap is kept on the loopback interface
(NCCL_SOCKET_IFNAME=lo unless set). Imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from stablekeypoints_tpu_torch.config import Config  # noqa: E402
from stablekeypoints_tpu_torch.data.synthetic import SyntheticBlobs  # noqa: E402
from stablekeypoints_tpu_torch.ops.transforms import sample_thetas  # noqa: E402
from stablekeypoints_tpu_torch.parallel.mesh import (  # noqa: E402
    Mesh,
    barrier,
    destroy_group,
    gather_rows,
    init_from_launch,
    make_mesh,
)
from stablekeypoints_tpu_torch.pipeline.runtime import Runtime  # noqa: E402

import chip_smoke  # noqa: E402  (the fixed loss of its gradient checks)

SDXL = "stabilityai/stable-diffusion-xl-base-1.0"


def say(msg: str) -> None:
    rank = os.environ.get("RANK", "0")
    print(f"[rank {rank} {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


class Collectives:
    """all_reduce calls and bytes by group ("world" or "model")."""

    def __init__(self, mesh):
        self.mesh, self.calls, self.bytes = mesh, {}, {}

    def __enter__(self):
        self._fn = dist.all_reduce

        def counted(t, *a, **k):
            g = k.get("group")
            key = "model" if g is not None and g is self.mesh.model_group else "world"
            self.calls[key] = self.calls.get(key, 0) + 1
            self.bytes[key] = self.bytes.get(key, 0) + t.numel() * t.element_size()
            return self._fn(t, *a, **k)

        dist.all_reduce = counted
        return self

    def __exit__(self, *exc):
        dist.all_reduce = self._fn


def rel(got, want) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


def cos(got, want) -> float:
    return torch.nn.functional.cosine_similarity(got.flatten(), want.flatten(), dim=0).item()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n_model", type=int, default=2, help="model ranks a data coordinate")
    ap.add_argument("--device", default=None,
                    help="cpu: gloo and the tiny models (default: cuda:LOCAL_RANK, NCCL)")
    ap.add_argument("--k", type=int, default=2, help="steps a group (steps_per_call)")
    ap.add_argument("--turns", type=int, default=3, help="timed turns of eager and grouped steps")
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out", "tensor_parallel"))
    args = ap.parse_args()
    if args.device is None and not torch.cuda.is_available():
        print("tensor_parallel_scaling: no CUDA device (pass --device cpu)", file=sys.stderr)
        return 2
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    joined = init_from_launch(args.device)
    say(f"joined the group ({dist.get_backend() if joined else 'none'})")
    try:
        return run(args)
    finally:
        if joined:
            destroy_group()
            say("left the group")


def run(args) -> int:
    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh = make_mesh(-1, args.n_model, device=args.device)
    cuda = mesh.device.type == "cuda"
    nd, nm = mesh.n_data, mesh.n_model
    if cuda:
        cfg, models = Config(model_type=SDXL, image_size=1024, batch_size=nd), ()
    else:
        from stablekeypoints_tpu_torch.models.unet import sdxl_tiny_config
        from stablekeypoints_tpu_torch.models.vae import tiny_vae_config

        cfg = Config(model_type=SDXL, batch_size=nd, image_size=64, num_tokens=16,
                     feature_upsample_res=16, top_k=4, furthest_point_num_samples=8,
                     dtype="float32")
        models = (sdxl_tiny_config(), tiny_vae_config())

    def sync():
        if cuda:
            torch.cuda.synchronize()

    t0 = time.time()
    rt = Runtime.create(cfg, *models, mesh=mesh)
    sync()
    create_s = time.time() - t0
    unet_bytes = sum(p.numel() * p.element_size() for p in rt.unet.parameters())
    say(f"({nd}, {nm}) runtime on {mesh.device} in {create_s:.1f} s, UNet "
        f"{unet_bytes / 2**30:.2f} GiB")
    b = cfg.batch_size
    data = SyntheticBlobs(length=2 * b, image_size=cfg.image_size)
    batches = [np.stack([data[i]["img"] for i in range(o, o + b)]) for o in (0, b)]
    ctx0 = rt.init_context()

    def fresh():
        c = rt.train_context(ctx0)
        return c, rt.optimizer(c), torch.Generator(device=mesh.device).manual_seed(5)

    ctx, opt, gen = fresh()
    lats = [rt.train_step_fill(ctx, opt, x, generator=gen)[3] for x in batches]
    sync()
    say("two fill steps")

    # one step from one state, counted, beside rank 0's whole-UNet steps
    host = torch.Generator().manual_seed(7)
    thetas = sample_thetas(host, b, rt.aff)
    noise = torch.randn((2 * b, *rt.latent_shape(1, cfg.image_size)[1:]), generator=host)
    c, o, _ = fresh()
    with Collectives(mesh) as coll:
        step_aux = rt.train_step_cached(c, o, lats[0], batches[0], thetas=thetas, noise=noise)[2]
    grad = c.grad.clone()
    latents = gather_rows(mesh, lats[0], b)
    check, chosen = None, [None]
    if mesh.writer and world > 1:
        whole = Runtime.create(dataclasses.replace(cfg, batch_size=1), *models,
                               mesh=Mesh(0, 1, None, mesh.device))
        grads, losses = [], []
        for q in range(b):
            cq = whole.train_context(ctx0)
            aux = whole.train_step_cached(
                cq, whole.optimizer(cq), latents[q:q + 1], batches[0][q:q + 1],
                thetas=thetas[q:q + 1], noise=torch.cat([noise[q:q + 1], noise[b + q:b + q + 1]]))[2]
            grads.append(cq.grad)
            losses.append(float(aux["loss"]))
        want = torch.stack(grads).mean(dim=0)
        images = torch.from_numpy(batches[0])
        with torch.no_grad():
            maps = chip_smoke.step_maps(torch, whole, images, thetas, noise, ctx0)
        chosen = [chip_smoke.chosen_tokens(torch, whole, maps, b)]
        del maps
        fixed_want = chip_smoke.fixed_loss_grad(torch, whole, images, thetas, noise, ctx0,
                                                chosen[0])
        check = dict(step_grad_rel=rel(grad, want), step_grad_cos=cos(grad, want),
                     step_loss=float(step_aux["loss"]), step_loss_whole=float(np.mean(losses)))
        del whole, grads
        if cuda:
            torch.cuda.empty_cache()
    if world > 1:  # every rank: the fixed loss through the split UNet
        dist.broadcast_object_list(chosen, src=0)
        g, value = chip_smoke.fixed_loss_grad(torch, rt, torch.from_numpy(batches[0]), thetas,
                                              noise, ctx0, chosen[0])
        if mesh.writer:
            g_want, v_want = fixed_want
            check.update(fixed_grad_rel=rel(g, g_want), fixed_grad_cos=cos(g, g_want),
                         fixed_loss_rel=abs(value - v_want) / abs(v_want))
            check["ok"] = check["fixed_grad_rel"] <= 5e-2 and check["fixed_grad_cos"] >= 0.99
    barrier(mesh)
    say(f"one step from one state: all_reduce calls {coll.calls}, bytes {coll.bytes}")

    # eager and grouped cached steps in turns
    ce, oe, ge = fresh()
    cg, og, gg = fresh()
    k = args.k
    lat_k = torch.stack([lats[j % 2] for j in range(k)])
    img_k = np.stack([batches[j % 2] for j in range(k)])

    def eager():
        for j in range(k):
            rt.train_step_cached(ce, oe, lat_k[j], img_k[j], generator=ge)

    def grouped():
        rt.train_step_scan(cg, og, lat_k, img_k, generator=gg)

    if cuda:
        grouped()  # the warm-up step and the capture
        sync()
        say("a group: warm-up and capture")
    eager()
    sync()
    secs = {"eager": [], "grouped": []} if cuda else {"eager": []}
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for _ in range(args.turns):
        for name in secs:
            barrier(mesh)
            sync()
            t1 = time.perf_counter()
            (grouped if name == "grouped" else eager)()
            sync()
            secs[name].append((time.perf_counter() - t1) / k)
    say("timed turns")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30 if cuda else None
    peaks = [torch.zeros(1, device=mesh.device) for _ in range(world)]
    if world > 1:
        dist.all_gather(peaks, torch.tensor([peak_gib or 0.0], device=mesh.device))
    if not mesh.writer:
        return 0
    med = {name: float(np.median(v)) for name, v in secs.items()}
    out = dict(
        n_data=nd, n_model=nm, world=world, device=str(mesh.device),
        backend=dist.get_backend() if dist.is_initialized() else None,
        card=card_line() if cuda else "cpu", global_batch=b, create_s=create_s,
        unet_gib_per_rank=unet_bytes / 2**30, all_reduce_calls_a_step=coll.calls,
        all_reduce_bytes_a_step=coll.bytes, grad_check=check, secs=secs,
        s_per_step={n: v for n, v in med.items()},
        images_per_s={n: b / v for n, v in med.items()},
        peak_gib_per_rank=[p.item() for p in peaks] if world > 1 else [peak_gib], k=k)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"mesh{nd}x{nm}.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    want_world = 0 if mesh.group is None else 1
    ok = coll.calls.get("world", 0) == want_world and (check is None or check["ok"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
