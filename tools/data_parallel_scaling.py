#!/usr/bin/env python3
"""Data parallel over N GPUs (`parallel/mesh.py`): one process a GPU, NCCL.

    python3 -m torch.distributed.run --standalone --nproc_per_node N tools/data_parallel_scaling.py
    # the same over gloo on the CPU with the tiny models (a rehearsal):
    python3 -m torch.distributed.run --standalone --nproc_per_node 4 \\
        tools/data_parallel_scaling.py --device cpu

Every rank runs the SD-1.5 512^2 training step (full width, random weights
from the seed, bf16) on its 4 rows of a global batch of 4N, so each GPU does
chip_smoke's `[train]` batch-4 step (weak scaling):
- one cached step from one state with given thetas and noise: its averaged
  context gradient against the mean of the N batch-4 quarters' gradients,
  which rank 0 computes alone on its GPU without the mesh (within 5e-2 of
  max, cosine >= 0.999: the tolerance chip_smoke holds a replay to, for the
  kernels' dq sums land in no fixed order), and the context after it;
- `all_reduce` calls in an eager step (one), the NCCL kernels in a replayed
  `steps_per_call` group (one a step, inside the CUDA graph);
- eager cached s/step (host clock around synchronised steps, in turns with
  the grouped ones) and grouped s/step; images/s = 4N / (s/step); peak
  device memory per rank.
Rank 0 prints one JSON line last and writes it to --out; every rank notes
its progress on stderr. One host: NCCL's bootstrap is kept on the loopback
interface (NCCL_SOCKET_IFNAME=lo unless set). Imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
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
    barrier,
    destroy_group,
    gather_rows,
    init_from_launch,
    make_mesh,
)
from stablekeypoints_tpu_torch.pipeline.runtime import Runtime  # noqa: E402

PER_RANK = 4  # images a rank a step: [train]'s batch


def nccl_kernels(fn) -> dict:
    """{kernel name: launches} of the NCCL kernels that one call of `fn` runs."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    found = {}
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA and not e.key.startswith("nccl:")
                and any(m in e.key.lower() for m in ("nccl", "onerank"))):
            found[e.key] = found.get(e.key, 0) + e.count
    return found


def say(msg: str) -> None:
    rank = os.environ.get("RANK", "0")
    print(f"[rank {rank} {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu: gloo and the tiny models (default: cuda:LOCAL_RANK, NCCL)")
    ap.add_argument("--k", type=int, default=4, help="steps a group (steps_per_call)")
    ap.add_argument("--turns", type=int, default=3, help="timed turns of eager and grouped steps")
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out", "data_parallel"))
    args = ap.parse_args()
    if args.device is None and not torch.cuda.is_available():
        print("data_parallel_scaling: no CUDA device (pass --device cpu)", file=sys.stderr)
        return 2
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    joined = init_from_launch(args.device)
    say(f"joined the group ({dist.get_backend()}, world {dist.get_world_size()})")
    try:
        return run(args)
    finally:
        if joined:
            destroy_group()
            say("left the group")


def run(args) -> int:
    mesh = make_mesh(-1, device=args.device)
    cuda = mesh.device.type == "cuda"
    n = mesh.world
    if cuda:
        cfg, models = Config(batch_size=PER_RANK * n), ()
    else:
        from stablekeypoints_tpu_torch.models.unet import tiny_unet_config
        from stablekeypoints_tpu_torch.models.vae import tiny_vae_config

        cfg = Config(batch_size=PER_RANK * n, image_size=64, num_tokens=16,
                     feature_upsample_res=16, top_k=4, furthest_point_num_samples=8,
                     dtype="float32")
        models = (tiny_unet_config(), tiny_vae_config())

    def sync():
        if cuda:
            torch.cuda.synchronize()

    t0 = time.time()
    rt = Runtime.create(cfg, *models, mesh=mesh)
    sync()
    create_s = time.time() - t0
    say(f"runtime on {mesh.device} in {create_s:.1f} s")
    b = cfg.batch_size
    data = SyntheticBlobs(length=2 * b, image_size=cfg.image_size)
    batches = [np.stack([data[i]["img"] for i in range(o, o + b)]) for o in (0, b)]
    ctx0 = rt.init_context()
    say("init_context broadcast")

    def fresh():
        c = rt.train_context(ctx0)
        return c, rt.optimizer(c), torch.Generator(device=mesh.device).manual_seed(5)

    # fill steps: the rank's latents of both batches
    ctx, opt, gen = fresh()
    lats = [rt.train_step_fill(ctx, opt, x, generator=gen)[3] for x in batches]
    sync()
    say("two fill steps")

    # one step from one state, against rank 0's N quarters without the mesh
    host = torch.Generator().manual_seed(7)
    thetas = sample_thetas(host, b, rt.aff)
    noise = torch.randn((2 * b, *rt.latent_shape(1, cfg.image_size)[1:]), generator=host)
    calls = []
    all_reduce = dist.all_reduce
    dist.all_reduce = lambda *a, **kw: calls.append(1) or all_reduce(*a, **kw)
    try:
        c, o, _ = fresh()
        rt.train_step_cached(c, o, lats[0], batches[0], thetas=thetas, noise=noise)
    finally:
        dist.all_reduce = all_reduce
    grad, context = c.grad.clone(), c.detach().clone()
    latents = gather_rows(mesh, lats[0], b)
    check = None
    if mesh.writer:
        local = Runtime(dataclasses.replace(cfg, batch_size=PER_RANK), rt.unet, rt.vae,
                        rt.schedule, rt.device)
        grads = []
        for q in range(n):
            rows = slice(q * PER_RANK, (q + 1) * PER_RANK)
            cq = local.train_context(ctx0)
            oq = local.optimizer(cq)
            local.train_step_cached(
                cq, oq, latents[rows], batches[0][rows], thetas=thetas[rows],
                noise=torch.cat([noise[rows], noise[b + rows.start:b + rows.stop]]))
            grads.append(cq.grad)
        want = torch.stack(grads).mean(dim=0)
        rel = ((grad - want).abs().max() / want.abs().max()).item()
        cos = torch.nn.functional.cosine_similarity(grad.flatten(), want.flatten(), dim=0).item()
        check = dict(grad_rel=rel, grad_cos=cos, ok=rel <= 5e-2 and cos >= 0.999)
    barrier(mesh)
    say("one step from one state, checked on rank 0")

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

    grouped()  # on CUDA: the warm-up step and the capture
    sync()
    say("a group: warm-up and capture")
    eager()
    sync()
    secs = {"eager": [], "grouped": []}
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for _ in range(args.turns):
        for name, fn in (("grouped", grouped), ("eager", eager)):
            barrier(mesh)
            sync()
            t1 = time.perf_counter()
            fn()
            sync()
            secs[name].append((time.perf_counter() - t1) / k)
    say("timed turns")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30 if cuda else None
    kernels = None  # rank 0 profiles a group; every rank runs it (the all-reduce)
    if cuda and mesh.writer:
        kernels = nccl_kernels(grouped)
    elif cuda:
        grouped()
        sync()
    if not mesh.writer:
        return 0
    s_g, s_e = (float(np.median(secs[name])) for name in ("grouped", "eager"))
    out = dict(
        world=n, device=str(mesh.device), backend=dist.get_backend() if dist.is_initialized()
        else None, card=torch.cuda.get_device_name(0) if cuda else "cpu", global_batch=b,
        create_s=create_s, all_reduce_calls_a_step=len(calls), grad_check=check,
        context_norm=context.norm().item(), secs=secs, s_per_step_grouped=s_g,
        s_per_step_eager=s_e, images_per_s_grouped=b / s_g, images_per_s_eager=b / s_e,
        peak_gib_per_rank=peak_gib, nccl_kernels_in_a_group=kernels, k=k)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"world{n}.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    ok = (len(calls) == 1 and check["ok"]
          and (kernels is None or sum(kernels.values()) == k))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
