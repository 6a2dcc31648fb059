"""Data parallel in the port (`parallel/mesh.py`), on the CPU over gloo.

One pair of processes for the whole module (a module fixture spawns them:
starting processes costs seconds) runs every case at world 2, each rank
on its half of the batch; this process runs the same cases at world 1
(no process group), from the same weights, inputs and generator seeds.
The tiny UNet/VAE at 64^2 in fp32, global batch 4.

- Fill, cached and grouped (train_step_scan, K=2) steps: the context after
  the step within rtol 1e-5 / atol 1e-6 and aux within rtol 1e-5 (the two
  halves' means averaged against one mean of four), the context gradient
  within 1e-4 of its largest magnitude (train_slice's gradient tolerance:
  a batch of 2 goes through other CPU conv and matmul kernels than a batch
  of 4, so the rounding differs all through the network, measured ~5e-5),
  and each generator left in the world-1 run's state.
- Exactly one all_reduce per training step and no gather, broadcast or
  other collective (counted by wrapping torch.distributed's functions).
- The vote (select_indices, find_best_indices) and the stage-3 ensemble
  (augmented_keypoints on 4, 3 and 1 images, ensemble_chunks over 7 images
  in chunks of 4): equal at world 1 and world 2. A batch the world does not
  divide raises for a training step and a vote batch, as the JAX package's
  device_put on its 2-device mesh does, and an ensemble takes it (the JAX
  package shards its views inside the program).
- A checkpoint written by rank 0 at world 2, resumed at world 2: the
  contexts of the whole run (4 steps) and of the resumed one equal world
  1's, 99% of their elements within rtol 1e-5 / atol 1e-6 and all within a
  tenth of lr: Adam moves an element by about lr a step whatever the size
  of its gradient, so an element whose gradient is near 0 turns the
  gradient's rounding (above) into a larger move (measured: 1 of 512
  elements 1.7e-4 off after 4 steps, lr 5e-3).
- The CLI (`main.run`, stages 1-2 on a folder of JPEGs decoded by the
  native decoder, `--native_io on`, `--data_parallel 2`) and the serving
  export: rank 0 alone writes the artifacts and the log, which equal
  world 1's.
- `data_parallel` validation; `remat_for` per rank against the JAX
  Runtime's decision on a 2-device mesh.
- Parity with the JAX package: the JAX Runtime's step on a 2-device CPU
  mesh (thetas and noise recomputed from its key and given to the port)
  against the port's world-2 step, at tests/test_torch_train_slice.py's
  tolerances (aux rtol 1e-5, gradient 1e-4 of its largest magnitude).
"""

import torch_threads  # noqa: F401  (torch's threads: this xdist worker's share)
import dataclasses
import datetime
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from stablekeypoints_tpu_torch import main as cli
from stablekeypoints_tpu_torch.config import Config
from stablekeypoints_tpu_torch.data import base
from stablekeypoints_tpu_torch.data.synthetic import SyntheticBlobs
from stablekeypoints_tpu_torch.models.unet import sd21_tiny_config, tiny_unet_config
from stablekeypoints_tpu_torch.models.vae import tiny_vae_config
from stablekeypoints_tpu_torch.parallel import mesh as pmesh
from stablekeypoints_tpu_torch.pipeline.ensemble_loop import ensemble_chunks
from stablekeypoints_tpu_torch.pipeline.indices import find_best_indices
from stablekeypoints_tpu_torch.pipeline.optimize import optimize_embedding
from stablekeypoints_tpu_torch.pipeline.runtime import Runtime, remat_for
from stablekeypoints_tpu_torch.utils.checkpoint import TrainCheckpointer

WORLD = 2
SIZE = dict(image_size=64, num_tokens=16, feature_upsample_res=16, top_k=4,
            furthest_point_num_samples=8, batch_size=4, augmentation_iterations=2,
            num_indices=6, dtype="float32")
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "broadcast",
               "reduce_scatter", "reduce_scatter_tensor", "all_to_all", "gather", "scatter",
               "reduce", "barrier")
STEPS = ("fill", "cached", "scan")


class _Counted:
    """Wraps torch.distributed's collectives; counts their calls."""

    def __init__(self):
        self.counts = {}
        self._orig = {}

    def __enter__(self):
        for name in COLLECTIVES:
            fn = self._orig[name] = getattr(dist, name)

            def counted(*a, _fn=fn, _name=name, **k):
                self.counts[_name] = self.counts.get(_name, 0) + 1
                return _fn(*a, **k)

            setattr(dist, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(dist, name, fn)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _cases(mesh, inp, folder):
    """Every case on this rank; returns the results (tensors and ints)."""
    cfg = Config(**SIZE)
    rt = Runtime.create(cfg, tiny_unet_config(), tiny_vae_config(), mesh=mesh)
    rt.load_weights(*inp["weights"])
    images, ctx0 = inp["images"], inp["ctx"]
    out = {"collectives": {}}

    def counted(name, fn):
        with _Counted() as c:
            result = fn()
        out["collectives"][name] = c.counts
        return result

    def fresh(ctx=ctx0):
        context = rt.train_context(ctx)
        return context, rt.optimizer(context)

    # training steps (each from ctx0 and a fresh Adam state)
    ctx, opt = fresh()
    gen = _gen(5)
    _, _, aux, lat = counted("fill", lambda: rt.train_step_fill(ctx, opt, images, generator=gen))
    out["fill"] = (aux, ctx.grad.clone(), ctx.detach().clone(), gen.get_state())
    out["latents"] = pmesh.gather_rows(mesh, lat, images.shape[0])
    ctx, opt = fresh()
    gen = _gen(6)
    _, _, aux = counted("cached", lambda: rt.train_step_cached(ctx, opt, lat, images,
                                                               generator=gen))
    out["cached"] = (aux, ctx.grad.clone(), ctx.detach().clone(), gen.get_state())
    ctx, opt = fresh()
    gen = _gen(7)
    flipped = images.flip(0)
    lat_k = pmesh.stacked_shard_batch(mesh, torch.stack([out["latents"], out["latents"].flip(0)]))
    _, _, aux = counted("scan", lambda: rt.train_step_scan(
        ctx, opt, lat_k, torch.stack([images, flipped]), generator=gen))
    out["scan"] = (aux, ctx.grad.clone(), ctx.detach().clone(), gen.get_state())

    # a batch the world does not divide
    out["odd_raises"] = []
    for fn in (lambda: rt.train_step(*fresh(), images[:3], generator=_gen(0)),
               lambda: rt.select_indices(ctx0, images[:3], generator=_gen(0))):
        try:
            fn()
            out["odd_raises"].append(False)
        except ValueError:
            out["odd_raises"].append(True)

    # the vote and the ensemble
    idx = torch.arange(cfg.top_k)
    data = SyntheticBlobs(length=7, image_size=cfg.image_size)
    out["select"] = rt.select_indices(ctx0, images, generator=_gen(8))
    out["best"] = torch.as_tensor(find_best_indices(rt, data, ctx0, generator=_gen(9)))
    for m in (4, 3, 1):
        out[f"keypoints{m}"] = rt.augmented_keypoints(ctx0, images[:m], idx, generator=_gen(10))
    out["chunks"] = [torch.as_tensor(pts) for _, pts in
                     ensemble_chunks(rt, data, np.arange(7), ctx0, idx, _gen(11), 4)]

    # a checkpointed run, then a run resumed from its step-2 checkpoint
    ck_cfg = dataclasses.replace(cfg, num_steps=4, checkpoint_every=2, steps_per_call=1,
                                 save_folder=folder)
    ck_rt = Runtime(ck_cfg, rt.unet, rt.vae, rt.schedule, rt.device, mesh)
    ck = TrainCheckpointer(folder)
    out["run"] = optimize_embedding(ck_rt, data, context=ctx0, checkpointer=ck)
    out["resumed"] = optimize_embedding(ck_rt, data, context=ctx0, checkpointer=ck)

    # the CLI, stages 1-2 (the custom dataset has no annotations)
    argv = ["--dataset_name", "custom", "--dataset_loc", inp["jpegs"], "--save_folder",
            folder + "_cli", "--image_size", "64", "--num_tokens", "16",
            "--feature_upsample_res", "16", "--batch_size", "4", "--num_steps", "2",
            "--num_indices", "4", "--furthest_point_num_samples", "8", "--top_k", "4",
            "--dtype", "float32", "--native_io", "on", "--data_parallel", str(mesh.world),
            "--device", "cpu"]
    try:
        found = cli.run(cli.config_from_args(cli.build_parser().parse_args(argv)),
                        tiny_unet_config(), tiny_vae_config(), device="cpu")
    finally:
        base.set_native_io("auto")
    out["cli"] = {k: torch.as_tensor(np.asarray(v)) for k, v in found.items()}
    out["cli_folder"] = folder + "_cli"

    # the serving export of a data-parallel runtime: written by rank 0
    from stablekeypoints_tpu_torch.serving import export_detector

    out["export"] = export_detector(rt, ctx0, idx, folder + "_export", batch=1)

    # the step held to the JAX package's (its thetas and noise given)
    ctx, opt = fresh(inp["jax_ctx"])
    _, _, aux = rt.train_step(ctx, opt, inp["jax_images"], **inp["jax_random"])
    out["jax_step"] = (aux, ctx.grad.clone())

    # mesh validation inside a running group
    out["mesh_errors"] = []
    for kw in (dict(n_data=WORLD + 1, device="cpu"), dict(n_data=WORLD)):
        try:
            pmesh.make_mesh(**kw)
            out["mesh_errors"].append("")
        except (ValueError, RuntimeError) as e:
            out["mesh_errors"].append(type(e).__name__)
    return out


def _rank(rank, folder):
    torch.set_num_threads(torch_threads.share(WORLD))
    dist.init_process_group("gloo", init_method=f"file://{folder}/rendezvous", rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=300))
    try:
        inp = torch.load(os.path.join(folder, "inputs.pt"), weights_only=False)
        mesh = pmesh.make_mesh(WORLD, device="cpu")
        assert (mesh.rank, mesh.world) == (rank, WORLD)
        out = _cases(mesh, inp, os.path.join(folder, "world2"))
        torch.save(out, os.path.join(folder, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _jax_side(images, ctx):
    """The JAX Runtime on a 2-device CPU mesh: its weights, and one
    `_train_step` (the gradient kept by a zero-update transformation) with
    the thetas and noise it draws from its key."""
    import jax
    import jax.numpy as jnp
    import optax

    from stablekeypoints_tpu.config import Config as JaxConfig
    from stablekeypoints_tpu.models.unet import tiny_unet_config as jax_tiny_unet
    from stablekeypoints_tpu.models.vae import tiny_vae_config as jax_tiny_vae
    from stablekeypoints_tpu.ops.transforms import AffineParams, sample_thetas
    from stablekeypoints_tpu.parallel import mesh as jmesh
    from stablekeypoints_tpu.pipeline.runtime import Runtime as JaxRuntime
    from stablekeypoints_tpu_torch.models.weights import from_jax_params

    mesh = jmesh.make_mesh(2, 1, devices=jax.devices("cpu")[:2])
    kw = {k: v for k, v in SIZE.items() if k != "num_indices"}
    jrt = JaxRuntime.create(JaxConfig(jax_cache_dir="", **kw), jax_tiny_unet(), jax_tiny_vae(),
                            mesh=mesh)
    grab = optax.GradientTransformation(lambda p: jnp.zeros_like(p),
                                        lambda g, s, p=None: (jnp.zeros_like(g), g))
    repl, data = jmesh.replicated(mesh), jmesh.batch_sharding(mesh)

    def step(unet, vae, c, imgs, key):
        _, grads, _, aux = jrt._train_step(unet, vae, grab, c, grab.init(c), imgs, key)
        return grads, aux

    key = jax.random.PRNGKey(5)
    grads, aux = jax.jit(step, in_shardings=(None, None, repl, data, repl),
                         out_shardings=(repl, repl))(
        jrt.unet_params, jrt.vae_params, jnp.asarray(ctx), jmesh.shard_batch(mesh, images), key)
    _, k_noise, k_theta = jax.random.split(key, 3)
    b = images.shape[0]
    random = dict(
        thetas=torch.from_numpy(np.array(sample_thetas(k_theta, b, AffineParams()))),
        noise=torch.from_numpy(np.array(jax.random.normal(k_noise, (2 * b, 8, 8, 4)))))
    weights = from_jax_params(jax.device_get(jrt.unet_params), jax.device_get(jrt.vae_params))
    return weights, random, np.asarray(grads), {k: float(v) for k, v in aux.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(world-1 results, [rank 0's, rank 1's] world-2 results, the JAX step)."""
    folder = str(tmp_path_factory.mktemp("parallel"))
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.uniform(0, 1, (4, 64, 64, 3)).astype(np.float32))
    # x10: peaked maps, so the token rankings are well separated
    ctx = torch.from_numpy(rng.standard_normal((1, 16, 32)).astype(np.float32) * 10.0)
    weights, random, jax_grad, jax_aux = _jax_side(images.numpy(), ctx.numpy())
    from PIL import Image

    jpegs = os.path.join(folder, "jpegs")
    os.makedirs(jpegs)
    blobs = SyntheticBlobs(length=8, image_size=80)
    for i in range(len(blobs)):
        Image.fromarray((blobs[i]["img"] * 255).astype(np.uint8)).save(
            os.path.join(jpegs, f"im_{i}.jpg"), quality=90)
    inp = dict(weights=weights, images=images, ctx=ctx, jax_ctx=ctx, jax_images=images,
               jax_random=random, jpegs=jpegs)
    torch.save(inp, os.path.join(folder, "inputs.pt"))
    mp.spawn(_rank, args=(folder,), nprocs=WORLD, join=True)
    world2 = [torch.load(os.path.join(folder, f"rank{r}.pt"), weights_only=False)
              for r in range(WORLD)]
    world1 = _cases(pmesh.make_mesh(-1, device="cpu"), inp, os.path.join(folder, "world1"))
    return world1, world2, (jax_grad, jax_aux)


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("step", STEPS)
def test_world2_step_equals_world1(runs, step):
    world1, world2, _ = runs
    aux1, grad1, ctx1, gen1 = world1[step]
    for rank_out in world2:
        aux2, grad2, ctx2, gen2 = rank_out[step]
        for name in ("loss", "sharpening", "equivariance"):
            _close(aux2[name], aux1[name], atol=0)
        np.testing.assert_allclose(grad2, grad1, rtol=0, atol=1e-4 * grad1.abs().max().item())
        _close(ctx2, ctx1)
        assert torch.equal(gen2, gen1)  # every rank draws what world 1 draws
    assert grad1.abs().max() > 0
    np.testing.assert_array_equal(world2[0]["latents"], world2[1]["latents"])
    _close(world2[0]["latents"], world1["latents"])


@pytest.mark.parametrize("step", STEPS)
def test_one_all_reduce_a_step_and_no_gather(runs, step):
    world1, world2, _ = runs
    steps = 2 if step == "scan" else 1  # a group of K=2 runs 2 steps
    for rank_out in world2:
        assert rank_out["collectives"][step] == {"all_reduce": steps}
    assert world1["collectives"][step] == {}  # no group: no collective


def test_vote_and_ensemble_equal_world1(runs):
    world1, world2, _ = runs
    for rank_out in world2:
        for name in ("select", "best", "keypoints4", "keypoints3", "keypoints1"):
            np.testing.assert_array_equal(rank_out[name], world1[name], err_msg=name)
        assert [c.shape[0] for c in rank_out["chunks"]] == [4, 3]  # the tail chunk: 3 images
        for got, want in zip(rank_out["chunks"], world1["chunks"]):
            np.testing.assert_array_equal(got, want)
    assert world1["select"].shape == (4, SIZE["top_k"])
    assert world1["keypoints3"].shape == (3, SIZE["top_k"], 2)


def test_undivided_batches_raise_as_jax(runs):
    world1, world2, _ = runs
    assert world1["odd_raises"] == [False, False]
    for rank_out in world2:
        assert rank_out["odd_raises"] == [True, True]  # a training step, a vote batch


def test_checkpoint_by_rank0_resumes_as_world1(runs):
    world1, world2, _ = runs
    lr = Config().lr
    for rank_out in world2:
        for name in ("run", "resumed"):
            got, want = rank_out[name].numpy(), world1[name].numpy()
            close = np.isclose(got, want, rtol=1e-5, atol=1e-6)
            assert close.mean() >= 0.99, (name, close.mean())
            _close(got, want, rtol=0, atol=lr / 10)
    assert not torch.equal(world1["run"], world1["resumed"])  # step 3 drew a resumed stream


def test_cli_writes_from_rank0_and_equals_world1(runs):
    world1, world2, _ = runs
    folder = os.path.dirname(world2[0]["cli_folder"])
    for rank_out in world2:
        assert set(rank_out["cli"]) == {"embedding", "indices"}
        np.testing.assert_array_equal(rank_out["cli"]["indices"], world1["cli"]["indices"])
        close = np.isclose(rank_out["cli"]["embedding"], world1["cli"]["embedding"],
                           rtol=1e-5, atol=1e-6)
        assert close.mean() >= 0.99
    files = sorted(os.listdir(os.path.join(folder, "world2_cli")))
    assert files == sorted(os.listdir(os.path.join(folder, "world1_cli"))) == [
        "embedding.npy", "embedding.pt", "indices.npy", "indices.pt", "metrics.jsonl"]
    lines = {w: open(os.path.join(folder, f"{w}_cli", "metrics.jsonl")).read().count("\n")
             for w in ("world1", "world2")}
    assert lines["world1"] == lines["world2"] > 0  # one writer, one log


def test_export_from_rank0(runs):
    world1, world2, _ = runs
    folder = os.path.dirname(world2[0]["cli_folder"])
    assert world2[0]["export"] == world2[1]["export"]  # every rank reads the manifest
    assert world2[0]["export"]["files"] == world1["export"]["files"]
    assert sorted(os.listdir(os.path.join(folder, "world2_export"))) == sorted(
        list(world1["export"]["files"]) + ["manifest.json"])


def test_world2_step_matches_jax_two_device_mesh(runs):
    _, world2, (jax_grad, jax_aux) = runs
    for rank_out in world2:
        aux, grad = rank_out["jax_step"]
        for name in ("loss", "sharpening", "equivariance"):
            np.testing.assert_allclose(float(aux[name]), jax_aux[name], rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(grad.numpy(), jax_grad, rtol=0,
                                   atol=1e-4 * np.abs(jax_grad).max())
    assert np.abs(jax_grad).max() > 0


def test_mesh_validation(runs):
    _, world2, _ = runs
    # data_parallel other than the world; no device named and no GPU of its own
    for rank_out in world2:
        assert rank_out["mesh_errors"] == ["ValueError", "RuntimeError"]
    mesh = pmesh.make_mesh(-1, device="cpu")
    assert (mesh.rank, mesh.world, mesh.group) == (0, 1, None)
    with pytest.raises(ValueError, match="data_parallel=2"):
        pmesh.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="data_parallel=2"):
        Runtime.create(Config(**SIZE, data_parallel=2), tiny_unet_config(), tiny_vae_config(),
                       device="cpu")
    rows = [pmesh.Mesh(r, 2, None, torch.device("cpu")).rows(3) for r in range(2)]
    assert rows == [slice(0, 2), slice(2, 3)]
    assert pmesh.Mesh(1, 2, None, torch.device("cpu")).rows(1) == slice(1, 1)


@pytest.mark.parametrize("batch,size,remat", [
    (2, 768, "auto"),   # SD-2.1's training shape: 9 units on one device, 4.5 a rank
    (4, 1024, "auto"),  # 16 units, 8 a rank: kept
    (8, 1024, "auto"),  # 32 units, 16 a rank: recomputed
    (3, 512, "auto"),   # ceil(6 / 2) = 3 units a rank
])
def test_remat_per_rank_equals_jax_two_device_mesh(batch, size, remat):
    import jax

    from stablekeypoints_tpu.config import Config as JaxConfig
    from stablekeypoints_tpu.models.unet import sd21_tiny_config as jax_sd21_tiny
    from stablekeypoints_tpu.models.vae import tiny_vae_config as jax_tiny_vae
    from stablekeypoints_tpu.parallel import mesh as jmesh
    from stablekeypoints_tpu.pipeline.runtime import Runtime as JaxRuntime

    kw = dict(dataset_name="synthetic", batch_size=batch, image_size=size, remat=remat)
    want = JaxRuntime.create(JaxConfig(jax_cache_dir="", **kw), jax_sd21_tiny(), jax_tiny_vae(),
                             mesh=jmesh.make_mesh(2, 1, devices=jax.devices("cpu")[:2])
                             ).unet.config.remat
    assert remat_for(Config(**kw), 2) is want
    assert remat_for(Config(**kw)) is (2 * batch * (size / 512) ** 2 > 8)  # one device
    rt = Runtime.empty(Config(**kw), sd21_tiny_config(), tiny_vae_config(),
                       mesh=pmesh.Mesh(0, 2, None, torch.device("cpu")))
    assert rt.unet.config.remat is want
    if (batch, size) == (2, 768):
        assert want is False and remat_for(Config(**kw)) is True
