"""Tensor parallel in the port (`parallel/tensor.py`, the 'model' axis of
`make_mesh(n_data, n_model)`), on the CPU over gloo.

One module fixture starts its processes once: a world of 2 as the mesh
(1, 2) runs every case of the tiny SD-1.x UNet (weights from the JAX
Runtime through `from_jax_params`, sliced by `load_weights`) and of the
tiny SDXL UNet (random weights from the seed, each rank drawing the whole
parameters and keeping its slices), then a world of 4 as (2, 2) runs one
SD-1.x step. This process runs the same cases at world 1, from the same
weights, inputs and generator seeds. The tiny VAE at 64^2 in fp32, global
batch 4 (SDXL 2).

- Fill, cached and grouped (K=2) steps equal world 1 at
  tests/test_torch_parallel.py's tolerances: aux within rtol 1e-5, the
  context gradient within 1e-4 of its largest magnitude (the model ranks'
  partial products are summed in another order: measured ~2e-5), the
  context after the step within rtol 1e-5 / atol 1e-6.
- Exactly one all-reduce over the world a step (the context gradient and
  its aux) and, over the model group, the count `predicted_all_reduces`
  gives from the config (forward and backward); one forward of the vote
  batch likewise.
- The vote (select_indices, find_best_indices), the stage-3 ensemble
  (augmented_keypoints on 4, 3 and 1 images, ensemble_chunks): equal to
  world 1.
- Each rank's UNet parameter bytes: the plan's count of its slices.
- The (1, 2) step against the JAX Runtime's one-device step (its thetas
  and noise recomputed from its key), at tests/test_torch_train_slice.py's
  tolerances (aux rtol 1e-5, gradient 1e-4 of its largest magnitude).
- The split plan against the JAX package's `_param_spec` for every
  parameter of the tiny configs (names through `from_jax_params`), with
  the port's exceptions: the GEGLU proj_in's bias is sliced with its
  halves (GSPMD keeps it whole and reshards), and stacks whose heads the
  axis does not divide stay whole.
- The K1/K2 plain versions on half the heads with total_heads = H: the
  two halves sum to the full head-mean, and each half equals the JAX
  `_capture_core` / `_capture_core_fused` with total_heads = H in interpret
  mode, forward and VJP.
- Meshes whose model axis does not divide the 32 GroupNorm groups raise,
  as do a capture asked for total_heads < H and the serving export of a
  rank's slice.
"""

import torch_threads  # noqa: F401  (torch's threads: this xdist worker's share)
import datetime
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from stablekeypoints_tpu_torch.config import Config
from stablekeypoints_tpu_torch.data.synthetic import SyntheticBlobs
from stablekeypoints_tpu_torch.kernels import attn_capture
from stablekeypoints_tpu_torch.models.layers import ResnetBlock
from stablekeypoints_tpu_torch.models.unet import (
    SD15_CONFIG,
    SD21_CONFIG,
    SDXL_CONFIG,
    sd21_tiny_config,
    sdxl_tiny_config,
    tiny_unet_config,
)
from stablekeypoints_tpu_torch.models.vae import tiny_vae_config
from stablekeypoints_tpu_torch.parallel import mesh as pmesh
from stablekeypoints_tpu_torch.parallel import tensor as ptensor
from stablekeypoints_tpu_torch.pipeline.ensemble_loop import ensemble_chunks
from stablekeypoints_tpu_torch.pipeline.indices import find_best_indices
from stablekeypoints_tpu_torch.pipeline.runtime import Runtime

SIZE = dict(image_size=64, num_tokens=16, feature_upsample_res=16, top_k=4,
            furthest_point_num_samples=8, batch_size=4, augmentation_iterations=2,
            num_indices=6, dtype="float32")
SDXL_SIZE = dict(SIZE, model_type="sdxl", batch_size=2)
STEPS = ("fill", "cached", "scan")
LATENT = SIZE["image_size"] // 8


def _gen(seed):
    return torch.Generator().manual_seed(seed)


class _Counted:
    """Counts torch.distributed's collectives by the group they run over."""

    NAMES = ("all_reduce", "all_gather", "broadcast", "barrier", "reduce_scatter")

    def __init__(self, mesh):
        self.mesh, self.counts, self._orig = mesh, {}, {}

    def _group(self, group):
        if group is None or group is dist.group.WORLD:
            return "world"
        if group is self.mesh.model_group:
            return "model"
        return "data" if group is self.mesh.data_group else "other"

    def __enter__(self):
        self.start = dict(ptensor.all_reduce_counts)
        for name in self.NAMES:
            fn = self._orig[name] = getattr(dist, name)

            def counted(*a, _fn=fn, _name=name, **k):
                key = f"{_name}:{self._group(k.get('group'))}"
                self.counts[key] = self.counts.get(key, 0) + 1
                return _fn(*a, **k)

            setattr(dist, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(dist, name, fn)
        self.model = {k: ptensor.all_reduce_counts[k] - self.start[k] for k in self.start}


def _param_bytes(rt):
    return sum(p.numel() * p.element_size() for p in rt.unet.parameters())


def _steps(rt, mesh, images, ctx0, seeds, out, prefix=""):
    """Fill, cached and grouped (K=2) steps from ctx0 and a fresh Adam
    state each; their aux, gradient, context and collectives."""
    def fresh():
        context = rt.train_context(ctx0)
        return context, rt.optimizer(context)

    def run(name, fn):
        with _Counted(mesh) as c:
            result = fn()
        out[prefix + "collectives"][name] = (c.counts, c.model)
        return result

    out[prefix + "collectives"] = {}
    ctx, opt = fresh()
    gen = _gen(seeds[0])
    _, _, aux, lat = run("fill", lambda: rt.train_step_fill(ctx, opt, images, generator=gen))
    out[prefix + "fill"] = (aux, ctx.grad.clone(), ctx.detach().clone())
    lat_all = pmesh.gather_rows(mesh, lat, images.shape[0])
    ctx, opt = fresh()
    gen = _gen(seeds[1])
    _, _, aux = run("cached", lambda: rt.train_step_cached(ctx, opt, lat, images, generator=gen))
    out[prefix + "cached"] = (aux, ctx.grad.clone(), ctx.detach().clone())
    ctx, opt = fresh()
    gen = _gen(seeds[2])
    lat_k = pmesh.stacked_shard_batch(mesh, torch.stack([lat_all, lat_all.flip(0)]))
    _, _, aux = run("scan", lambda: rt.train_step_scan(
        ctx, opt, lat_k, torch.stack([images, images.flip(0)]), generator=gen))
    out[prefix + "scan"] = (aux, ctx.grad.clone(), ctx.detach().clone())


def _cases(mesh, inp, folder):
    """Every (1, 2) case on this rank (world 1: the same, whole)."""
    out = {}
    cfg = Config(**SIZE)
    rt = Runtime.create(cfg, tiny_unet_config(), tiny_vae_config(), mesh=mesh)
    rt.load_weights(*inp["weights"])
    images, ctx0 = inp["images"], inp["ctx"]
    out["bytes"] = _param_bytes(rt)
    _steps(rt, mesh, images, ctx0, (5, 6, 7), out)

    # one forward of a vote batch, then the vote and the ensemble
    with _Counted(mesh) as c:
        out["select"] = rt.select_indices(ctx0, images, generator=_gen(8))
    out["select_collectives"] = (c.counts, c.model)
    data = SyntheticBlobs(length=7, image_size=cfg.image_size)
    out["best"] = torch.as_tensor(find_best_indices(rt, data, ctx0, generator=_gen(9)))
    idx = torch.arange(cfg.top_k)
    for m in (4, 3, 1):
        out[f"keypoints{m}"] = rt.augmented_keypoints(ctx0, images[:m], idx, generator=_gen(10))
    out["chunks"] = [torch.as_tensor(pts) for _, pts in
                     ensemble_chunks(rt, data, np.arange(7), ctx0, idx, _gen(11), 4)]

    # the step held to the JAX package's (its thetas and noise given)
    context = rt.train_context(ctx0)
    _, _, aux = rt.train_step(context, rt.optimizer(context), images, **inp["jax_random"])
    out["jax_step"] = (aux, context.grad.clone())

    from stablekeypoints_tpu_torch.serving import export_detector

    try:
        export_detector(rt, ctx0, idx, folder + "_export")
        out["export_raises"] = False
    except ValueError:
        out["export_raises"] = True

    # SDXL, random weights from the seed
    xcfg = Config(**SDXL_SIZE)
    xrt = Runtime.create(xcfg, sdxl_tiny_config(), tiny_vae_config(), mesh=mesh)
    out["sdxl_bytes"] = _param_bytes(xrt)
    _steps(xrt, mesh, images[:2], inp["sdxl_ctx"], (15, 16, 17), out, "sdxl_")
    return out


def _sd21_fill(mesh, inp):
    """A fill step of the tiny SD-2.x UNet (16-dim heads: 2, 4 and 8 of them),
    whose 2-head stacks 4 model ranks keep whole; its UNet bytes."""
    rt = Runtime.create(Config(**SIZE), sd21_tiny_config(), tiny_vae_config(), mesh=mesh)
    context = rt.train_context(inp["sdxl_ctx"])
    with _Counted(mesh) as c:
        _, _, aux, _ = rt.train_step_fill(context, rt.optimizer(context), inp["images"],
                                          generator=_gen(25))
    return dict(fill=(aux, context.grad.clone(), context.detach().clone()),
                collectives=c.counts, bytes=_param_bytes(rt))


def _cases22(mesh, inp):
    """The (2, 2) cases: one fill step and an uneven ensemble; then, on a
    (1, 4) mesh of the same world, the SD-2.x fill step."""
    out = {}
    cfg = Config(**SIZE)
    rt = Runtime.create(cfg, tiny_unet_config(), tiny_vae_config(), mesh=mesh)
    rt.load_weights(*inp["weights"])
    out["bytes"] = _param_bytes(rt)
    context = rt.train_context(inp["ctx"])
    opt = rt.optimizer(context)
    with _Counted(mesh) as c:
        _, _, aux, _ = rt.train_step_fill(context, opt, inp["images"], generator=_gen(5))
    out["fill"] = (aux, context.grad.clone(), context.detach().clone())
    out["collectives"] = {"fill": (c.counts, c.model)}
    out["keypoints3"] = rt.augmented_keypoints(inp["ctx"], inp["images"][:3],
                                               torch.arange(cfg.top_k), generator=_gen(10))
    out["coords"] = (mesh.data_rank, mesh.model_rank, mesh.n_data, mesh.n_model)
    out["sd21_14"] = _sd21_fill(pmesh.make_mesh(1, 4, device="cpu"), inp)
    return out


def _rank(rank, folder, n_data, n_model):
    world = n_data * n_model
    torch.set_num_threads(torch_threads.share(world))
    dist.init_process_group("gloo", init_method=f"file://{folder}/rendezvous{world}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        inp = torch.load(os.path.join(folder, "inputs.pt"), weights_only=False)
        mesh = pmesh.make_mesh(n_data, n_model, device="cpu")
        if world == 2:
            out = _cases(mesh, inp, os.path.join(folder, f"rank{rank}"))
            errors = []
            for kw in (dict(n_data=2, n_model=2), dict(n_data=-1, n_model=3)):
                try:
                    pmesh.make_mesh(device="cpu", **kw)
                    errors.append("")
                except (ValueError, RuntimeError) as e:
                    errors.append(type(e).__name__)
            out["mesh_errors"] = errors
        else:
            out = _cases22(mesh, inp)
        torch.save(out, os.path.join(folder, f"world{world}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _jax_side(images, ctx):
    """The JAX Runtime on one CPU device: its weights, and one
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

    kw = {k: v for k, v in SIZE.items() if k != "num_indices"}
    jrt = JaxRuntime.create(JaxConfig(jax_cache_dir="", **kw), jax_tiny_unet(), jax_tiny_vae(),
                            mesh=jmesh.make_mesh(1, 1, devices=jax.devices("cpu")[:1]))
    grab = optax.GradientTransformation(lambda p: jnp.zeros_like(p),
                                        lambda g, s, p=None: (jnp.zeros_like(g), g))

    @jax.jit
    def step(unet, vae, c, imgs, key):
        _, grads, _, aux = jrt._train_step(unet, vae, grab, c, grab.init(c), imgs, key)
        return grads, aux

    key = jax.random.PRNGKey(5)
    grads, aux = step(jrt.unet_params, jrt.vae_params, jnp.asarray(ctx), jnp.asarray(images), key)
    _, k_noise, k_theta = jax.random.split(key, 3)
    b = images.shape[0]
    random = dict(
        thetas=torch.from_numpy(np.array(sample_thetas(k_theta, b, AffineParams()))),
        noise=torch.from_numpy(np.array(jax.random.normal(k_noise, (2 * b, LATENT, LATENT, 4)))))
    weights = from_jax_params(jax.device_get(jrt.unet_params), jax.device_get(jrt.vae_params))
    return weights, random, np.asarray(grads), {k: float(v) for k, v in aux.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(world-1 results, [(1, 2) ranks' results], [(2, 2) ranks' results],
    the JAX step)."""
    folder = str(tmp_path_factory.mktemp("tensor_parallel"))
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.uniform(0, 1, (4, 64, 64, 3)).astype(np.float32))
    # x10: peaked maps, so the token rankings are well separated
    ctx = torch.from_numpy(rng.standard_normal((1, 16, 32)).astype(np.float32) * 10.0)
    sdxl_ctx = torch.from_numpy(rng.standard_normal((1, 16, 48)).astype(np.float32) * 10.0)
    weights, random, jax_grad, jax_aux = _jax_side(images.numpy(), ctx.numpy())
    inp = dict(weights=weights, images=images, ctx=ctx, sdxl_ctx=sdxl_ctx, jax_random=random)
    torch.save(inp, os.path.join(folder, "inputs.pt"))
    mp.spawn(_rank, args=(folder, 1, 2), nprocs=2, join=True)
    mp.spawn(_rank, args=(folder, 2, 2), nprocs=4, join=True)
    tp12 = [torch.load(os.path.join(folder, f"world2_rank{r}.pt"), weights_only=False)
            for r in range(2)]
    tp22 = [torch.load(os.path.join(folder, f"world4_rank{r}.pt"), weights_only=False)
            for r in range(4)]
    world1 = _cases(pmesh.make_mesh(-1, device="cpu"), inp, os.path.join(folder, "world1"))
    world1["sd21"] = _sd21_fill(pmesh.make_mesh(-1, device="cpu"), inp)
    return world1, tp12, tp22, (jax_grad, jax_aux)


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _held(got, want):
    aux2, grad2, ctx2 = got
    aux1, grad1, ctx1 = want
    for name in ("loss", "sharpening", "equivariance"):
        _close(aux2[name], aux1[name], atol=0)
    np.testing.assert_allclose(grad2, grad1, rtol=0, atol=1e-4 * grad1.abs().max().item())
    _close(ctx2, ctx1)
    assert grad1.abs().max() > 0


CASES = [("sd", s) for s in STEPS] + [("sdxl", s) for s in STEPS] + [("sd22", "fill")]


def _pick(runs, model, step):
    world1, tp12, tp22, _ = runs
    ranks = tp22 if model == "sd22" else tp12
    key = f"sdxl_{step}" if model == "sdxl" else step
    return world1[key], [r[key] for r in ranks], ranks


@pytest.mark.parametrize("model,step", CASES)
def test_step_equals_world1(runs, model, step):
    want, got, _ = _pick(runs, model, step)
    for g in got:
        _held(g, want)


@pytest.mark.parametrize("model,step", CASES)
def test_all_reduces_a_step(runs, model, step):
    """One world all-reduce a step (K of a group of K), no gather, and the
    model group's as predicted from the config."""
    world1, _, _, _ = runs
    _, _, ranks = _pick(runs, model, step)
    config = sdxl_tiny_config() if model == "sdxl" else tiny_unet_config()
    steps = 2 if step == "scan" else 1
    want = ptensor.predicted_all_reduces(config, 2, LATENT, SIZE["feature_upsample_res"],
                                         truncate=True, grad=True)
    for r in ranks:
        counts, model_counts = r[("sdxl_" if model == "sdxl" else "") + "collectives"][step]
        assert counts == {"all_reduce:world": steps,
                          "all_reduce:model": steps * (want["forward"] + want["backward"])}
        assert model_counts == {k: steps * v for k, v in want.items()}
    assert want["forward"] > 0 and want["backward"] > 0
    prefix = "sdxl_" if model == "sdxl" else ""
    assert world1[prefix + "collectives"][step][0] == {}  # no group: no collective


def test_vote_forward_all_reduces_as_predicted(runs):
    _, tp12, _, _ = runs
    want = ptensor.predicted_all_reduces(tiny_unet_config(), 2, LATENT,
                                         SIZE["feature_upsample_res"], truncate=True)
    assert want == {"forward": 54, "backward": 0}  # 17 resnets + 3 x 11 blocks + 4 captures
    for r in tp12:
        counts, model_counts = r["select_collectives"]
        # the vote batch's forward, then the gather of the selections (one data coordinate)
        assert counts == {"all_reduce:model": want["forward"]}
        assert model_counts == want


def test_vote_and_ensemble_equal_world1(runs):
    world1, tp12, tp22, _ = runs
    for rank_out in tp12:
        for name in ("select", "best", "keypoints4", "keypoints3", "keypoints1"):
            np.testing.assert_array_equal(rank_out[name], world1[name], err_msg=name)
        assert [c.shape[0] for c in rank_out["chunks"]] == [4, 3]
        for got, want in zip(rank_out["chunks"], world1["chunks"]):
            np.testing.assert_array_equal(got, want)
    for rank_out in tp22:  # 3 images over 2 data coordinates: 2 + 1
        np.testing.assert_array_equal(rank_out["keypoints3"], world1["keypoints3"])
    assert [r["coords"] for r in tp22] == [(0, 0, 2, 2), (0, 1, 2, 2), (1, 0, 2, 2),
                                           (1, 1, 2, 2)]


def test_whole_stacks_step_equals_world1(runs):
    """(1, 4) with the tiny SD-2.x UNet: its 2-head stacks stay whole on
    every rank (their context gradient scaled by 1/4 before the world's
    sum), the rest split 4 ways."""
    world1, _, tp22, _ = runs
    want = world1["sd21"]
    assert ptensor.whole_stacks(sd21_tiny_config(), 4)  # some stacks are whole
    full, plan = ptensor.full_unet_shapes(sd21_tiny_config()), ptensor.split_plan(
        sd21_tiny_config(), 4)
    rank_bytes = sum(4 * ptensor.take_slice(torch.empty(full[n], device="meta"), plan[n], 0,
                                            4).numel() for n in full)
    for r in tp22:
        got = r["sd21_14"]
        _held(got["fill"], want["fill"])
        assert got["collectives"]["all_reduce:world"] == 1
        assert got["bytes"] == rank_bytes < want["bytes"]


@pytest.mark.parametrize("model", ["sd", "sdxl", "sd22"])
def test_param_bytes_equal_plan(runs, model):
    world1, tp12, tp22, _ = runs
    config = sdxl_tiny_config() if model == "sdxl" else tiny_unet_config()
    key = "sdxl_bytes" if model == "sdxl" else "bytes"
    full, plan = ptensor.full_unet_shapes(config), ptensor.split_plan(config, 2)
    want = sum(4 * ptensor.take_slice(torch.empty(full[n], device="meta"), plan[n], 0, 2).numel()
               for n in full)
    assert world1[key] == 4 * sum(int(np.prod(s)) for s in full.values())
    for r in (tp22 if model == "sd22" else tp12):
        assert r[key] == want < world1[key]


def test_step_matches_jax_one_device(runs):
    _, tp12, _, (jax_grad, jax_aux) = runs
    for rank_out in tp12:
        aux, grad = rank_out["jax_step"]
        for name in ("loss", "sharpening", "equivariance"):
            np.testing.assert_allclose(float(aux[name]), jax_aux[name], rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(grad.numpy(), jax_grad, rtol=0,
                                   atol=1e-4 * np.abs(jax_grad).max())
    assert np.abs(jax_grad).max() > 0


def test_mesh_validation_and_refusals(runs):
    world1, tp12, _, _ = runs
    for r in tp12:
        # 2 x 2 in a world of 2; 3 model ranks
        assert r["mesh_errors"] == ["ValueError", "ValueError"]
        assert r["export_raises"] is True
    assert world1["export_raises"] is False
    with pytest.raises(ValueError, match="GroupNorm groups"):
        pmesh.make_mesh(1, 3, device="cpu")
    with pytest.raises(ValueError, match="GroupNorm groups"):
        ResnetBlock(24, 24, 16, axis=ptensor.ModelAxis(0, 16))  # gcd(32, 24) = 8 groups
    mesh = pmesh.Mesh(3, 4, None, torch.device("cpu"), n_model=2)
    assert (mesh.n_data, mesh.data_rank, mesh.model_rank, mesh.rows(4)) == (2, 1, 1, slice(2, 4))
    assert pmesh.Mesh(1, 2, None, torch.device("cpu")).model_axis is None


def test_capture_total_heads_below_heads_raises():
    q, k = torch.zeros(1, 4, 8, 16), torch.zeros(1, 5, 4, 16)
    with pytest.raises(ValueError, match="total_heads 3"):
        attn_capture.capture_attention(q, k, 0.25, total_heads=3)
    tt, ww = torch.zeros(1, 4, 2, 4, 16), torch.zeros(8, 4)
    g = torch.zeros(1, 16, 5)
    with pytest.raises(ValueError, match="total_heads 2"):
        attn_capture.capture_attention_fused_bwd(tt, ww, k, g, 0.25, total_heads=2)


# ---------------------------------------------------------------------------
# the split plan against the JAX package's rules


def _jax_paths(config):
    """{port parameter name: JAX parameter path} of a tiny UNet, through
    `from_jax_params` (on a tree of each parameter's rank, shapes aside)."""
    import jax
    import jax.numpy as jnp

    from stablekeypoints_tpu.models.unet import UNet as JaxUNet
    from stablekeypoints_tpu_torch.models.weights import from_jax_params

    shapes = jax.eval_shape(JaxUNet(config).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, config.in_channels)), jnp.zeros((1,), jnp.int32),
                            jnp.zeros((1, 8, config.context_dim)))["params"]
    out = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                name = next(iter(from_jax_params(
                    _nest(path + (k,), np.zeros((1,) * len(v.shape), np.float32)), {})[0]))
                out[name] = path + (k,)

    walk(shapes, ())
    return out


def _nest(path, leaf):
    tree = leaf
    for k in reversed(path):
        tree = {k: tree}
    return tree


# the port's kind for each JAX PartitionSpec over 'model'
_SPEC_KIND = {(): "replicated", (None, "model"): "column", ("model", None): "row",
              (None, None, None, "model"): "column", (None, None, "model", None): "row",
              ("model",): "column"}


@pytest.mark.parametrize("name,n_model", [("tiny", 2), ("tiny", 4), ("sdxl_tiny", 2),
                                          ("sdxl_tiny", 4), ("sd21_tiny", 2), ("sd21_tiny", 4)])
def test_plan_matches_jax_param_spec(name, n_model):
    from stablekeypoints_tpu.models import unet as junet
    from stablekeypoints_tpu.parallel.mesh import _param_spec

    jconfig = getattr(junet, {"tiny": "tiny_unet_config"}.get(name, f"{name}_config"))()
    config = {"tiny": tiny_unet_config, "sdxl_tiny": sdxl_tiny_config,
              "sd21_tiny": sd21_tiny_config}[name]()
    paths = _jax_paths(jconfig)
    plan = ptensor.split_plan(config, n_model)
    assert set(plan) == set(paths)
    whole = ptensor.whole_stacks(config, n_model)
    # sd21_tiny's 2-head stacks (32 channels of 16-dim heads) stay whole at 4 ranks
    assert whole == ([] if (name, n_model) != ("sd21_tiny", 4) else
                     ["down_0.attentions_0", "down_0.attentions_1", "up_3.attentions_0",
                      "up_3.attentions_1", "up_3.attentions_2"])
    exceptions = 0
    for port_name, path in paths.items():
        want = _SPEC_KIND[tuple(_param_spec(path))]
        got = plan[port_name]
        if got == "halves":  # the GEGLU proj_in: its kernel's columns, halves paired
            assert port_name.endswith(".ff.proj_in.weight") and want == "column" or \
                port_name.endswith(".ff.proj_in.bias") and want == "replicated", port_name
            exceptions += port_name.endswith(".bias")
        elif any(port_name.startswith(s + ".") for s in whole):
            assert got == "replicated", port_name
            exceptions += want != "replicated"
        else:
            assert got == want, (port_name, path, got, want)
    assert exceptions > 0


@pytest.mark.parametrize("config,n_model,whole", [
    (SD15_CONFIG, 4, 0),   # 8 heads everywhere
    (SD21_CONFIG, 2, 5),   # the 5-head stacks of down_0 and up_3
    (SD21_CONFIG, 4, 10),  # and the 10-head stacks of down_1 and up_2
    (SDXL_CONFIG, 2, 0),
    (SDXL_CONFIG, 4, 5),   # the 10-head stacks of down_1 and up_1
])
def test_whole_stacks_of_full_configs(config, n_model, whole):
    stacks = ptensor.whole_stacks(config, n_model)
    assert len(stacks) == whole
    for s in stacks:
        block = s.split(".")[0]
        ch = {"down_0": 320, "up_3": 320, "down_1": 640, "up_2": 640, "up_1": 640}[block]
        assert config.heads_for(ch)[0] % n_model
    with torch.device("meta"):
        from stablekeypoints_tpu_torch.models.unet import UNet

        unet = UNet(config, ptensor.ModelAxis(0, n_model))
    plan = ptensor.split_plan(config, n_model)
    full = ptensor.full_unet_shapes(config)
    for name, p in unet.named_parameters():
        want = ptensor.take_slice(torch.empty(full[name], device="meta"), plan[name], 0, n_model)
        assert tuple(p.shape) == tuple(want.shape), name


# ---------------------------------------------------------------------------
# K1/K2's partial head-mean: plain versions vs the JAX kernels (interpret)


@pytest.mark.parametrize("fused", [False, True])
def test_capture_half_heads_equal_jax_capture_core(fused):
    import jax
    import jax.numpy as jnp

    from stablekeypoints_tpu.kernels import attn_capture as jcap
    from stablekeypoints_tpu_torch.ops.resize import resize_matrix

    rng = np.random.default_rng(7)
    b, h, d, t, x, res = 1, 4, 16, 24, 4, 8
    scale = d ** -0.5
    k = rng.standard_normal((b, t, h, d)).astype(np.float32)
    g = rng.standard_normal((b, res * res, t)).astype(np.float32)
    if fused:
        q = rng.standard_normal((b, h, res, x, d)).astype(np.float32)
        ww = resize_matrix(x, res, "bicubic", torch.float32, "cpu")
        fwd = lambda qq, kk, tot: attn_capture.capture_fused_plain(  # noqa: E731
            torch.from_numpy(qq), ww, torch.from_numpy(kk), scale, tot)
        bwd = lambda qq, kk, tot: attn_capture.capture_fused_bwd_plain(  # noqa: E731
            torch.from_numpy(qq), ww, torch.from_numpy(kk), torch.from_numpy(g), scale,
            total_heads=tot)
        jfn = lambda qq, kk: jcap._capture_core_fused(  # noqa: E731
            qq, jnp.asarray(ww.numpy()), kk, scale, True, h)
        q_sl = lambda lo, hi: q[:, lo:hi]  # noqa: E731
    else:
        q = rng.standard_normal((b, h, res * res, d)).astype(np.float32)
        fwd = lambda qq, kk, tot: attn_capture.capture_plain(  # noqa: E731
            torch.from_numpy(qq), torch.from_numpy(kk), scale, tot)
        bwd = lambda qq, kk, tot: attn_capture.capture_bwd_plain(  # noqa: E731
            torch.from_numpy(qq), torch.from_numpy(kk), torch.from_numpy(g), scale,
            total_heads=tot)
        jfn = lambda qq, kk: jcap._capture_core(qq, kk, scale, True, h)  # noqa: E731
        q_sl = lambda lo, hi: q[:, lo:hi]  # noqa: E731
    halves = [(0, h // 2), (h // 2, h)]
    parts = []
    for lo, hi in halves:
        qh, kh = np.ascontiguousarray(q_sl(lo, hi)), np.ascontiguousarray(k[:, :, lo:hi])
        part = fwd(qh, kh, h)
        want, vjp = jax.vjp(jfn, jnp.asarray(qh), jnp.asarray(kh))
        np.testing.assert_allclose(part.numpy(), np.asarray(want), rtol=0, atol=1e-6)
        dq, dk = bwd(qh, kh, h)
        jdq, jdk = vjp(jnp.asarray(g))
        for got, w in ((dq, jdq), (dk, jdk)):
            w = np.asarray(w)
            np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())
        parts.append(part)
    full = fwd(q, k, None)
    np.testing.assert_allclose((parts[0] + parts[1]).numpy(), full.numpy(), rtol=0, atol=1e-6)
