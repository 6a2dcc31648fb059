"""Stage-1 checkpoints and resume in the port (the JAX package's
tests/test_checkpoint.py, plus a CPU resume at tiny sizes).

- Round trip and the latest of several steps, as the JAX test; the
  restored Adam moments and count equal the JAX package's restored optax
  state after the same update (mu = exp_avg, nu = exp_avg_sq, count =
  step; within 2 float32 ulps, 2.4e-7 relative, as the two sides order
  one multiply-add differently).
- A resume on the CPU: a 4-step run checkpoints step 2; a 6-step run from
  that checkpoint logs `resumed` at step 3, runs steps 3-5, and its
  step-4 checkpoint holds Adam's count 5. A run with nothing left to do
  returns the saved context and holds the saved Adam state, bitwise.
"""

import torch_threads  # noqa: F401  (torch's threads: this xdist worker's share)
import functools
import json
import shutil

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stablekeypoints_tpu.utils.checkpoint import TrainCheckpointer as JaxCheckpointer
from stablekeypoints_tpu_torch.config import Config
from stablekeypoints_tpu_torch.data.synthetic import SyntheticBlobs
from stablekeypoints_tpu_torch.models.unet import tiny_unet_config
from stablekeypoints_tpu_torch.models.vae import tiny_vae_config
from stablekeypoints_tpu_torch.ops.transforms import AffineParams, sample_thetas
from stablekeypoints_tpu_torch.pipeline.optimize import optimize_embedding, stream_seed
from stablekeypoints_tpu_torch.pipeline.runtime import Runtime
from stablekeypoints_tpu_torch.utils.checkpoint import TrainCheckpointer
from stablekeypoints_tpu_torch.utils.logging import MetricsLogger

SIZE = dict(image_size=64, num_tokens=16, feature_upsample_res=16, top_k=4,
            furthest_point_num_samples=8, batch_size=2, dtype="float32")


def _adam_once(context, grad):
    ctx = torch.tensor(context, requires_grad=True)
    opt = torch.optim.Adam([ctx], lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    ctx.grad = torch.tensor(grad)
    opt.step()
    return ctx, opt


def test_checkpoint_roundtrip_equal_jax(tmp_path):
    context = np.arange(24, dtype=np.float32).reshape(1, 4, 6)
    grad = np.random.default_rng(0).standard_normal(context.shape).astype(np.float32)
    ctx, opt = _adam_once(context, grad)
    ckpt = TrainCheckpointer(str(tmp_path / "port"))
    ckpt.save(7, ctx, opt)
    assert ckpt.latest_step() == 7
    restored = ckpt.restore()
    assert restored["step"] == 7
    np.testing.assert_array_equal(restored["context"].numpy(), ctx.detach().numpy())
    assert restored["context"].dtype == torch.float32 and not restored["context"].requires_grad

    # into a fresh optimizer: the same state as the saved one
    fresh_ctx = torch.zeros_like(ctx, requires_grad=True)
    fresh = torch.optim.Adam([fresh_ctx], lr=1e-3)
    fresh.load_state_dict(restored["optimizer"])
    for key in ("exp_avg", "exp_avg_sq", "step"):
        torch.testing.assert_close(fresh.state[fresh_ctx][key], opt.state[ctx][key], rtol=0, atol=0)

    # the JAX package's checkpoint of the same update
    jopt = optax.adam(1e-3)
    jstate = jopt.init(jnp.asarray(context))
    _, jstate = jopt.update(jnp.asarray(grad), jstate, jnp.asarray(context))
    jckpt = JaxCheckpointer(str(tmp_path / "jax"))
    jckpt.save(7, jnp.asarray(context), jstate)
    adam = jckpt.restore()["opt_state"][0]
    state = restored["optimizer"]["state"][0]
    np.testing.assert_allclose(state["exp_avg"].numpy(), np.asarray(adam["mu"]), rtol=2.4e-7)
    np.testing.assert_allclose(state["exp_avg_sq"].numpy(), np.asarray(adam["nu"]), rtol=2.4e-7)
    assert float(state["step"]) == int(adam["count"]) == 1


def test_latest_of_multiple(tmp_path):
    ctx, opt = _adam_once(np.zeros((1, 2, 2), np.float32), np.ones((1, 2, 2), np.float32))
    ckpt = TrainCheckpointer(str(tmp_path))
    assert ckpt.latest_step() is None and ckpt.restore() is None
    ckpt.save(3, ctx, opt)
    ckpt.save(11, ctx, opt)
    assert ckpt.latest_step() == 11
    assert ckpt.restore(3)["step"] == 3
    assert sorted(p.name for p in (tmp_path / "checkpoints").iterdir()) == [
        "step_00000003", "step_00000011"]


def test_stream_seed():
    assert stream_seed(1, 0) == 1
    seeds = {stream_seed(1, s) for s in (1, 2, 3)} | {stream_seed(2, 3)}
    assert len(seeds) == 4 and 1 not in seeds
    assert stream_seed(1, 3) == stream_seed(1, 3)
    # a resumed run draws other thetas than step 0 did
    aff = AffineParams()
    first = sample_thetas(torch.Generator().manual_seed(stream_seed(1, 0)), 2, aff)
    resumed = sample_thetas(torch.Generator().manual_seed(stream_seed(1, 3)), 2, aff)
    assert not torch.allclose(first, resumed)


@functools.lru_cache(maxsize=None)
def _models():
    rt = Runtime.create(Config(**SIZE), tiny_unet_config(), tiny_vae_config(), device="cpu")
    return rt.unet, rt.vae, rt.schedule


def _runtime(folder, **kw):
    unet, vae, schedule = _models()
    cfg = Config(**SIZE, save_folder=str(folder), checkpoint_every=2, log_every=1, **kw)
    return Runtime(cfg, unet, vae, schedule, torch.device("cpu"))


def _train(folder, num_steps):
    rt = _runtime(folder, num_steps=num_steps)
    opts = []
    make = rt.optimizer
    rt.optimizer = lambda ctx: opts.append(make(ctx)) or opts[-1]
    logger = MetricsLogger(str(folder))
    out = optimize_embedding(rt, SyntheticBlobs(length=4, image_size=64), logger,
                             checkpointer=TrainCheckpointer(str(folder)))
    logger.close()
    with open(folder / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    return out, opts[0], records


@pytest.fixture(scope="module")
def first_run(tmp_path_factory):
    folder = tmp_path_factory.mktemp("first")
    return folder, _train(folder, 4)


def test_resume_continues_to_num_steps(first_run, tmp_path):
    folder, (_, _, records) = first_run
    assert [r["step"] for r in records if "loss" in r] == [0, 1, 2, 3]
    assert TrainCheckpointer(str(folder)).latest_step() == 2
    shutil.copytree(folder / "checkpoints", tmp_path / "checkpoints")

    out, opt, records = _train(tmp_path, 6)
    assert records[0] == {"t": records[0]["t"], "stage": 1, "event": "resumed", "step": 3}
    assert [r["step"] for r in records if "loss" in r] == [3, 4, 5]
    assert records[-1]["event"] == "done" and torch.isfinite(out).all()
    ckpt = TrainCheckpointer(str(tmp_path))
    assert ckpt.latest_step() == 4
    assert float(ckpt.restore(4)["optimizer"]["state"][0]["step"]) == 5  # 3 restored + 2
    assert float(opt.state_dict()["state"][0]["step"]) == 6


def test_resumed_state_equals_saved(first_run, tmp_path):
    """num_steps 3 after the step-2 checkpoint: nothing to run, so the
    returned context and the optimizer hold exactly what was saved."""
    folder, _ = first_run
    shutil.copytree(folder / "checkpoints", tmp_path / "checkpoints")
    saved = TrainCheckpointer(str(tmp_path)).restore()
    out, opt, records = _train(tmp_path, 3)
    assert [r.get("event") for r in records] == ["resumed", "done"]
    torch.testing.assert_close(out, saved["context"], rtol=0, atol=0)
    state, want = opt.state_dict()["state"][0], saved["optimizer"]["state"][0]
    for key in ("exp_avg", "exp_avg_sq", "step"):
        torch.testing.assert_close(state[key], want[key], rtol=0, atol=0)
    assert opt.param_groups[0]["params"][0].device.type == "cpu"
