"""`steps_per_call` in the port: groups of cache-hit steps as one call
(the JAX package's tests/test_train_scan.py, at the tiny sizes on the CPU).

- `Runtime.train_step_scan` against K `train_step_cached` calls from the
  same generator state: the context within rtol 1e-5 / atol 1e-6, each
  step's aux within rtol 1e-5, and the generator left in the same state
  (the group draws what K calls draw, in their order). On the CPU the
  steps run one after another; the CUDA graph path is checked on the card
  by chip_smoke.py.
- `optimize_embedding` with steps_per_call 3 against 1: the same batches
  in the same order, the same learned context (rtol 1e-5 / atol 1e-6).
- Which steps run grouped and which are checkpointed, against the JAX
  package's loop for the same num_steps, checkpoint_every, steps_per_call
  and cache pattern. Both loops drive stand-in runtimes that record the
  calls (no models), so the JAX loop runs here in milliseconds.
- A resume from a checkpoint written after a group: the Adam count saved
  with the group's last step, the run continuing after it.
"""

import torch_threads  # noqa: F401  (torch's threads: this xdist worker's share)
import functools
import json

import numpy as np
import pytest
import torch

from stablekeypoints_tpu_torch.config import Config
from stablekeypoints_tpu_torch.data.synthetic import SyntheticBlobs
from stablekeypoints_tpu_torch.models.unet import tiny_unet_config
from stablekeypoints_tpu_torch.models.vae import tiny_vae_config
from stablekeypoints_tpu_torch.parallel.mesh import make_mesh
from stablekeypoints_tpu_torch.pipeline.optimize import optimize_embedding
from stablekeypoints_tpu_torch.pipeline.runtime import Runtime
from stablekeypoints_tpu_torch.utils.checkpoint import TrainCheckpointer
from stablekeypoints_tpu_torch.utils.logging import MetricsLogger

SIZE = dict(image_size=64, num_tokens=16, feature_upsample_res=16, top_k=4,
            furthest_point_num_samples=8, batch_size=2, dtype="float32")


@functools.lru_cache(maxsize=None)
def _models():
    rt = Runtime.create(Config(**SIZE), tiny_unet_config(), tiny_vae_config(), device="cpu")
    return rt.unet, rt.vae, rt.schedule


def _runtime(**kw):
    unet, vae, schedule = _models()
    return Runtime(Config(**SIZE, **kw), unet, vae, schedule, torch.device("cpu"))


def test_scan_matches_per_step_calls():
    rt = _runtime()
    k = 3
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.uniform(0, 1, (k, 2, 64, 64, 3)).astype(np.float32))
    latents = torch.stack([rt._encode(i) for i in images])
    ctx0 = rt.init_context()

    ctx_a = rt.train_context(ctx0)
    opt_a, gen_a = rt.optimizer(ctx_a), torch.Generator().manual_seed(7)
    per_step = [rt.train_step_cached(ctx_a, opt_a, latents[j], images[j], generator=gen_a)[2]
                for j in range(k)]

    ctx_b = rt.train_context(ctx0)
    opt_b, gen_b = rt.optimizer(ctx_b), torch.Generator().manual_seed(7)
    _, _, stacked = rt.train_step_scan(ctx_b, opt_b, latents, images, generator=gen_b)

    assert torch.equal(gen_a.get_state(), gen_b.get_state())
    assert (ctx_b - ctx0).abs().max() > 1e-4  # the steps moved the context
    torch.testing.assert_close(ctx_b, ctx_a, rtol=1e-5, atol=1e-6)
    assert set(stacked) == {"loss", "sharpening", "equivariance"}
    for name, values in stacked.items():
        assert values.shape == (k,)
        for j in range(k):
            torch.testing.assert_close(values[j], per_step[j][name], rtol=1e-5, atol=0)
    assert float(opt_b.state_dict()["state"][0]["step"]) == k


def test_scan_with_given_draws():
    """thetas and noise passed in are used as given, step by step."""
    rt = _runtime()
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.uniform(0, 1, (2, 2, 64, 64, 3)).astype(np.float32))
    latents = torch.stack([rt._encode(i) for i in images])
    gen = torch.Generator().manual_seed(3)
    thetas = torch.stack([torch.eye(2, 3) for _ in range(4)]).reshape(2, 2, 2, 3)
    noise = torch.randn((2, 4, 8, 8, 4), generator=gen)
    ctx0 = rt.init_context()
    ctx_a = rt.train_context(ctx0)
    opt_a = rt.optimizer(ctx_a)
    want = [rt.train_step_cached(ctx_a, opt_a, latents[j], images[j], thetas=thetas[j],
                                 noise=noise[j])[2]["loss"] for j in range(2)]
    ctx_b = rt.train_context(ctx0)
    _, _, got = rt.train_step_scan(ctx_b, rt.optimizer(ctx_b), latents, images, thetas=thetas,
                                   noise=noise)
    torch.testing.assert_close(got["loss"], torch.stack(want), rtol=1e-5, atol=0)
    torch.testing.assert_close(ctx_b, ctx_a, rtol=1e-5, atol=1e-6)


def _recording(rt, seen):
    """Record the images of every step (a checksum per image) in order."""
    for name in ("train_step_fill", "train_step_cached", "train_step_scan"):
        method = getattr(rt, name)

        def wrapped(*a, _m=method, _n=name, **kw):
            images = torch.as_tensor(a[3] if _n != "train_step_fill" else a[2])
            for step_images in (images if _n == "train_step_scan" else images[None]):
                seen.append((_n, [round(float(x.sum()), 3) for x in step_images]))
            return _m(*a, **kw)

        setattr(rt, name, wrapped)


def test_optimize_grouping_matches_per_step(tmp_path):
    """4 images, batch 2, 8 steps: fills at steps 0-1, then steps_per_call
    3 runs steps 2-4 and 5-7 as two groups; the per-step run sees the same
    batches in the same order and learns the same context."""
    data = SyntheticBlobs(length=4, image_size=64)
    ctx0 = _runtime().init_context()
    runs = {}
    for k in (3, 1):
        rt = _runtime(num_steps=8, steps_per_call=k, save_folder=str(tmp_path / str(k)))
        seen = []
        _recording(rt, seen)
        out = optimize_embedding(rt, data, context=ctx0, generator=torch.Generator().manual_seed(5))
        runs[k] = (out, seen)
    (out3, seen3), (out1, seen1) = runs[3], runs[1]
    assert [n for n, _ in seen3] == ["train_step_fill"] * 2 + ["train_step_scan"] * 6
    assert [n for n, _ in seen1] == ["train_step_fill"] * 2 + ["train_step_cached"] * 6
    assert [s for _, s in seen3] == [s for _, s in seen1]
    assert (out3 - ctx0).abs().max() > 1e-4
    torch.testing.assert_close(out3, out1, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the grouping against the JAX loop, on stand-in runtimes

class _PortStandIn:
    """What the port's optimize_embedding calls of a Runtime, recording
    each step's kind."""

    def __init__(self, cfg, log):
        self.cfg, self.log, self.device = cfg, log, torch.device("cpu")
        self.mesh = make_mesh(-1, device="cpu")  # one process, as the JAX stand-in's

    def train_context(self, context=None):
        return torch.zeros((1, 2, 3), requires_grad=True)

    def optimizer(self, context):
        return torch.optim.Adam([context], lr=1e-3)

    def _aux(self, *shape):
        return {n: torch.zeros(shape) for n in ("loss", "sharpening", "equivariance")}

    def train_step_fill(self, context, opt, images, **_):
        self.log.append("fill")
        return context, opt, self._aux(), torch.zeros((len(images), 1, 1, 4))

    def train_step_cached(self, context, opt, latents, images, **_):
        self.log.append("cached")
        return context, opt, self._aux()

    def train_step(self, context, opt, images, **_):
        self.log.append("plain")
        return context, opt, self._aux()

    def train_step_scan(self, context, opt, latents, images, **_):
        self.log.append(f"group{len(latents)}")
        return context, opt, self._aux(len(latents))


class _SavedSteps:
    def __init__(self):
        self.steps = []

    def restore(self):
        return None

    def save(self, step, *_):
        self.steps.append(int(step))


def _jax_loop(cfg_kw, length, folder):
    import jax.numpy as jnp
    import optax

    from stablekeypoints_tpu.config import Config as JaxConfig
    from stablekeypoints_tpu.data.synthetic import SyntheticBlobs as JaxBlobs
    from stablekeypoints_tpu.parallel import mesh as pmesh
    from stablekeypoints_tpu.pipeline.optimize import optimize_embedding as jax_optimize

    log = []

    class StandIn:
        cfg = JaxConfig(**cfg_kw, save_folder=str(folder))
        mesh = pmesh.make_mesh(1)
        optimizer = optax.adam(1e-3)

        @staticmethod
        def init_context():
            return jnp.zeros((1, 2, 3))

        @staticmethod
        def _metrics(*shape):
            return {n: jnp.zeros(shape) for n in ("loss", "sharpening", "equivariance")}

        def train_step_fill(self, context, opt_state, images, key):
            log.append("fill")
            return context, opt_state, key, self._metrics(), np.zeros((len(images), 1, 1, 4))

        def train_step_cached(self, context, opt_state, latents, images, key):
            log.append("cached")
            return context, opt_state, key, self._metrics()

        def train_step(self, context, opt_state, images, key):
            log.append("plain")
            return context, opt_state, key, self._metrics()

        def train_step_scan(self, context, opt_state, latents, images, key):
            log.append(f"group{len(latents)}")
            return context, opt_state, key, self._metrics(len(latents))

    saved = _SavedSteps()
    jax_optimize(StandIn(), JaxBlobs(length=length, image_size=8), checkpointer=saved)
    return log, saved.steps


@pytest.mark.parametrize("num_steps,checkpoint_every,steps_per_call,length,extra", [
    (8, 0, 3, 4, {}),        # two groups after the fill epoch
    (9, 0, 4, 4, {}),        # a group, then a tail too short for one
    (10, 3, 3, 4, {}),       # boundaries at 3, 6, 9: only groups that end on one
    (12, 4, 4, 4, {}),       # a group ending on 4 is saved after it; 8 inside the next
    (10, 2, 3, 6, {}),       # a boundary inside every group: all per step
    (8, 0, 2, 6, {"latent_cache_entries": 2}),  # a capped cache: a batch misses for ever
    (6, 0, 2, 4, {"cache_latents": False}),     # no cache: no group
    (7, 3, 1, 4, {}),        # steps_per_call 1: per step
])
def test_grouping_and_checkpoints_equal_jax(tmp_path, num_steps, checkpoint_every,
                                            steps_per_call, length, extra):
    kw = dict(num_steps=num_steps, checkpoint_every=checkpoint_every,
              steps_per_call=steps_per_call, batch_size=2, image_size=8, log_every=1, **extra)
    want_log, want_saved = _jax_loop(kw, length, tmp_path / "jax")
    log, saved = [], _SavedSteps()
    port = _PortStandIn(Config(**kw, save_folder=str(tmp_path / "port")), log)
    optimize_embedding(port, SyntheticBlobs(length=length, image_size=8), checkpointer=saved,
                       generator=torch.Generator().manual_seed(0))
    assert log == want_log
    assert saved.steps == want_saved
    grouped = sum(int(e[5:]) for e in log if e.startswith("group"))
    assert grouped + sum(not e.startswith("group") for e in log) == num_steps


def test_resume_after_a_group(tmp_path):
    """steps_per_call 2, checkpoint every 3, 4 steps: fills at 0-1, a group
    of steps 2-3 saved at 3 with Adam's count 4; the resumed 8-step run
    starts at 4 and ends with the count 8."""
    data = SyntheticBlobs(length=4, image_size=64)

    def run(num_steps):
        rt = _runtime(num_steps=num_steps, steps_per_call=2, checkpoint_every=3, log_every=1,
                      save_folder=str(tmp_path))
        opts, seen = [], []
        make = rt.optimizer
        rt.optimizer = lambda ctx: opts.append(make(ctx)) or opts[-1]
        _recording(rt, seen)
        logger = MetricsLogger(str(tmp_path))
        out = optimize_embedding(rt, data, logger, checkpointer=TrainCheckpointer(str(tmp_path)))
        logger.close()
        return out, opts[0], [n for n, _ in seen]

    _, opt, kinds = run(4)
    assert kinds == ["train_step_fill"] * 2 + ["train_step_scan"] * 2
    ckpt = TrainCheckpointer(str(tmp_path))
    assert ckpt.latest_step() == 3
    saved = ckpt.restore(3)
    assert float(saved["optimizer"]["state"][0]["step"]) == 4
    torch.testing.assert_close(saved["context"], opt.param_groups[0]["params"][0].detach(),
                               rtol=0, atol=0)
    (tmp_path / "metrics.jsonl").unlink()

    out, opt, kinds = run(8)
    records = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert records[0]["event"] == "resumed" and records[0]["step"] == 4
    assert [r["step"] for r in records if "loss" in r] == [4, 5, 6, 7]
    # the cache starts empty after a resume: fills at 4-5; 6 is a boundary
    # strictly inside the group 6-7, so both run one at a time
    assert kinds == ["train_step_fill"] * 2 + ["train_step_cached"] * 2
    assert float(opt.state_dict()["state"][0]["step"]) == 8
    assert ckpt.latest_step() == 6 and torch.isfinite(out).all()
