"""SD-2.x and SDXL models, checkpoints and CLI in the port against the JAX
package, on the CPU in fp32 (the Runtime slices are in
test_torch_backbones_slice.py).

Both packages' tiny SD-2.x topology (4 blocks, fixed 16-dim heads, linear
projections, a 48-dim context) and tiny SDXL topology (3 blocks, depths
(1, 2, 2), micro-conditioning) carry the same parameters (JAX's, through
`from_jax_params`) and see the same inputs: the UNet forward and its
captures, the micro-conditioning, the capture rule at SDXL's 1024^2- and
512^2-like shapes; fabricated diffusers checkpoints of both families
through both loaders (bitwise); `--model_type` through the CLI.

Tolerances are those of test_torch_models.py: captures rtol 5e-5 / atol
5e-6 (softmax head-means of O(10) logits), eps 1e-5 absolute.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablekeypoints_tpu.config import Config as JaxConfig
from stablekeypoints_tpu.models import unet as junet
from stablekeypoints_tpu.models import weights as jw
from stablekeypoints_tpu.models.vae import tiny_vae_config as jax_tiny_vae
from stablekeypoints_tpu.parallel import mesh as pmesh
from stablekeypoints_tpu.pipeline.runtime import Runtime as JaxRuntime
from stablekeypoints_tpu_torch import main as cli
from stablekeypoints_tpu_torch.api import KeypointModel
from stablekeypoints_tpu_torch.config import Config
from stablekeypoints_tpu_torch.models import unet as tunet
from stablekeypoints_tpu_torch.models import weights as tw
from stablekeypoints_tpu_torch.models.vae import tiny_vae_config
from stablekeypoints_tpu_torch.pipeline import runtime as truntime
from stablekeypoints_tpu_torch.pipeline.runtime import Runtime

MODEL_TYPE = {"sd21": "stabilityai/stable-diffusion-2-1-base",
              "sdxl": "stabilityai/stable-diffusion-xl-base-1.0"}
SIZE = dict(image_size=64, num_tokens=16, feature_upsample_res=16, top_k=4, dtype="float32")
CTX_DIM = 48  # both tiny topologies


def _tiny(family, linear_projection=None):
    cfgs = getattr(junet, f"{family}_tiny_config")(), getattr(tunet, f"{family}_tiny_config")()
    if linear_projection is None:
        return cfgs
    return tuple(dataclasses.replace(c, linear_projection=linear_projection) for c in cfgs)


def _fields_equal(got, want):
    names = [f.name for f in dataclasses.fields(got)]
    assert {f: getattr(got, f) for f in names} == {f: getattr(want, f) for f in names}


@pytest.mark.parametrize("name", ["SD21_CONFIG", "SDXL_CONFIG", "sd21_tiny_config",
                                  "sdxl_tiny_config"])
def test_configs_equal_jax(name):
    """The port's configurations carry the JAX package's fields (its TPU
    knobs aside)."""
    got, want = getattr(tunet, name), getattr(junet, name)
    _fields_equal(got() if callable(got) else got, want() if callable(want) else want)
    if name == "SDXL_CONFIG":
        assert got.heads_for(1280) == (20, 64) and got.heads_for(640) == (10, 64)
    if name == "SD21_CONFIG":
        assert [got.heads_for(c) for c in (320, 640, 1280)] == [(5, 64), (10, 64), (20, 64)]


@functools.lru_cache(maxsize=None)
def _models(family, capture_max_seq=None):
    """(JAX config, JAX params, the port's UNet with those params)."""
    jcfg, tcfg = _tiny(family)
    if capture_max_seq is not None:
        jcfg = dataclasses.replace(jcfg, capture_max_seq=capture_max_seq)
        tcfg = dataclasses.replace(tcfg, capture_max_seq=capture_max_seq)
    params = jw.init_unet_params_fast(0, jcfg, 16)
    unet = tunet.UNet(tcfg)
    tw.copy_state(unet, tw.from_jax_params(params, {})[0])
    return jcfg, params, tw.cast_module(unet, torch.float32).eval()


def _inputs(seed, hw):
    rng = np.random.default_rng(seed)
    noisy = rng.standard_normal((2, hw, hw, 4)).astype(np.float32)
    ts = np.array([1, 700], np.int32)
    ctx = (30 * rng.standard_normal((2, 10, CTX_DIM))).astype(np.float32)
    return noisy, ts, ctx


def _forward_both(family, hw, capture_res, truncate, added=None, capture_max_seq=None, seed=0):
    jcfg, params, unet = _models(family, capture_max_seq)
    noisy, ts, ctx = _inputs(seed, hw)
    jmodel = junet.UNet(jcfg, dtype=jnp.float32)
    jadded = None if added is None else {k: jnp.asarray(v) for k, v in added.items()}
    want = jax.jit(lambda p, x, t, c, a: jmodel.apply(
        {"params": p}, x, t, c, capture_res=capture_res, truncate=truncate, added_cond=a
    ))(params, noisy, ts, ctx, jadded)
    tadded = None if added is None else {k: torch.from_numpy(v) for k, v in added.items()}
    with torch.no_grad():
        got = unet(torch.from_numpy(noisy), torch.from_numpy(ts), torch.from_numpy(ctx),
                   capture_res=capture_res, truncate=truncate, added_cond=tadded)
    return got, want


def _assert_forward_close(got, want):
    (eps_t, cap_t), (eps_j, cap_j) = got, want
    assert len(cap_t) == len(cap_j)
    for a, b in zip(cap_j, cap_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=5e-5, atol=5e-6)
    assert (eps_t is None) == (eps_j is None)
    if eps_t is not None:
        np.testing.assert_allclose(eps_t.numpy(), np.asarray(eps_j), atol=1e-5)


@pytest.mark.parametrize("family,truncate", [("sd21", True), ("sd21", False), ("sdxl", False)])
def test_unet_forward_and_captures_match_jax(family, truncate):
    """512^2-like shapes (8^2 latents, 16^2 capture): 4 maps, the forward
    truncated after the fourth when asked. SDXL with text_embeds and
    time_ids given: the micro-conditioning moves eps (against the port's
    own forward with the zeros default), and both packages agree."""
    added = None
    if family == "sdxl":
        rng = np.random.default_rng(3)
        added = {"text_embeds": rng.standard_normal((2, 32)).astype(np.float32),
                 "time_ids": np.array([[64, 64, 0, 0, 64, 64], [96, 80, 8, 4, 64, 64]],
                                      np.float32)}
    got, want = _forward_both(family, 8, 16, truncate, added)
    assert len(got[1]) == 4 and all(c.shape == (2, 256, 10) for c in got[1])
    assert (got[0] is None) == truncate
    _assert_forward_close(got, want)
    if added is not None:
        unet = _models(family)[2]
        noisy, ts, ctx = _inputs(0, 8)
        with torch.no_grad():
            plain = unet(*map(torch.from_numpy, (noisy, ts, ctx)))[0]
        assert np.abs(got[0].numpy() - plain.numpy()).max() > 1e-6


@pytest.mark.parametrize("hw,cap_seq,maps,truncated", [
    (16, 16, 3, False),  # SDXL 1024^2: only the deepest up block's 3 stacks, eps produced
    (32, None, 4, True),  # SDXL 512^2: 3 stacks, then the next block's first: truncated
])
def test_sdxl_capture_rule_matches_jax(hw, cap_seq, maps, truncated):
    """JAX tests/test_sdxl.py's capture rule at the tiny topology, the seq
    cap scaled with the latents as there."""
    got, want = _forward_both("sdxl", hw, 8, True, capture_max_seq=cap_seq)
    assert len(got[1]) == maps and (got[0] is None) == truncated
    assert all(c.shape == (2, 64, 10) for c in got[1])
    _assert_forward_close(got, want)


def _assert_state_equal(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name


@pytest.mark.parametrize("family", ["sd21", "sdxl"])
def test_jax_fabricated_checkpoint_loads_equal(tmp_path, family):
    """A diffusers directory of the family written by the JAX package
    (linear proj_in / proj_out, SDXL's add_embedding) -> the port's
    Runtime.create(model_path): its state is `from_jax_params` of the JAX
    Runtime's trees, bitwise. The tiny SDXL topology is given linear
    projections, as JAX tests/test_sdxl.py does."""
    jcfg, tcfg = _tiny(family, linear_projection=True)
    d = jw.fabricate_checkpoint(str(tmp_path / "ck"), jcfg, jax_tiny_vae(), seed=3)
    sd = tw.read_state_dict(str(tmp_path / "ck" / "unet"))
    assert sd["mid_block.attentions.0.proj_in.weight"].dim() == 2  # stored as a linear
    assert ("add_embedding.linear_1.weight" in sd) == (family == "sdxl")
    kw = dict(SIZE, model_type=MODEL_TYPE[family], model_path=d)
    jrt = JaxRuntime.create(JaxConfig(jax_cache_dir="", **kw), jcfg, jax_tiny_vae(),
                            mesh=pmesh.make_mesh(1))
    want_unet, want_vae = tw.from_jax_params(jax.device_get(jrt.unet_params),
                                             jax.device_get(jrt.vae_params))
    rt = Runtime.create(Config(**kw), tcfg, tiny_vae_config(), device="cpu")
    _assert_state_equal(rt.unet.state_dict(), want_unet)
    _assert_state_equal(rt.vae.state_dict(), want_vae)


@pytest.mark.parametrize("family", ["sd21", "sdxl"])
def test_port_fabricated_checkpoint_loads_through_jax(tmp_path, family):
    """The port's fabricate_checkpoint writes what the JAX loader reads (its
    dense1x1 rule for the projections): the JAX trees equal the port's
    load, and every port parameter is named."""
    jcfg, tcfg = _tiny(family, linear_projection=True)
    d = tw.fabricate_checkpoint(str(tmp_path / "ck"), tcfg, tiny_vae_config(), seed=4)
    want_unet, _ = tw.from_jax_params(jw.load_unet_params(d, jcfg, jnp.float32), {})
    got = tw.load_unet_state(d, tcfg)
    _assert_state_equal(got, want_unet)
    with torch.device("meta"):
        assert sorted(got) == sorted(tunet.UNet(tcfg).state_dict())
    assert len(tw.linear_projection_params(tcfg)) == 2 * sum(
        1 for k in got if k.endswith(".proj_in.weight") and ".ff." not in k)


@pytest.mark.parametrize("fault", ["conv_layout", "wrong_width", "sd15_linear"])
def test_projection_loads_only_the_linear_reshape(tmp_path, fault):
    """A linear-projection checkpoint's proj_in must be exactly [out, in]:
    the 1x1 conv layout [out, in, 1, 1] or another width raises; an SD-1.x
    topology (no linear projections) refuses a 2-D proj_in."""
    tcfg = tunet.sd21_tiny_config() if fault != "sd15_linear" else tunet.tiny_unet_config()
    d = tw.fabricate_checkpoint(str(tmp_path / "ck"), tcfg, tiny_vae_config(), seed=5)
    path = str(tmp_path / "ck" / "unet")
    sd = {k: v.clone() for k, v in tw.read_state_dict(path).items()}
    name = "down_blocks.1.attentions.0.proj_in.weight"
    w = sd[name]
    sd[name] = {"conv_layout": lambda: w[:, :, None, None],
                "wrong_width": lambda: torch.zeros(w.shape[0], w.shape[1] + 1),
                "sd15_linear": lambda: w[:, :, 0, 0]}[fault]()
    tw.save_safetensors(sd, f"{path}/diffusion_pytorch_model.safetensors")
    with pytest.raises(ValueError, match="shape"):
        tw.load_unet_state(d, tcfg)


def test_keypoint_model_save_load_round_trips_sdxl(tmp_path):
    """An SDXL model's 48-dim context and indices through save / load, and
    the loaded model detects as the saved one."""
    rt = Runtime.create(Config(**SIZE, model_type=MODEL_TYPE["sdxl"], augmentation_iterations=2),
                        tunet.sdxl_tiny_config(), tiny_vae_config(), device="cpu")
    model = KeypointModel(rt, rt.init_context().numpy(), np.array([1, 5, 2, 9]))
    model.save(str(tmp_path))
    loaded = KeypointModel.load(str(tmp_path), rt.cfg, runtime=rt)
    np.testing.assert_array_equal(loaded.context, model.context)
    assert loaded.context.shape == (1, 16, CTX_DIM)
    img = np.random.default_rng(0).uniform(0, 1, (64, 64, 3)).astype(np.float32)
    gen = lambda: torch.Generator().manual_seed(1)  # noqa: E731
    np.testing.assert_array_equal(loaded.detect(img, gen()), model.detect(img, gen()))


def test_cli_model_type_reaches_the_sdxl_backbone(tmp_path, monkeypatch):
    """`--model_type stabilityai/stable-diffusion-xl-base-1.0` through
    main.main picks the SDXL UNet and VAE configurations (swapped here for
    their tiny twins) and runs stages 1 and 2 on an image folder."""
    from PIL import Image

    data = tmp_path / "imgs"
    data.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)).save(data / f"{i}.png")
    picked = []
    tiny_vae = dataclasses.replace(tiny_vae_config(), scaling_factor=0.13025)
    monkeypatch.setattr(truntime, "SDXL_CONFIG", tunet.sdxl_tiny_config())
    monkeypatch.setattr(truntime, "SDXL_VAE_CONFIG", tiny_vae)
    real = truntime.Runtime.create

    def create(cfg, unet_config=None, vae_config=None, device=None):
        rt = real(cfg, unet_config, vae_config, device=device)
        picked.append((rt.unet.config.addition_emb_dim, rt.vae.config.scaling_factor))
        return rt

    monkeypatch.setattr(cli.Runtime, "create", staticmethod(create))
    results = cli.main(["--dataset_name", "custom", "--dataset_loc", str(data),
                        "--save_folder", str(tmp_path / "out"), "--model_type",
                        MODEL_TYPE["sdxl"], "--image_size", "64", "--num_tokens", "16",
                        "--feature_upsample_res", "16", "--batch_size", "2", "--num_steps", "1",
                        "--num_indices", "2", "--furthest_point_num_samples", "8",
                        "--top_k", "4", "--dtype", "float32", "--device", "cpu"])
    assert picked == [(32, 0.13025)]
    assert results["embedding"].shape == (1, 16, CTX_DIM) and len(results["indices"]) == 4
