"""Loading a diffusers checkpoint directory: the port vs the JAX package.

No real checkpoint is needed: both packages fabricate random tensors in
the exact diffusers layout (`fabricate_checkpoint`). Every comparison here
is exact: the conversion is a rename (diffusers and the port both store
convs OIHW and linears [out, in]; the JAX tree transposes, and
`from_jax_params` transposes back), and fp32 files load into fp32
parameters. In bf16 the port casts with round-to-nearest-even (torch's
cast, the same as `tensor.to(torch.bfloat16)`); the JAX package truncates
(its `cast_params`), so bf16 runtimes are held to the file's torch cast.
"""

import torch_threads  # noqa: F401  (torch's threads: this xdist worker's share)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablekeypoints_tpu.config import Config as JaxConfig
from stablekeypoints_tpu.models import weights as jw
from stablekeypoints_tpu.models.unet import SD15_CONFIG as JAX_SD15
from stablekeypoints_tpu.models.unet import tiny_unet_config as jax_tiny_unet
from stablekeypoints_tpu.models.vae import SD_VAE_CONFIG as JAX_SD_VAE
from stablekeypoints_tpu.models.vae import tiny_vae_config as jax_tiny_vae
from stablekeypoints_tpu.parallel import mesh as pmesh
from stablekeypoints_tpu.pipeline.runtime import Runtime as JaxRuntime
from stablekeypoints_tpu_torch.config import Config
from stablekeypoints_tpu_torch.models import weights as tw
from stablekeypoints_tpu_torch.models.unet import SD15_CONFIG, UNet, tiny_unet_config
from stablekeypoints_tpu_torch.models.vae import SD_VAE_CONFIG, VAE, tiny_vae_config
from stablekeypoints_tpu_torch.pipeline.runtime import Runtime

TINY = dict(image_size=64, num_tokens=16, feature_upsample_res=16, top_k=4)


def _assert_state_equal(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_runtime_from_jax_checkpoint_equals_jax_runtime(tmp_path, fmt):
    """JAX fabricate_checkpoint -> JAX Runtime.create(model_path) and the
    port's Runtime.create(model_path, device="cpu"): the port's state is
    `from_jax_params` of the JAX trees, bitwise (fp32)."""
    d = jw.fabricate_checkpoint(str(tmp_path / "ck"), jax_tiny_unet(), jax_tiny_vae(), seed=3,
                                fmt=fmt)
    jrt = JaxRuntime.create(JaxConfig(jax_cache_dir="", model_path=d, dtype="float32", **TINY),
                            jax_tiny_unet(), jax_tiny_vae(), mesh=pmesh.make_mesh(1))
    want_unet, want_vae = tw.from_jax_params(jax.device_get(jrt.unet_params),
                                             jax.device_get(jrt.vae_params))
    rt = Runtime.create(Config(model_path=d, dtype="float32", **TINY), tiny_unet_config(),
                        tiny_vae_config(), device="cpu")
    _assert_state_equal(rt.unet.state_dict(), want_unet)
    _assert_state_equal(rt.vae.state_dict(), want_vae)
    assert any(k.startswith("decoder.") for k in want_vae)


def test_port_checkpoint_loads_through_jax(tmp_path):
    """The port's fabricate_checkpoint writes what the JAX loader reads: the
    JAX trees (every leaf populated) equal the port's load, renamed."""
    d = tw.fabricate_checkpoint(str(tmp_path / "ck"), tiny_unet_config(), tiny_vae_config(),
                                seed=4)
    unet = jw.load_unet_params(d, jax_tiny_unet(), jnp.float32)
    vae = jw.load_vae_params(d, jax_tiny_vae(), jnp.float32)
    want_unet, want_vae = tw.from_jax_params(unet, vae)
    _assert_state_equal(tw.load_unet_state(d, tiny_unet_config()), want_unet)
    _assert_state_equal(tw.load_vae_state(d, tiny_vae_config()), want_vae)
    with torch.device("meta"):
        assert sorted(want_unet) == sorted(UNet(tiny_unet_config()).state_dict())
        assert sorted(want_vae) == sorted(VAE(tiny_vae_config()).state_dict())


def _jax_name(dst: str) -> str:
    """A JAX conversion rule's parameter path in the port's names."""
    head, leaf = dst.rsplit(".", 1)
    return f"{head}.{'weight' if leaf in ('kernel', 'scale') else leaf}"


@pytest.mark.parametrize("part", ["unet", "vae"])
def test_full_width_rules_equal_jax_rules(part):
    """At SD-1.5's full width, the port's rules are the JAX package's (the
    same diffusers names onto the same parameters), and they name every
    parameter of the port's modules."""
    if part == "unet":
        ours, theirs = tw.unet_conversion_rules(SD15_CONFIG), jw.unet_conversion_rules(JAX_SD15)
        module = UNet
        config = SD15_CONFIG
    else:
        ours, theirs = tw.vae_conversion_rules(SD_VAE_CONFIG), jw.vae_conversion_rules(JAX_SD_VAE)
        module = VAE
        config = SD_VAE_CONFIG
    assert sorted(ours) == sorted((s, _jax_name(d)) for s, d, _ in theirs)
    with torch.device("meta"):
        names = set(module(config).state_dict())
    covered = [d for _, d in ours if d in names]
    assert sorted(covered) == sorted(names)  # each parameter exactly once


def test_bf16_runtime_is_the_files_cast(tmp_path):
    """An fp16 safetensors UNet and an fp32 .bin VAE under diffusers-0.8
    attention names, loaded into a bf16 runtime: every matmul/conv weight is
    the file's tensor cast to bf16, every norm parameter its fp32 cast."""
    d = tw.fabricate_checkpoint(str(tmp_path / "ck"), tiny_unet_config(), tiny_vae_config(),
                                seed=5, dtype=torch.float16, vae_fmt="bin",
                                vae_dtype=torch.float32, legacy_vae_names=True)
    files = {"unet": tw.read_state_dict(str(tmp_path / "ck" / "unet")),
             "vae": tw.read_state_dict(str(tmp_path / "ck" / "vae"))}
    assert {t.dtype for t in files["unet"].values()} == {torch.float16}
    assert any(".query." in k for k in files["vae"])
    rt = Runtime.create(Config(model_path=d, **TINY), tiny_unet_config(), tiny_vae_config(),
                        device="cpu")
    rules = {"unet": tw.unet_conversion_rules(tiny_unet_config()),
             "vae": [(tw._legacy_vae_name(s), t) for s, t in
                     tw.vae_conversion_rules(tiny_vae_config())]}
    for part, module in (("unet", rt.unet), ("vae", rt.vae)):
        params = dict(module.named_parameters())
        for src, dst in rules[part]:
            if dst not in params:
                continue
            p = params[dst]
            assert p.dtype == (torch.float32 if tw.is_norm_param(dst) else torch.bfloat16), dst
            assert torch.equal(p, files[part][src].to(p.dtype)), dst


@pytest.mark.parametrize("dtype", ["F32", "F16"])
def test_safetensors_reader_equals_library(tmp_path, dtype):
    """The port's reader against `safetensors.numpy.load_file`, and its
    writer read back by the library (0-d, empty and odd-sized tensors
    included)."""
    from safetensors.numpy import load_file, save_file

    np_dtype = {"F32": np.float32, "F16": np.float16}[dtype]
    rng = np.random.default_rng(0)
    arrays = {"a.weight": rng.standard_normal((3, 5, 1, 1)), "b": rng.standard_normal(7),
              "scalar": np.array(2.5), "empty": np.zeros((0, 4)),
              "c.bias": rng.standard_normal((2, 3, 4))}
    arrays = {k: v.astype(np_dtype) for k, v in arrays.items()}
    path = str(tmp_path / "lib.safetensors")
    save_file(arrays, path)
    got = tw.load_safetensors(path)
    want = load_file(path)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
        assert got[k].numpy().dtype == want[k].dtype
    ours = str(tmp_path / "ours.safetensors")
    tw.save_safetensors({k: torch.from_numpy(v) for k, v in arrays.items()}, ours)
    back = load_file(ours)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v)


def test_safetensors_bf16_round_trip(tmp_path):
    """BF16 (which numpy has no type for) through the port's writer and
    reader, and read by the library's torch loader."""
    from safetensors.torch import load_file

    gen = torch.Generator().manual_seed(0)
    tensors = {"w": torch.randn((4, 6), generator=gen).to(torch.bfloat16),
               "v": torch.randn(5, generator=gen).to(torch.bfloat16),
               "f": torch.randn(3, generator=gen)}
    path = str(tmp_path / "bf16.safetensors")
    tw.save_safetensors(tensors, path)
    for loaded in (tw.load_safetensors(path), load_file(path)):
        for k, v in tensors.items():
            assert loaded[k].dtype == v.dtype and torch.equal(loaded[k], v), k


def test_legacy_vae_names_load_equal(tmp_path):
    """diffusers-0.8 VAE attention names (query/key/value/proj_attn) load
    to the same state as the current ones."""
    new = tw.fabricate_checkpoint(str(tmp_path / "new"), tiny_unet_config(), tiny_vae_config(),
                                  seed=6)
    old = tw.fabricate_checkpoint(str(tmp_path / "old"), tiny_unet_config(), tiny_vae_config(),
                                  seed=6, legacy_vae_names=True)
    assert any(".proj_attn." in k for k in tw.read_state_dict(str(tmp_path / "old" / "vae")))
    _assert_state_equal(tw.load_vae_state(old, tiny_vae_config()),
                        tw.load_vae_state(new, tiny_vae_config()))


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_strict_load_raises(tmp_path, fault):
    """A parameter the files lack, a tensor no rule names, or a wrong shape
    raises (the JAX loader skips the first two)."""
    d = tw.fabricate_checkpoint(str(tmp_path / "ck"), tiny_unet_config(), tiny_vae_config(),
                                seed=7)
    sd = tw.read_state_dict(str(tmp_path / "ck" / "unet"))
    sd = {k: v.clone() for k, v in sd.items()}
    if fault == "missing":
        del sd["mid_block.attentions.0.proj_out.bias"]
    elif fault == "extra":
        sd["down_blocks.0.resnets.0.conv_shortcut.weight"] = torch.zeros(32, 32, 1, 1)
    else:
        sd["conv_in.bias"] = torch.zeros(33)
    tw.save_safetensors(sd, str(tmp_path / "ck" / "unet" / "diffusion_pytorch_model.safetensors"))
    match = {"missing": "missing", "extra": "no conversion rule", "shape": "shape"}[fault]
    with pytest.raises(ValueError if fault == "shape" else KeyError, match=match):
        tw.load_unet_state(d, tiny_unet_config())
    with pytest.raises((KeyError, ValueError)):
        Runtime.create(Config(model_path=d, **TINY), tiny_unet_config(), tiny_vae_config(),
                       device="cpu")


def test_copy_state_is_strict():
    cfg = tiny_vae_config()
    vae = VAE(cfg)
    state = {k: v.clone() for k, v in vae.state_dict().items()}
    tw.copy_state(vae, state)
    with pytest.raises(KeyError, match="missing"):
        tw.copy_state(vae, {k: v for k, v in state.items() if not k.startswith("decoder.")})
    bad = dict(state, **{"decoder.conv_out.bias": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape"):
        tw.copy_state(vae, bad)
