"""The port's CLI surface vs the JAX package's `main.py`.

`build_parser` has every option string, dest, choice, default, nargs and
type of JAX's (help texts differ: they say what the port does), and
`config_from_args` gives the JAX config's value in every field, for the
default argv and for override argv, dataset presets included.
`python -m stablekeypoints_tpu_torch.main` without `--device` raises on a
machine with no card.
"""

import torch_threads  # noqa: F401  (torch's threads: this xdist worker's share)
import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from stablekeypoints_tpu import main as jax_main
from stablekeypoints_tpu_torch import main as cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_parser_equal_jax():
    ours, theirs = _actions(cli.build_parser()), _actions(jax_main.build_parser())
    assert ours.keys() == theirs.keys()
    for dest, a in ours.items():
        b = theirs[dest]
        for attr in ("option_strings", "default", "choices", "nargs", "type", "const"):
            assert getattr(a, attr) == getattr(b, attr), (dest, attr)
        assert type(a) is type(b), dest


ARGVS = {
    "default": [],
    "celeba": ["--dataset_name", "celeba_aligned"],
    "overrides": ["--num_tokens", "100", "--layers", "0", "1", "--dtype", "float32",
                  "--augment_scale", "0.7", "0.9", "--no_cache_latents", "--no_truncate_unet",
                  "--resume", "--checkpoint_every", "5", "--seed", "3", "--device", "cpu",
                  "--fused_gn_conv", "off", "--max_loc_strategy", "weighted_avg"],
    "preset": ["--dataset_name", "deepfashion"],  # pck, 10k steps
    "preset_overridden": ["--dataset_name", "cub_001", "--num_steps", "42",
                          "--evaluation_method", "pck"],
    "human36m": ["--dataset_name", "human3.6m", "--validation", "--eval_batch_images", "8"],
}


@pytest.mark.parametrize("name", list(ARGVS))
def test_config_from_args_equal_jax(name):
    argv = ARGVS[name]
    ours = cli.config_from_args(cli.build_parser().parse_args(argv))
    theirs = jax_main.config_from_args(jax_main.build_parser().parse_args(argv))
    ours, theirs = dataclasses.asdict(ours), dataclasses.asdict(theirs)
    assert ours.keys() == theirs.keys()
    for field, value in ours.items():
        assert value == theirs[field] and type(value) is type(theirs[field]), field


def test_presets_fill_untouched_fields():
    cfg = cli.config_from_args(cli.build_parser().parse_args(ARGVS["preset_overridden"]))
    assert cfg.num_steps == 42 and cfg.evaluation_method == "pck"
    cfg = cli.config_from_args(cli.build_parser().parse_args(["--dataset_name", "taichi"]))
    assert cfg.num_steps == 10_000 and cfg.evaluation_method == "mean_average_error"


def test_bad_dataset_name_is_an_argparse_error():
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--dataset_name", "imagenet"])


def test_visualize_raises_before_any_stage(tmp_path, monkeypatch):
    """--visualize without matplotlib fails before stage 1, not after it."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    args = cli.build_parser().parse_args(["--visualize", "--save_folder", str(tmp_path / "out"),
                                          "--device", "cpu"])
    with pytest.raises(ImportError):
        cli.run(cli.config_from_args(args), device=args.device)
    assert not (tmp_path / "out").exists()


def test_module_without_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run(
        [sys.executable, "-m", "stablekeypoints_tpu_torch.main", "--dataset_name", "custom",
         "--dataset_loc", str(tmp_path), "--save_folder", str(tmp_path / "out")],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
