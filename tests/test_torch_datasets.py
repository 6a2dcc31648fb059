"""The port's dataset adapters vs the JAX package's, on on-disk fixtures in
the reference's file layouts (CelebA, CUB aligned and DeepFashion from
tests/test_datasets.py's builders; the rest built here).

For every adapter and split: equal lengths, and `img`, `kpts` and
`visibility` bitwise equal sample by sample (the same decoders and numpy
arithmetic on both sides). The train splits of `cub_parts`, `taichi` and
unaligned Human3.6M draw jitter, mirrors and crops from a seeded numpy
generator: read in the same order, both sides draw the same values.
"""

import torch_threads  # noqa: F401  (torch's threads: this xdist worker's share)
import json
import os

import numpy as np
import pytest
from PIL import Image
from test_datasets import celeba_root, cub_root, deepfashion_root  # noqa: F401 (fixtures)

from stablekeypoints_tpu.config import Config as JaxConfig
from stablekeypoints_tpu.data import base as jbase
from stablekeypoints_tpu.data.registry import DATASET_NAMES as JAX_DATASET_NAMES
from stablekeypoints_tpu.data.registry import build_dataset as jax_build_dataset
from stablekeypoints_tpu_torch.config import Config
from stablekeypoints_tpu_torch.data import base
from stablekeypoints_tpu_torch.data.registry import DATASET_NAMES, build_dataset

SPLITS = ("train", "train_reg", "test")


def _rgb(path, w, h, seed):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    arr = np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    Image.fromarray(arr).save(path)


def _assert_same_adapter(name, root, image_size=32, reads=2, **cfg_kw):
    """Every split of dataset `name`: lengths equal and `reads` passes over
    the samples equal key by key (a second pass draws the generators on)."""
    kw = dict(dataset_name=name, dataset_loc=root, image_size=image_size, **cfg_kw)
    for split in SPLITS:
        ours, theirs = build_dataset(Config(**kw), split), jax_build_dataset(JaxConfig(**kw), split)
        assert len(ours) == len(theirs) > 0, (name, split)
        assert base.is_deterministic(ours) == jbase.is_deterministic(theirs)
        for _ in range(reads):
            for i in range(len(ours)):
                a, b = ours[i], theirs[i]
                assert a.keys() == b.keys(), (name, split)
                for key in ("img", "kpts", "visibility"):
                    np.testing.assert_array_equal(a[key], b[key], err_msg=f"{name} {split} {i} {key}")
                    assert a[key].dtype == b[key].dtype, (name, split, key)


def test_dataset_names_equal_jax():
    assert DATASET_NAMES == JAX_DATASET_NAMES


@pytest.mark.parametrize("max_len", [-1, 2])
def test_celeba_aligned_equal_jax(celeba_root, max_len):  # noqa: F811
    _assert_same_adapter("celeba_aligned", celeba_root, max_len=max_len)


@pytest.fixture(scope="module")
def celeba_wild_root(tmp_path_factory):
    """In-the-wild layout: jpgs of several sizes and a bbox file; image 3's
    face box is under the 30% area threshold, so both sides drop it."""
    root = tmp_path_factory.mktemp("celeba_wild")
    os.makedirs(root / "Anno")
    os.makedirs(root / "MAFL")
    n, sizes = 6, [(64, 48), (40, 40), (56, 72), (64, 64), (48, 32), (60, 44)]
    with open(root / "Anno" / "list_landmarks_celeba.txt", "w") as f:
        f.write(f"{n}\nheader\n")
        for i in range(n):
            f.write(f"{i + 1:06d}.jpg " + " ".join(str(5 + 3 * j + i) for j in range(10)) + "\n")
    with open(root / "Anno" / "list_bbox_celeba.txt", "w") as f:
        f.write(f"{n}\nimage_id x_1 y_1 width height\n")
        for i, (w, h) in enumerate(sizes):
            bw, bh = (w // 4, h // 4) if i == 3 else (w - 4, h - 4)
            f.write(f"{i + 1:06d}.jpg 2 2 {bw} {bh}\n")
    with open(root / "MAFL" / "training.txt", "w") as f:
        f.write("".join(f"{i + 1:06d}.jpg\n" for i in range(4)))
    with open(root / "MAFL" / "testing.txt", "w") as f:
        f.write("".join(f"{i + 1:06d}.jpg\n" for i in range(4, 6)))
    for i, (w, h) in enumerate(sizes):
        _rgb(str(root / "Img" / "img_celeba" / f"{i + 1:06d}.jpg"), w, h, i)
    return str(root)


def test_celeba_wild_equal_jax(celeba_wild_root):
    _assert_same_adapter("celeba_wild", celeba_wild_root)
    assert len(build_dataset(Config(dataset_name="celeba_wild", dataset_loc=celeba_wild_root),
                             "train")) == 3


@pytest.mark.parametrize("image_size", [32, 48])  # resized, and read at its stored size
def test_cub_aligned_equal_jax(cub_root, image_size):  # noqa: F811
    _assert_same_adapter("cub_aligned", cub_root, image_size=image_size)


def test_deepfashion_equal_jax(deepfashion_root):  # noqa: F811
    _assert_same_adapter("deepfashion", deepfashion_root)


@pytest.fixture(scope="module")
def cub_parts_root(tmp_path_factory):
    """cmr cachedir layout: images of classes 1 and 2, one grayscale, with
    bboxes reaching past the image and a few invisible parts."""
    import scipy.io as sio

    root = tmp_path_factory.mktemp("cub_parts")
    data = root / "CUB_200_2011"
    rng = np.random.default_rng(3)
    for split, n in (("train", 5), ("test", 3)):
        records = []
        for i in range(n):
            cls = 1 + i % 2
            rel = f"{cls:03d}.Bird_{cls}/{split}_{i}.jpg"
            w, h = int(rng.integers(40, 72)), int(rng.integers(40, 72))
            path = data / "images" / rel
            os.makedirs(path.parent, exist_ok=True)
            pixels = rng.integers(0, 256, (h, w) if i == 1 else (h, w, 3), dtype=np.uint8)
            Image.fromarray(pixels).save(path)
            x1, y1 = int(rng.integers(1, w // 3)), int(rng.integers(1, h // 3))
            x2, y2 = int(rng.integers(2 * w // 3, w + 4)), int(rng.integers(2 * h // 3, h + 4))
            parts = np.stack([rng.uniform(x1, x2, 15), rng.uniform(y1, y2, 15),
                              (rng.uniform(0, 1, 15) > 0.2).astype(float)])
            bbox = np.array([(x1, y1, x2, y2)], dtype=[(k, "O") for k in ("x1", "y1", "x2", "y2")])
            records.append((rel, bbox, parts))
        images = np.array(records, dtype=[("rel_path", "O"), ("bbox", "O"), ("parts", "O")])
        out = data / "cachedir" / "cub" / "data" / f"{split}_cub_cleaned.mat"
        os.makedirs(out.parent, exist_ok=True)
        sio.savemat(str(out), {"images": images})
    return str(root)


@pytest.mark.parametrize("name", ["cub_all", "cub_001", "cub_002"])
def test_cub_parts_equal_jax(cub_parts_root, name):
    """The train split jitters and mirrors: two passes draw on."""
    _assert_same_adapter(name, cub_parts_root)
    assert not base.is_deterministic(build_dataset(
        Config(dataset_name=name, dataset_loc=cub_parts_root), "train"))


@pytest.fixture(scope="module")
def taichi_root(tmp_path_factory):
    import pandas

    root = tmp_path_factory.mktemp("taichi")
    for i in range(5):
        _rgb(str(root / "train" / f"clip{i % 2}" / f"{i:04d}.png"), 40, 40, i)
    rng = np.random.default_rng(4)
    for tag, n in (("train", 4), ("test", 3)):
        names = [f"{tag}_{i}.png" for i in range(n)]
        for j, name in enumerate(names):
            _rgb(str(root / "eval_images" / "taichi-256" / tag / name), 48, 48, 10 + j)
        values = [rng.uniform(-20, 256, (18, 2)).astype(np.float32) for _ in names]
        frame = pandas.DataFrame({"file_name": names, "value": values})
        os.makedirs(root / "landmark", exist_ok=True)
        frame.to_pickle(str(root / "landmark" / f"taichi_{tag}_gt.pkl"))
    return str(root)


def test_taichi_equal_jax(taichi_root):
    _assert_same_adapter("taichi", taichi_root, reads=3)


_ACTIONS = ("Directions", "Walking", "Sitting")  # Sitting is not among the reference's actions


@pytest.fixture(scope="module")
def human36m_root(tmp_path_factory):
    import scipy.io as sio

    root = tmp_path_factory.mktemp("h36m")
    rng = np.random.default_rng(5)
    for s in (1, 5, 6, 7, 8, 9, 11):
        os.makedirs(root / f"S{s}" / "WithBackground", exist_ok=True)
        if s not in (1, 9, 11):
            continue
        for action in _ACTIONS:
            for f in range(2):
                frame = f"{f:04d}"
                _rgb(str(root / f"S{s}" / "WithBackground" / action / f"{frame}.jpg"), 40, 40, s + f)
                mask = (rng.uniform(0, 1, (40, 40)) > 0.3).astype(np.uint8)
                os.makedirs(root / f"S{s}" / "BackgroudMask" / action, exist_ok=True)
                Image.fromarray(mask).save(root / f"S{s}" / "BackgroudMask" / action / f"{frame}.png")
                os.makedirs(root / f"S{s}" / "Landmarks" / action, exist_ok=True)
                sio.savemat(str(root / f"S{s}" / "Landmarks" / action / f"{frame}.mat"),
                            {"keypoints_2d": rng.uniform(0, 1, (32, 2))})
    return str(root)


@pytest.mark.parametrize("validation", [False, True])
def test_human36m_equal_jax(human36m_root, validation):
    _assert_same_adapter("human3.6m", human36m_root, validation=validation)


@pytest.fixture(scope="module")
def unaligned_root(tmp_path_factory):
    import h5py

    root = tmp_path_factory.mktemp("uh36m")
    rng = np.random.default_rng(6)
    for s in (1, 11):
        for action in _ACTIONS[:2]:
            seq = root / f"S{s}" / action
            cams, frames, poses = [], [], []
            for cam in ("54138969", "55011271"):
                for fi in (1, 3):
                    _rgb(str(seq / "imageSequence" / cam / f"img_{fi:06d}.jpg"), 320, 240, s + fi)
                    cams.append(int(cam))
                    frames.append(fi)
                    poses.append(rng.uniform([100, 80], [220, 160], (17, 2)))
            with h5py.File(seq / "annot.h5", "w") as hf:
                hf["camera"] = np.asarray(cams)
                hf["frame"] = np.asarray(frames)
                hf["pose/2d"] = np.asarray(poses)
    return str(root)


def test_unaligned_human36m_equal_jax(unaligned_root):
    _assert_same_adapter("unaligned_human3.6m", unaligned_root, image_size=64)


@pytest.fixture(scope="module")
def custom_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("custom")
    for i, ext in enumerate((".jpg", ".png", ".bmp")):
        _rgb(str(root / f"im_{i}{ext}"), 30 + 10 * i, 40, i)
    (root / "notes.txt").write_text("not an image")
    os.makedirs(root / "sub.jpg")  # a directory is not an image
    return str(root)


def test_custom_equal_jax(custom_root):
    _assert_same_adapter("custom", custom_root)
    assert len(build_dataset(Config(dataset_name="custom", dataset_loc=custom_root), "train")) == 3


def test_synthetic_equal_jax():
    kw = dict(dataset_name="synthetic", image_size=16, seed=2)
    for split in SPLITS:
        ours, theirs = build_dataset(Config(**kw), split), jax_build_dataset(JaxConfig(**kw), split)
        for i in range(3):
            for key in ("img", "kpts", "visibility"):
                np.testing.assert_array_equal(ours[i][key], theirs[i][key])


@pytest.mark.parametrize("mode", ["auto", "off", "on"])
def test_load_image_rgb_equal_jax(tmp_path, mode):
    """Every native_io mode: resized and at size, JPEG and PNG, bitwise
    equal to the JAX package's decode in that mode (the native decoder is
    the same C++ source and libjpeg on both sides)."""
    jbase.set_native_io(mode)
    try:
        for name, (w, h) in (("a.jpg", (40, 30)), ("b.png", (40, 30)), ("c.jpg", (32, 32))):
            _rgb(str(tmp_path / name), w, h, 1)
            base.set_native_io(mode)
            got = base.load_image_rgb(str(tmp_path / name), 32)
            assert got.shape == (32, 32, 3) and got.dtype == np.float32
            np.testing.assert_array_equal(got, jbase.load_image_rgb(str(tmp_path / name), 32))
    finally:
        jbase.set_native_io("auto")


def test_native_io_on_raises(custom_root):
    """native_io="on" (raised until the native decoder was ported) builds the
    dataset and decodes its JPEGs natively, as `load_image_rgb_fast`; an
    unknown mode raises."""
    try:
        ds = build_dataset(Config(dataset_name="custom", dataset_loc=custom_root, native_io="on"),
                           "train")
        assert base._NATIVE_IO_MODE == "on"
        first = os.path.join(custom_root, ds.files[0])  # im_0.jpg, 30x40: resized
        assert first.endswith(".jpg")
        np.testing.assert_array_equal(ds[0]["img"], base.load_image_rgb_fast(first, 512))
        assert not np.array_equal(ds[0]["img"], base._load_image_pil(first, 512))
    finally:
        base.set_native_io("auto")
    with pytest.raises(ValueError, match="native_io"):
        base.set_native_io("fast")


def test_unknown_dataset_raises():
    with pytest.raises(NotImplementedError, match="unknown dataset"):
        build_dataset(Config(dataset_name="imagenet"), "train")


def test_deepfashion_fixture_keypoints(deepfashion_root):  # noqa: F811
    """A spot value of the adapters' shared keypoint convention: (x, y) ->
    (y, x), / 256."""
    s = build_dataset(Config(dataset_name="deepfashion", dataset_loc=deepfashion_root,
                             image_size=32), "test")[0]
    with open(os.path.join(deepfashion_root, "data_test.json")) as f:
        x, y = json.load(f)[0]["keypoints"][0]
    np.testing.assert_allclose(s["kpts"][0], [y / 256, x / 256], rtol=1e-6)
