"""Dataset dispatch by name (the JAX package's `data/registry.py`;
reference switch blocks optimize.py:278-303, keypoint_regressor.py:25-50
and 119-144, eval.py:385-409).

Splits: 'train' (stages 1 and 2), 'train_reg' (stage 3, the regression
fit), 'test' (stage 5). Adapters are imported when their dataset is built.
"""

from __future__ import annotations

from stablekeypoints_tpu_torch.config import Config

__all__ = ["DATASET_NAMES", "build_dataset"]

DATASET_NAMES = (
    "celeba_aligned",
    "celeba_wild",
    "cub_aligned",
    "cub_001",
    "cub_002",
    "cub_003",
    "cub_all",
    "deepfashion",
    "taichi",
    "human3.6m",
    "unaligned_human3.6m",
    "custom",
    "synthetic",
)


def build_dataset(cfg: Config, split: str):
    from stablekeypoints_tpu_torch.data.base import set_native_io

    set_native_io(cfg.native_io)
    name = cfg.dataset_name
    loc = cfg.dataset_loc
    size = cfg.image_size
    if name in ("celeba_aligned", "celeba_wild"):
        from stablekeypoints_tpu_torch.data.celeba import CelebA

        return CelebA(
            split="train" if split in ("train", "train_reg") else "test",
            dataset_loc=loc,
            align=(name == "celeba_aligned"),
            max_len=cfg.max_len if split == "train" else -1,
            image_size=size,
        )
    if name == "cub_aligned":
        from stablekeypoints_tpu_torch.data.cub import CUBAligned

        return CUBAligned(data_root=loc, split=split, image_size=size)
    if name in ("cub_001", "cub_002", "cub_003", "cub_all"):
        from stablekeypoints_tpu_torch.data.cub_parts import CUBParts

        single = {"cub_001": 1, "cub_002": 2, "cub_003": 3, "cub_all": None}[name]
        return CUBParts(
            dataset_root=loc,
            split="train" if split in ("train", "train_reg") else "test",
            single_class=single,
            image_size=size,
        )
    if name == "deepfashion":
        from stablekeypoints_tpu_torch.data.deepfashion import DeepFashion

        return DeepFashion(data_root=loc, split=split, image_size=size)
    if name == "taichi":
        from stablekeypoints_tpu_torch.data.taichi import Taichi

        return Taichi(data_root=loc, split=split, image_size=size)
    if name == "human3.6m":
        from stablekeypoints_tpu_torch.data.human36m import Human36M

        return Human36M(data_root=loc, split=split, validation=cfg.validation, image_size=size)
    if name == "unaligned_human3.6m":
        from stablekeypoints_tpu_torch.data.unaligned_human36m import UnalignedHuman36M

        return UnalignedHuman36M(data_root=loc, split=split, image_size=size)
    if name == "custom":
        from stablekeypoints_tpu_torch.data.custom import CustomDataset

        return CustomDataset(data_root=loc, image_size=size)
    if name == "synthetic":
        from stablekeypoints_tpu_torch.data.synthetic import SyntheticBlobs

        return SyntheticBlobs(image_size=size, seed=cfg.seed + (0 if split != "test" else 1))
    raise NotImplementedError(f"unknown dataset: {name}")
