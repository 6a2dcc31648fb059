"""Visualization artifacts (the JAX package's `pipeline/visualize.py`;
reference visualize.py:40-374).

The same artifact set as the JAX package: a grid of images with numbered
keypoints (`unsupervised_keypoints.pdf`), per-keypoint heatmap grids
(`keypoint_{i:03d}.png`), regressed and ground-truth panels
(`estimated_keypoints.pdf`, `gt_keypoints.pdf`), the test-time ensemble's
debug panel (`augmentation.png`), and `create_vid`'s tracks over ordered
frames (`frames/frame_{i:05d}.png`, `keypoints.npy/.pt`,
`saved_maps.npy/.pt`).

matplotlib is imported by the functions that plot, before they compute
anything, as the dataset adapters import PIL: without it they raise.

    python -m stablekeypoints_tpu_torch.pipeline.visualize --save_folder OUT \
        --dataset_loc FRAMES [--use_regressor] [--device cpu]
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from stablekeypoints_tpu_torch.ops.transforms import apply_affine, sample_thetas
from stablekeypoints_tpu_torch.pipeline.metrics import apply_regressor
from stablekeypoints_tpu_torch.pipeline.regressor import extract_keypoints
from stablekeypoints_tpu_torch.utils.artifacts import save_artifact

__all__ = ["create_vid", "main", "plot_point_correspondences", "pyplot", "save_augmentation_panel",
           "save_grid", "visualize_attn_maps"]


def pyplot():
    """matplotlib.pyplot on the Agg backend (raises ImportError without
    matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_grid(images, path: str, ncols: int = 8, titles=None):
    """A grid of HWC images and HW heatmaps (a list or an array) to a file
    (visualize.py:40-73)."""
    plt = pyplot()
    n = len(images)
    ncols = min(ncols, n)
    nrows = -(-n // ncols)
    fig, axs = plt.subplots(nrows, ncols, figsize=(2 * ncols, 2 * nrows), squeeze=False)
    for i in range(nrows * ncols):
        ax = axs[i // ncols][i % ncols]
        ax.axis("off")
        if i < n:
            img = np.asarray(images[i])
            ax.imshow(img, cmap=None if img.ndim == 3 else "viridis")
            if titles is not None:
                ax.set_title(str(titles[i]), fontsize=6)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)


def plot_point_correspondences(images: np.ndarray, points: np.ndarray, path: str,
                               ncols: int = 8):
    """Images with numbered keypoints, (y, x) normalized (visualize.py:105-138)."""
    plt = pyplot()
    n = len(images)
    ncols = min(ncols, n)
    nrows = -(-n // ncols)
    fig, axs = plt.subplots(nrows, ncols, figsize=(2 * ncols, 2 * nrows), squeeze=False)
    cmap = plt.get_cmap("tab10")
    for i in range(nrows * ncols):
        ax = axs[i // ncols][i % ncols]
        ax.axis("off")
        if i < n:
            h, w = images[i].shape[:2]
            ax.imshow(images[i])
            for j, (y, x) in enumerate(points[i]):
                ax.scatter([x * w], [y * h], s=12, color=cmap(j % 10))
                ax.annotate(str(j), (x * w, y * h), fontsize=5, color="white")
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)


def _generator(runtime, generator: Optional[torch.Generator], offset: int) -> torch.Generator:
    if generator is not None:
        return generator
    return torch.Generator(device=runtime.device).manual_seed(runtime.cfg.seed + offset)


def visualize_attn_maps(runtime, dataset, context, indices, regressor=None, num_images: int = 16,
                        logger=None, generator: Optional[torch.Generator] = None):
    """The keypoint grid and per-keypoint heatmaps (and, with a regressor,
    the regressed and ground-truth panels) for up to `num_images` images in
    the order numpy's default_rng(seed + 6) permutes the dataset
    (visualize.py:140-247). The views' thetas and noise come from
    `generator` (default: seeded cfg.seed + 6 on the runtime's device)."""
    pyplot()
    cfg = runtime.cfg
    os.makedirs(cfg.save_folder, exist_ok=True)
    gen = _generator(runtime, generator, 6)
    idx_arr = np.asarray(indices, np.int64)
    picks = np.random.default_rng(cfg.seed + 6).permutation(len(dataset))[:min(num_images,
                                                                                len(dataset))]
    images, all_points, all_maps, all_gt = [], [], [], []
    for di in picks:
        sample = dataset[int(di)]
        maps = runtime.augmented_maps(context, np.asarray(sample["img"], np.float32), idx_arr,
                                      generator=gen).cpu().numpy()
        images.append(np.asarray(sample["img"]))
        all_points.append(extract_keypoints(maps, cfg.max_loc_strategy))
        all_maps.append(maps)
        all_gt.append(np.asarray(sample["kpts"]))

    images, all_points = np.stack(images), np.stack(all_points)
    plot_point_correspondences(images, all_points,
                               os.path.join(cfg.save_folder, "unsupervised_keypoints.pdf"))
    for j in range(len(idx_arr)):
        save_grid(np.stack([m[j] for m in all_maps]),
                  os.path.join(cfg.save_folder, f"keypoint_{j:03d}.png"))
    if regressor is not None:
        reg = np.asarray(regressor)
        est = np.stack([apply_regressor(p, reg) for p in all_points])
        plot_point_correspondences(images, est,
                                   os.path.join(cfg.save_folder, "estimated_keypoints.pdf"))
        plot_point_correspondences(images, np.stack(all_gt),
                                   os.path.join(cfg.save_folder, "gt_keypoints.pdf"))
    if logger is not None:
        logger.log({"event": "visualized", "num_images": len(picks)})
    return all_points


def save_augmentation_panel(runtime, image: np.ndarray, context, indices, path: str,
                            generator: Optional[torch.Generator] = None):
    """The test-time ensemble's debug panel (eval.py:268-353's
    `augmentation.png`): the image, four warped views of it, and the
    ensembled map of the first selected token. The views' thetas, then the
    ensemble's, come from `generator` (default: seeded cfg.seed + 10)."""
    pyplot()
    gen = _generator(runtime, generator, 10)
    img = torch.as_tensor(np.asarray(image, np.float32)).to(runtime.device)
    thetas = sample_thetas(gen, 4, runtime.aff).to(runtime.device)
    views = apply_affine(img[None].expand(4, *img.shape), thetas).cpu().numpy()
    maps = runtime.augmented_maps(context, img, np.asarray(indices, np.int64),
                                  generator=gen).cpu().numpy()
    panels = [np.asarray(image)] + list(views) + [maps[0] / (maps[0].max() + 1e-8)]
    save_grid(panels, path, ncols=3)


def create_vid(runtime, dataset, context, indices, regressor=None, logger=None,
               generator: Optional[torch.Generator] = None):
    """Track keypoints over ordered frames (visualize.py:250-374): per frame
    the ensembled maps (thetas and noise from `generator`, default seeded
    cfg.seed + 7), its keypoints (regressed when a regressor is given), a
    panel; then `keypoints` [F, k, 2] and `saved_maps` [F, k, H, W] fp16 as
    artifacts. Returns the keypoints."""
    pyplot()
    cfg = runtime.cfg
    gen = _generator(runtime, generator, 7)
    idx_arr = np.asarray(indices, np.int64)
    frames_dir = os.path.join(cfg.save_folder, "frames")
    os.makedirs(frames_dir, exist_ok=True)

    keypoints, saved_maps = [], []
    for fi in range(len(dataset)):
        sample = dataset[fi]
        maps = runtime.augmented_maps(context, np.asarray(sample["img"], np.float32), idx_arr,
                                      generator=gen).cpu().numpy()
        pts = extract_keypoints(maps, cfg.max_loc_strategy)
        if regressor is not None:
            pts = apply_regressor(pts, np.asarray(regressor))
        keypoints.append(pts)
        saved_maps.append(maps.astype(np.float16))
        plot_point_correspondences(np.asarray(sample["img"])[None], pts[None],
                                   os.path.join(frames_dir, f"frame_{fi:05d}.png"), ncols=1)
        if logger is not None and fi % 20 == 0:
            logger.log({"event": "vid_frame", "frame": fi})

    keypoints = np.stack(keypoints)
    save_artifact(cfg.save_folder, "keypoints", keypoints)
    save_artifact(cfg.save_folder, "saved_maps", np.stack(saved_maps))
    return keypoints


def main(argv=None):
    """Track keypoints over the ordered frames of --dataset_loc with the
    embedding and indices (and, with --use_regressor, the regressor) in
    --save_folder."""
    import argparse

    from stablekeypoints_tpu_torch.config import Config
    from stablekeypoints_tpu_torch.data.custom import CustomDataset
    from stablekeypoints_tpu_torch.pipeline.runtime import Runtime
    from stablekeypoints_tpu_torch.utils.artifacts import load_artifact

    p = argparse.ArgumentParser(description="track keypoints across video frames")
    p.add_argument("--save_folder", type=str, default="outputs")
    p.add_argument("--dataset_loc", type=str, required=True,
                   help="folder of ordered frame images")
    p.add_argument("--model_type", type=str, default=Config.model_type)
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--use_regressor", action="store_true",
                   help="apply the fitted stage-4 regressor to the tracks")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the GPU (raises without one)")
    args = p.parse_args(argv)

    embedding = load_artifact(args.save_folder, "embedding")
    indices = load_artifact(args.save_folder, "indices")
    regressor = load_artifact(args.save_folder, "regressor") if args.use_regressor else None
    cfg = Config(dataset_name="custom", dataset_loc=args.dataset_loc,
                 model_type=args.model_type, model_path=args.model_path,
                 image_size=args.image_size, num_tokens=embedding.shape[1], seed=args.seed,
                 save_folder=args.save_folder)
    runtime = Runtime.create(cfg, device=args.device)
    frames = CustomDataset(args.dataset_loc, image_size=args.image_size)
    kpts = create_vid(runtime, frames, embedding, indices, regressor=regressor)
    print(f"tracked {kpts.shape[0]} frames x {kpts.shape[1]} keypoints -> "
          f"{os.path.join(args.save_folder, 'keypoints.npy')} + frames/")
    return kpts


if __name__ == "__main__":
    main()
