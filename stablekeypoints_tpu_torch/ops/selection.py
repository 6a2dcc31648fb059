"""Token selection: ranking strategies and furthest point sampling.

The JAX package's `ops/selection.py`, with the same index sets: sorts are
stable (`torch.argsort(..., stable=True)`, as JAX's argsort), `argmax`
takes the first maximum, and the greedy loop's strict comparisons let the
first candidate in order win a tie. Everything stays on the maps' device:
no index leaves it.
"""

from __future__ import annotations

import torch

from stablekeypoints_tpu_torch.ops.gaussians import gaussian_circles
from stablekeypoints_tpu_torch.ops.keypoints import find_k_max_pixels, find_max_pixel

__all__ = [
    "entropy_sort",
    "find_top_k_gaussian",
    "furthest_point_sampling",
    "select_candidates",
]


def find_top_k_gaussian(maps: torch.Tensor, top_k: int, sigma: float = 3.0,
                        epsilon: float = 1e-5, num_subjects: int = 1) -> torch.Tensor:
    """Rank tokens by KL(gaussian at the map's own argmax || softmax(map)),
    lowest first. maps [T, H, W] -> [top_k] token indices."""
    t, h, w = maps.shape
    pos = find_k_max_pixels(maps, num=num_subjects) / h
    log_p = torch.log_softmax(maps.reshape(t, h * w) + epsilon, dim=-1)
    target = gaussian_circles(pos, size=h, sigma=sigma).reshape(t, h * w) + epsilon
    target = target / target.sum(dim=-1, keepdim=True)
    kl = torch.sum(target * (torch.log(target) - log_p), dim=-1)
    return torch.argsort(kl, stable=True)[:top_k]


def entropy_sort(maps: torch.Tensor, top_k: int) -> torch.Tensor:
    """Rank tokens by the entropy of softmax(map), lowest first."""
    t, h, w = maps.shape
    log_p = torch.log_softmax(maps.reshape(t, h * w), dim=-1)
    entropy = -torch.sum(torch.exp(log_p) * log_p, dim=-1)
    return torch.argsort(entropy, stable=True)[:top_k]


def furthest_point_sampling(maps: torch.Tensor, top_k: int,
                            candidates: torch.Tensor) -> torch.Tensor:
    """Greedy furthest-point sampling over the candidates' argmax locations.

    maps [T, H, W]; candidates [K] token indices in ranking order ->
    [top_k] token indices. Seeded with the most distant candidate pair
    (row-major over i < j), then each step adds the candidate whose least
    distance to the selected set is largest."""
    h = maps.shape[1]
    locs = find_max_pixel(maps) / h
    k = candidates.shape[0]
    cand = locs[candidates]
    dist = torch.sqrt(torch.sum((cand[:, None, :] - cand[None, :, :]) ** 2, dim=-1))
    upper = torch.triu(torch.ones((k, k), dtype=torch.bool, device=maps.device), 1)
    pair = torch.argmax(torch.where(upper, dist, -1.0).reshape(-1))
    selected = [torch.div(pair, k, rounding_mode="floor"), pair % k]
    # the selected set as a mask built by comparison: indexing with a 0-d
    # index tensor would read it back to the host and wait for the device
    slots = torch.arange(k, device=maps.device)
    chosen = (slots == selected[0]) | (slots == selected[1])
    for _ in range(2, top_k):
        mind = torch.where(chosen[None, :], dist, float("inf")).min(dim=1).values
        nxt = torch.argmax(torch.where(chosen, -float("inf"), mind))
        selected.append(nxt)
        chosen = chosen | (slots == nxt)
    return candidates[torch.stack(selected)[:top_k]]


def select_candidates(maps: torch.Tensor, strategy: str, num_candidates: int,
                      sigma: float = 3.0, num_subjects: int = 1) -> torch.Tensor:
    """The stage-1 and stage-2 candidate ranking by `top_k_strategy`."""
    if strategy == "gaussian":
        return find_top_k_gaussian(maps, num_candidates, sigma=sigma, num_subjects=num_subjects)
    if strategy == "entropy":
        return entropy_sort(maps, num_candidates)
    if strategy == "consistent":
        return torch.arange(num_candidates, device=maps.device)
    raise NotImplementedError(f"unknown top_k_strategy: {strategy}")
