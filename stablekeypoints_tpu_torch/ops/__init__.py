"""Tensor ops: resize matrices, affine warps, keypoint extraction."""
