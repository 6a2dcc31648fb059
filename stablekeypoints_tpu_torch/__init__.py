"""StableKeypoints on PyTorch and CUDA (NVIDIA Hopper).

The port of the JAX package `stablekeypoints_tpu`, slice by slice; it
imports neither JAX nor that package. Ported so far, on SD-1.5: the
five-stage CLI (`python -m stablekeypoints_tpu_torch.main`: learning the
context, the token vote, keypoints of the regression split, the
regressor, the test-set metric; the dataset adapters, checkpoints and
--resume), `api.learn_keypoints` and detection (`api.KeypointModel`), with
hand-written kernels for the attention capture, the cross/self attention,
the VAE GroupNorm and its fused GroupNorm + SiLU + 3x3 conv (`kernels/`).
Entry points run on the GPU unless given `device="cpu"`.
"""

__version__ = "0.1.0"
