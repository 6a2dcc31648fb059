"""StableKeypoints on PyTorch and CUDA (NVIDIA Hopper).

The port of the JAX package `stablekeypoints_tpu`, slice by slice; it
imports neither JAX nor that package. Ported so far: keypoint detection
with a learned context (`api.KeypointModel.detect` / `detect_batch`) on
SD-1.5, with hand-written kernels for the attention capture, the
cross/self attention and the VAE GroupNorm (`kernels/`). Entry points run
on the GPU unless given `device="cpu"`.
"""

__version__ = "0.1.0"
