"""Hand-written Hopper kernels, each beside its plain PyTorch version.

K1 attn_capture (CUDA), K3 cross_attn (CUDA), K4/K5 flash (CUDA) and K6
groupnorm (Triton). A wrapper runs the plain version for CPU tensors and
the kernel for CUDA tensors, or raises; `<wrapper>.launches` counts the
kernel's launches.
"""
