"""Hand-written Hopper kernels: each beside its plain PyTorch version.

A wrapper takes the plain version only for tensors on the CPU; for a CUDA
tensor it launches its kernel (built by ``_build``) or raises.
"""
