"""Mamba2 SSD: the chunked state-space scan from a zero state, forward
only.

``ops`` holds the wrapper (CUDA kernel for CUDA tensors, plain version for
CPU tensors), ``ref`` the plain PyTorch versions and the sequential
oracle, ``csrc`` the CUDA source (``ssd_wgmma.cu``: the products on the
tensor cores as 3xTF32 wgmma).
"""
