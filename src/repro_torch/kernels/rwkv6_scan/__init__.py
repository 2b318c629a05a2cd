"""RWKV6 WKV scan: the chunked WKV6 recurrence from a zero state, forward
only.

``ops`` holds the wrapper (CUDA kernel for CUDA tensors, plain version for
CPU tensors), ``ref`` the plain PyTorch versions and the sequential
oracle, ``csrc`` the CUDA source (``wkv6_wgmma.cu``, 3xTF32 on the tensor
cores).
"""
