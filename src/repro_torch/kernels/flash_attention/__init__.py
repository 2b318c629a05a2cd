"""Flash attention: causal or non-causal grouped-query attention with an
online softmax, forward only.

``ops`` holds the wrappers (CUDA kernel for CUDA tensors, plain version
for CPU tensors), ``ref`` the plain PyTorch version, ``csrc`` the CUDA
source (``flash_attention.cu``).
"""
