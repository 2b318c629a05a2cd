"""Zero1 wire-layout kernels: the transposed bucket pack (gradient ->
bucket-major wire) and its inverse (gathered buckets -> flat vector).

``ops`` holds the wrappers (CUDA kernel for CUDA tensors, plain version
for CPU tensors), ``ref`` the plain PyTorch versions, ``csrc`` the CUDA
source.  The compressed-wire hop kernels of the reference package arrive
with the ring slice.
"""
