"""Ring-wire kernels: the zero1 transposed bucket pack (gradient ->
bucket-major wire, with or without the bf16 error-feedback fold) and its
inverse, and the compressed ring hops (int8 quantize, middle-hop
dequantize-add-requantize, last-hop dequantize-add, and the bf16 twins).

``ops`` holds the wrappers (CUDA kernel for CUDA tensors, plain version
for CPU tensors), ``ref`` the plain PyTorch versions, ``csrc`` the CUDA
sources (``ring_wire.cu``: pack/unpack; ``ring_hops.cu``: the hops).
"""
