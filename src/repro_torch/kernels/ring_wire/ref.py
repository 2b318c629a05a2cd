"""Plain PyTorch versions of the zero1 wire-layout kernels.

The same functions as ``csrc/ring_wire.cu`` written as tensor views, a
transpose and a cast.  The CPU tests run these (and hold them bitwise
against the reference package's Pallas kernels in interpret mode);
``chip_smoke.py`` holds the CUDA kernels bitwise against them on the card.
The bf16 cast rounds to nearest even, as the kernel's
``__float2bfloat16_rn`` does.
"""
from __future__ import annotations

import torch


def pack_transposed(x2d: torch.Tensor, dp: int, buckets: int,
                    wire_dtype: torch.dtype) -> torch.Tensor:
    """(dp*buckets, seg) f32 rank-major -> (buckets, dp, seg) bucket-major
    in the wire dtype."""
    seg = x2d.shape[1]
    return x2d.reshape(dp, buckets, seg).transpose(0, 1).to(wire_dtype).contiguous()


def unpack_transposed(x3d: torch.Tensor) -> torch.Tensor:
    """(buckets, dp, seg) -> (dp*buckets, seg) f32 rank-major."""
    buckets, dp, seg = x3d.shape
    return x3d.transpose(0, 1).reshape(dp * buckets, seg).to(torch.float32)
