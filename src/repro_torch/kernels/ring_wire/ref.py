"""Plain PyTorch versions of the ring-wire kernels.

The same functions as ``csrc/ring_wire.cu`` (the zero1 pack/unpack, with
and without error feedback) and ``csrc/ring_hops.cu`` (the compressed ring
hops), written as tensor views, casts and elementwise ops.  The CPU tests
run these and hold them against the reference package's Pallas kernels in
interpret mode and its ``ref.py`` oracles; ``chip_smoke.py`` holds the CUDA
kernels bitwise against them on the card.

Rounding follows the reference's ``ring_wire/kernel.py``: the bf16 cast
rounds to nearest even (``__float2bfloat16_rn`` in the kernels); the int8
scale is ``max(absmax, 1e-30) * f32(1/127)`` — a multiply, not a divide —
and the code is ``clip(round(x / s), -127, 127)`` with an IEEE divide and
round-half-to-even.  Dequantize-and-add is a multiply then an add, two
roundings, as the kernels write it with ``__fmul_rn``/``__fadd_rn``.
"""
from __future__ import annotations

import torch

#: quantization granule: one int8 scale per 128 wire elements
WIRE_BLOCK = 128
#: absmax floor (an all-zero block gets scale 1e-30/127, not 0/0)
QEPS = 1e-30
#: f32(1) / f32(127), the single-rounded reciprocal the scale multiplies by
INV127 = float(torch.tensor(1.0, dtype=torch.float32) / torch.tensor(127.0, dtype=torch.float32))


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


def pack_transposed_ef(x2d: torch.Tensor, e2d: torch.Tensor, dp: int,
                       buckets: int) -> tuple:
    """Error-feedback fold + bf16 wire + residual + transposed split:
    ``y = g + e``; ``w = bf16(y)`` at the bucket-major layout; the new
    residual ``y - f32(w)`` keeps the rank-major layout of ``g``."""
    y = x2d + e2d
    w = y.to(torch.bfloat16)
    return pack_transposed(w, dp, buckets, torch.bfloat16), y - w.float()


def quant_i8(x2d: torch.Tensor) -> tuple:
    """(nb, 128) f32 -> ((nb, 128) int8 codes, (nb, 1) f32 scales)."""
    s = torch.clamp_min(x2d.abs().amax(dim=1, keepdim=True), QEPS) * INV127
    q = torch.clamp(torch.round(x2d / s), -127.0, 127.0).to(torch.int8)
    return q, s


def hop_add_quant_i8(q2d: torch.Tensor, s: torch.Tensor, a2d: torch.Tensor) -> tuple:
    """Middle hop: dequantize, add the local chunk, re-quantize."""
    return quant_i8(q2d.float() * s + a2d)


def hop_accum_i8(q2d: torch.Tensor, s: torch.Tensor, a2d: torch.Tensor) -> torch.Tensor:
    """Last hop: dequantize and add the local chunk, f32 out."""
    return q2d.float() * s + a2d


def hop_add_quant_bf16(w2d: torch.Tensor, a2d: torch.Tensor) -> torch.Tensor:
    """Middle hop on the bf16 wire: ``bf16(f32(w) + a)``."""
    return (w2d.float() + a2d).to(torch.bfloat16)


def hop_accum_bf16(w2d: torch.Tensor, a2d: torch.Tensor) -> torch.Tensor:
    """Last hop on the bf16 wire: ``f32(w) + a``."""
    return w2d.float() + a2d
