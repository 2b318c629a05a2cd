"""TF32 arithmetic of the port's tensor-core scans, emulated in plain torch.

The scan kernels (``ssd_wgmma.cu``, ``wkv6_wgmma.cu``) run their products
as tf32 ``wgmma`` on operands split into hi = tf32(a) and lo = tf32(a - hi).
The tests hold emulations built from these helpers to the card's gates on
the CPU.
"""
from __future__ import annotations

import torch


#: the least |a| that rounding to nearest takes to infinity (the kernels'
#: ``kTf32Top``, ``kernels/csrc/tf32_wgmma.cuh``)
TF32_TOP = float.fromhex("0x1.ffep127")


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 stored mantissa bits) as the kernels'
    split rounds its hi term: as cvt.rna.tf32.f32 rounds a finite value (to
    nearest, ties away from zero) below :data:`TF32_TOP`, truncated at and
    above it and for NaN, so that NaN and infinity stay non-finite and a
    finite value finite."""
    bits = a.view(torch.int32)
    near = (bits + 0x1000) & ~0x1FFF
    return torch.where(a.abs() < TF32_TOP, near, bits & ~0x1FFF).view(torch.float32)


def _tf32_product(eq: str, a, b, terms: int):
    """einsum of TF32 operands: one rounding each (``terms=1``) or hi + lo,
    hi.hi + hi.lo + lo.hi (``terms=3``), as the kernels' wgmma.  Summed in
    float64, so that only the operands' precision is emulated."""
    ah, bh = _tf32(a), _tf32(b)
    f64 = torch.float64
    out = torch.einsum(eq, ah.to(f64), bh.to(f64))
    if terms == 3:
        out = (out + torch.einsum(eq, ah.to(f64), _tf32(b - bh).to(f64))
               + torch.einsum(eq, _tf32(a - ah).to(f64), bh.to(f64)))
    return out.float()
