"""Wrappers of the ring-wire kernels — what ``grad_sync`` and the ring
backend call.

Two families, as in the reference's ``ring_wire/ops.py``:

* the zero1 wire layout (``csrc/ring_wire.cu``): :func:`pack_transposed`,
  :func:`pack_transposed_ef` and :func:`unpack_transposed`, behind
  :func:`pack_parts`, :func:`pack_parts_ef` and :func:`unpack_gathers`;
* the compressed ring hops (``csrc/ring_hops.cu``) on ``(nb, 128)`` wire
  views: :func:`quant_i8`, :func:`hop_add_quant_i8`, :func:`hop_accum_i8`,
  :func:`hop_add_quant_bf16`, :func:`hop_accum_bf16`, behind the
  shape-polymorphic :func:`quant`, :func:`hop_add_quant`, :func:`hop_accum`.

Each kernel wrapper checks what the kernel takes, then runs the variant
that the kernel registry (:mod:`repro_torch.kernels`) holds for the
tensor's device: on a CUDA tensor the ``launch_*`` function, which launches
the CUDA kernel on the current stream (raising if the launch is refused)
and adds one to the wrapper's ``launches`` count; on a CPU tensor the plain
version in :mod:`.ref`.  Any other device raises.  There is no fallback
from a CUDA tensor to the plain version.

:func:`pack_eligible` and :func:`wire_eligible` are evaluated at plan time.
They keep the reference's divisibility and dtype rules and drop its size
caps: the reference's no-grid Pallas kernels hold the whole payload in the
TPU's VMEM, while the Hopper kernels stream over a grid and take any size.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch

from ... import kernels
from .. import _build
from . import ref as _ref

SOURCES = (Path(__file__).with_name("csrc") / "ring_wire.cu",)
HOP_SOURCES = (Path(__file__).with_name("csrc") / "ring_hops.cu",)

#: quantization granule and wire block: one int8 scale per 128 elements
WIRE_BLOCK = _ref.WIRE_BLOCK

#: grid rows are one per (rank, bucket) pair; CUDA caps gridDim.y here
_MAX_ROWS = 65535

_WIRE_DTYPES = (torch.float32, torch.bfloat16)


_P, _N = ctypes.c_void_p, ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = _build.load("ring_wire", SOURCES)
    for fn in (lib.pax_pack_transposed, lib.pax_unpack_transposed):
        fn.argtypes = [_P, _P, _N, _N, _N, ctypes.c_int, _P]
        fn.restype = ctypes.c_int
    lib.pax_pack_transposed_ef.argtypes = [_P, _P, _P, _P, _N, _N, _N, _P]
    lib.pax_pack_transposed_ef.restype = ctypes.c_int
    return lib


def _hop_lib() -> ctypes.CDLL:
    lib = _build.load("ring_hops", HOP_SOURCES)
    for name, n_ptr in (("pax_quant_i8", 3), ("pax_hop_add_quant_i8", 5),
                        ("pax_hop_accum_i8", 4), ("pax_hop_add_quant_bf16", 3),
                        ("pax_hop_accum_bf16", 3)):
        fn = getattr(lib, name)
        fn.argtypes = [_P] * n_ptr + [_N, _P]
        fn.restype = ctypes.c_int
    return lib


def _check_rows(dp: int, buckets: int) -> None:
    if dp * buckets > _MAX_ROWS:
        raise ValueError(f"dp*buckets={dp * buckets} exceeds {_MAX_ROWS} grid rows")


def launch_pack_transposed(x2d: torch.Tensor, dp: int, buckets: int,
                           wire_dtype: torch.dtype) -> torch.Tensor:
    """The ``cuda`` variant of :func:`pack_transposed`: one kernel launch."""
    x2d = x2d.contiguous()
    seg = x2d.shape[1]
    _check_rows(dp, buckets)
    out = torch.empty((buckets, dp, seg), dtype=wire_dtype, device=x2d.device)
    _build.launch(_lib, "pax_pack_transposed", (x2d, out), dp, buckets, seg,
          int(wire_dtype == torch.bfloat16))
    pack_transposed.launches += 1
    return out


def launch_unpack_transposed(x3d: torch.Tensor) -> torch.Tensor:
    """The ``cuda`` variant of :func:`unpack_transposed`: one kernel launch."""
    x3d = x3d.contiguous()
    buckets, dp, seg = x3d.shape
    _check_rows(dp, buckets)
    out = torch.empty((dp * buckets, seg), dtype=torch.float32, device=x3d.device)
    _build.launch(_lib, "pax_unpack_transposed", (x3d, out), dp, buckets, seg,
          int(x3d.dtype == torch.bfloat16))
    unpack_transposed.launches += 1
    return out


def launch_pack_transposed_ef(x2d: torch.Tensor, e2d: torch.Tensor, dp: int,
                              buckets: int) -> tuple:
    """The ``cuda`` variant of :func:`pack_transposed_ef`: one kernel launch."""
    x2d, e2d = x2d.contiguous(), e2d.contiguous()
    seg = x2d.shape[1]
    _check_rows(dp, buckets)
    out = torch.empty((buckets, dp, seg), dtype=torch.bfloat16, device=x2d.device)
    new_ef = torch.empty_like(x2d)
    _build.launch(_lib, "pax_pack_transposed_ef", (x2d, e2d, out, new_ef), dp, buckets, seg)
    pack_transposed_ef.launches += 1
    return out, new_ef


def launch_quant_i8(x2d: torch.Tensor) -> tuple:
    """The ``cuda`` variant of :func:`quant_i8`: one kernel launch."""
    x2d = x2d.contiguous()
    q = torch.empty(x2d.shape, dtype=torch.int8, device=x2d.device)
    s = torch.empty((x2d.shape[0], 1), dtype=torch.float32, device=x2d.device)
    _build.launch(_hop_lib, "pax_quant_i8", (x2d, q, s), x2d.shape[0])
    quant_i8.launches += 1
    return q, s


def launch_hop_add_quant_i8(q2d: torch.Tensor, s: torch.Tensor,
                            a2d: torch.Tensor) -> tuple:
    """The ``cuda`` variant of :func:`hop_add_quant_i8`: one kernel launch."""
    q2d, s, a2d = q2d.contiguous(), s.contiguous(), a2d.contiguous()
    q2 = torch.empty_like(q2d)
    s2 = torch.empty_like(s)
    _build.launch(_hop_lib, "pax_hop_add_quant_i8", (q2d, s, a2d, q2, s2), q2d.shape[0])
    hop_add_quant_i8.launches += 1
    return q2, s2


def launch_hop_accum_i8(q2d: torch.Tensor, s: torch.Tensor,
                        a2d: torch.Tensor) -> torch.Tensor:
    """The ``cuda`` variant of :func:`hop_accum_i8`: one kernel launch."""
    q2d, s, a2d = q2d.contiguous(), s.contiguous(), a2d.contiguous()
    out = torch.empty_like(a2d)
    _build.launch(_hop_lib, "pax_hop_accum_i8", (q2d, s, a2d, out), q2d.shape[0])
    hop_accum_i8.launches += 1
    return out


def launch_hop_add_quant_bf16(w2d: torch.Tensor, a2d: torch.Tensor) -> torch.Tensor:
    """The ``cuda`` variant of :func:`hop_add_quant_bf16`: one kernel launch."""
    w2d, a2d = w2d.contiguous(), a2d.contiguous()
    out = torch.empty_like(w2d)
    _build.launch(_hop_lib, "pax_hop_add_quant_bf16", (w2d, a2d, out), w2d.shape[0])
    hop_add_quant_bf16.launches += 1
    return out


def launch_hop_accum_bf16(w2d: torch.Tensor, a2d: torch.Tensor) -> torch.Tensor:
    """The ``cuda`` variant of :func:`hop_accum_bf16`: one kernel launch."""
    w2d, a2d = w2d.contiguous(), a2d.contiguous()
    out = torch.empty_like(a2d)
    _build.launch(_hop_lib, "pax_hop_accum_bf16", (w2d, a2d, out), w2d.shape[0])
    hop_accum_bf16.launches += 1
    return out


# -- kernel wrappers: check, then the registry's variant for the device ------
# -- the shape-only variants: a FakeTensor, which holds no data (the dry run) -
# Empty outputs of each kernel's shapes and dtypes, no arithmetic and no
# launch count: what the kernel writes, for a tracer that counts bytes.
def shape_pack_transposed(x2d: torch.Tensor, dp: int, buckets: int,
                          wire_dtype: torch.dtype) -> torch.Tensor:
    return x2d.new_empty((buckets, dp, x2d.shape[1]), dtype=wire_dtype)


def shape_unpack_transposed(x3d: torch.Tensor) -> torch.Tensor:
    b, dp, seg = x3d.shape
    return x3d.new_empty((dp * b, seg), dtype=torch.float32)


def shape_pack_transposed_ef(x2d: torch.Tensor, e2d: torch.Tensor, dp: int,
                             buckets: int) -> tuple:
    return shape_pack_transposed(x2d, dp, buckets, torch.bfloat16), torch.empty_like(e2d)


def shape_quant_i8(x2d: torch.Tensor) -> tuple:
    return (x2d.new_empty(x2d.shape, dtype=torch.int8),
            x2d.new_empty((x2d.shape[0], 1), dtype=torch.float32))


def shape_hop_add_quant_i8(q2d: torch.Tensor, s: torch.Tensor, a2d: torch.Tensor) -> tuple:
    return shape_quant_i8(a2d)


def shape_hop_accum_i8(q2d: torch.Tensor, s: torch.Tensor, a2d: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(a2d)


def shape_hop_add_quant_bf16(w2d: torch.Tensor, a2d: torch.Tensor) -> torch.Tensor:
    return a2d.new_empty(a2d.shape, dtype=torch.bfloat16)


def shape_hop_accum_bf16(w2d: torch.Tensor, a2d: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(a2d)


def _check(name: str, cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"{name} takes {what}")


def pack_transposed(x2d: torch.Tensor, dp: int, buckets: int,
                    wire_dtype: torch.dtype) -> torch.Tensor:
    """(dp*buckets, seg) f32 -> (buckets, dp, seg) in ``wire_dtype``."""
    if x2d.dtype != torch.float32 or x2d.ndim != 2 or x2d.shape[0] != dp * buckets:
        raise ValueError(f"pack_transposed takes ({dp}*{buckets}, seg) float32, "
                         f"got {tuple(x2d.shape)} {x2d.dtype}")
    if wire_dtype not in _WIRE_DTYPES:
        raise ValueError(f"wire dtype must be one of {_WIRE_DTYPES}, got {wire_dtype}")
    _, fn = kernels.resolve("ring_wire.pack_transposed", x2d)
    return fn(x2d, dp, buckets, wire_dtype)


def unpack_transposed(x3d: torch.Tensor) -> torch.Tensor:
    """(buckets, dp, seg) f32/bf16 -> (dp*buckets, seg) f32."""
    if x3d.ndim != 3 or x3d.dtype not in _WIRE_DTYPES:
        raise ValueError(f"unpack_transposed takes (buckets, dp, seg) float32 or "
                         f"bfloat16, got {tuple(x3d.shape)} {x3d.dtype}")
    _, fn = kernels.resolve("ring_wire.unpack_transposed", x3d)
    return fn(x3d)


def pack_transposed_ef(x2d: torch.Tensor, e2d: torch.Tensor, dp: int,
                       buckets: int) -> tuple:
    """((dp*buckets, seg) f32 grads, same-shape f32 residual) -> ((buckets,
    dp, seg) bf16 wire, (dp*buckets, seg) f32 new residual)."""
    _check("pack_transposed_ef",
           x2d.dtype == e2d.dtype == torch.float32 and x2d.ndim == 2
           and x2d.shape == e2d.shape and x2d.shape[0] == dp * buckets
           and x2d.device == e2d.device,
           f"two ({dp}*{buckets}, seg) float32 tensors on one device, got "
           f"{tuple(x2d.shape)} {x2d.dtype} and {tuple(e2d.shape)} {e2d.dtype}")
    _, fn = kernels.resolve("ring_wire.pack_transposed_ef", x2d)
    return fn(x2d, e2d, dp, buckets)


def _check_blocks(name: str, x: torch.Tensor, dtype: torch.dtype) -> None:
    _check(name, x.ndim == 2 and x.shape[1] == WIRE_BLOCK and x.dtype == dtype,
           f"a (nb, {WIRE_BLOCK}) {dtype} view, got {tuple(x.shape)} {x.dtype}")


def _check_hop(name: str, q: torch.Tensor, qtype, s, a: torch.Tensor) -> None:
    _check_blocks(name, q, qtype)
    _check_blocks(name, a, torch.float32)
    same = [a.shape == q.shape, a.device == q.device]
    if s is not None:
        same += [s.shape == (q.shape[0], 1), s.dtype == torch.float32, s.device == q.device]
    _check(name, all(same), "a wire view, its scales (nb, 1) f32 and an addend "
           "of the wire's shape, on one device")


def quant_i8(x2d: torch.Tensor) -> tuple:
    """(nb, 128) f32 -> ((nb, 128) int8, (nb, 1) f32 scales)."""
    _check_blocks("quant_i8", x2d, torch.float32)
    _, fn = kernels.resolve("ring_wire.quant_i8", x2d)
    return fn(x2d)


def hop_add_quant_i8(q2d: torch.Tensor, s: torch.Tensor, a2d: torch.Tensor) -> tuple:
    """Middle ring hop: (codes, scales, local chunk) -> (codes', scales')."""
    _check_hop("hop_add_quant_i8", q2d, torch.int8, s, a2d)
    _, fn = kernels.resolve("ring_wire.hop_add_quant_i8", q2d)
    return fn(q2d, s, a2d)


def hop_accum_i8(q2d: torch.Tensor, s: torch.Tensor, a2d: torch.Tensor) -> torch.Tensor:
    """Last ring hop: dequantize and accumulate into f32."""
    _check_hop("hop_accum_i8", q2d, torch.int8, s, a2d)
    _, fn = kernels.resolve("ring_wire.hop_accum_i8", q2d)
    return fn(q2d, s, a2d)


def hop_add_quant_bf16(w2d: torch.Tensor, a2d: torch.Tensor) -> torch.Tensor:
    """Middle ring hop on the bf16 wire."""
    _check_hop("hop_add_quant_bf16", w2d, torch.bfloat16, None, a2d)
    _, fn = kernels.resolve("ring_wire.hop_add_quant_bf16", w2d)
    return fn(w2d, a2d)


def hop_accum_bf16(w2d: torch.Tensor, a2d: torch.Tensor) -> torch.Tensor:
    """Last ring hop on the bf16 wire: f32 out."""
    _check_hop("hop_accum_bf16", w2d, torch.bfloat16, None, a2d)
    _, fn = kernels.resolve("ring_wire.hop_accum_bf16", w2d)
    return fn(w2d, a2d)


#: kernel launches, counted by the ``cuda`` variants only
KERNELS = (pack_transposed, unpack_transposed, pack_transposed_ef, quant_i8,
           hop_add_quant_i8, hop_accum_i8, hop_add_quant_bf16, hop_accum_bf16)
for _k in KERNELS:
    _k.launches = 0
del _k


# -- eligibility (plan time) -------------------------------------------------
def pack_eligible(padded: int, dp: int, buckets: int) -> bool:
    """Can the pack/unpack kernels build the zero1 bucket parts?  The
    layout must divide; there is no size cap."""
    return padded > 0 and dp > 0 and buckets > 0 and padded % (dp * buckets) == 0


def wire_eligible(shape, dtype, compress: Optional[str]) -> bool:
    """Can the hop kernels carry this per-hop chunk?  A compressed wire
    (int8 or bf16), an f32 payload and a WIRE_BLOCK-divisible element
    count (the per-block scale layout); there is no size cap."""
    if compress not in ("int8", "bf16") or dtype != torch.float32:
        return False
    total = math.prod(int(d) for d in shape)
    return total > 0 and total % WIRE_BLOCK == 0


# -- shape-polymorphic forms (what the ring schedule and grad_sync call) ----
def _as_blocks(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, WIRE_BLOCK)


def quant(x: torch.Tensor, compress: str) -> tuple:
    """Quantize a chunk for the wire: ``(q, scales)`` with ``q`` of ``x``'s
    shape (int8 or bf16) and ``scales`` the (nb, 1) per-block scales
    (``None`` on the bf16 wire, which is a bare cast as in the reference)."""
    if compress == "bf16":
        return x.to(torch.bfloat16), None
    q, s = quant_i8(_as_blocks(x))
    return q.reshape(x.shape), s


def hop_add_quant(q: torch.Tensor, scales, addend: torch.Tensor, compress: str) -> tuple:
    """Middle-hop update: dequantize + add the local chunk + re-quantize."""
    if compress == "bf16":
        return hop_add_quant_bf16(_as_blocks(q), _as_blocks(addend)).reshape(q.shape), None
    q2, s2 = hop_add_quant_i8(_as_blocks(q), scales, _as_blocks(addend))
    return q2.reshape(q.shape), s2


def hop_accum(q: torch.Tensor, scales, addend: torch.Tensor, compress: str) -> torch.Tensor:
    """Final-hop update: dequantize + add the local chunk, f32 out."""
    if compress == "bf16":
        o = hop_accum_bf16(_as_blocks(q), _as_blocks(addend))
    else:
        o = hop_accum_i8(_as_blocks(q), scales, _as_blocks(addend))
    return o.reshape(addend.shape)


def pack_parts(flat: torch.Tensor, dp: int, buckets: int,
               wire_dtype: torch.dtype) -> list:
    """Fused ``_transposed_bucket_parts`` + wire cast: ``flat`` (padded,) f32
    -> ``buckets`` parts of ``(padded // buckets,)`` in ``wire_dtype``."""
    seg = flat.shape[0] // (dp * buckets)
    out = pack_transposed(flat.reshape(dp * buckets, seg), dp, buckets, wire_dtype)
    return [out[b].reshape(-1) for b in range(buckets)]


def pack_parts_ef(flat: torch.Tensor, ef: torch.Tensor, dp: int, buckets: int) -> tuple:
    """Fused error-feedback fold + bf16 cast + residual + bucket gather:
    ``(parts, new_ef)`` — ``parts`` as in :func:`pack_parts` (bf16),
    ``new_ef`` the (padded,) f32 residual ``(g + ef) - f32(wire)``."""
    seg = flat.shape[0] // (dp * buckets)
    out, new_ef = pack_transposed_ef(flat.reshape(dp * buckets, seg),
                                     ef.reshape(dp * buckets, seg), dp, buckets)
    return [out[b].reshape(-1) for b in range(buckets)], new_ef.reshape(-1)


def unpack_gathers(outs, dp: int) -> torch.Tensor:
    """Fused ``_interleave_bucket_gathers``: per-bucket all-gather outputs
    (each ``(padded // buckets,)``) back to one (padded,) f32 vector."""
    seg = outs[0].shape[0] // dp
    x3d = torch.stack([o.reshape(dp, seg) for o in outs])
    return unpack_transposed(x3d).reshape(-1)
