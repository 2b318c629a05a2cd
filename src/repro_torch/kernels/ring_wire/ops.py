"""Wrappers of the zero1 wire-layout kernels — what ``grad_sync`` calls.

Each wrapper checks what the kernel takes, then runs the variant that the
kernel registry (:mod:`repro_torch.kernels`) holds for the tensor's
device: on a CUDA tensor the ``launch_*`` function, which launches the
CUDA kernel of ``csrc/ring_wire.cu`` on the current stream (raising if the
launch is refused) and adds one to the wrapper's ``launches`` count; on a
CPU tensor the plain version in :mod:`.ref`.  Any other device raises.
There is no fallback from a CUDA tensor to the plain version.

:func:`pack_eligible` is evaluated at plan time.  It keeps the reference's
divisibility rule and drops its size cap: the reference's no-grid Pallas
kernel holds the whole payload in the TPU's VMEM, while the Hopper kernel
streams over a grid and takes any size.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ... import kernels
from .. import _build

SOURCES = (Path(__file__).with_name("csrc") / "ring_wire.cu",)

#: grid rows are one per (rank, bucket) pair; CUDA caps gridDim.y here
_MAX_ROWS = 65535

_WIRE_DTYPES = (torch.float32, torch.bfloat16)


def _lib() -> ctypes.CDLL:
    lib = _build.load("ring_wire", SOURCES)
    for fn in (lib.pax_pack_transposed, lib.pax_unpack_transposed):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _launch(fn_name: str, x: torch.Tensor, out: torch.Tensor, dp: int,
            buckets: int, seg: int, bf16: bool) -> None:
    if x.device.type != "cuda" or out.device != x.device:
        raise ValueError(f"{fn_name} takes CUDA tensors, got {x.device} -> {out.device}")
    if dp * buckets > _MAX_ROWS:
        raise ValueError(f"dp*buckets={dp * buckets} exceeds {_MAX_ROWS} grid rows")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(_lib(), fn_name)(x.data_ptr(), out.data_ptr(), dp,
                                      buckets, seg, int(bf16), stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {rc}")


def launch_pack_transposed(x2d: torch.Tensor, dp: int, buckets: int,
                           wire_dtype: torch.dtype) -> torch.Tensor:
    """The ``cuda`` variant of :func:`pack_transposed`: one kernel launch."""
    x2d = x2d.contiguous()
    seg = x2d.shape[1]
    out = torch.empty((buckets, dp, seg), dtype=wire_dtype, device=x2d.device)
    _launch("pax_pack_transposed", x2d, out, dp, buckets, seg,
            wire_dtype == torch.bfloat16)
    pack_transposed.launches += 1
    return out


def launch_unpack_transposed(x3d: torch.Tensor) -> torch.Tensor:
    """The ``cuda`` variant of :func:`unpack_transposed`: one kernel launch."""
    x3d = x3d.contiguous()
    buckets, dp, seg = x3d.shape
    out = torch.empty((dp * buckets, seg), dtype=torch.float32, device=x3d.device)
    _launch("pax_unpack_transposed", x3d, out, dp, buckets, seg,
            x3d.dtype == torch.bfloat16)
    unpack_transposed.launches += 1
    return out


def pack_transposed(x2d: torch.Tensor, dp: int, buckets: int,
                    wire_dtype: torch.dtype) -> torch.Tensor:
    """(dp*buckets, seg) f32 -> (buckets, dp, seg) in ``wire_dtype``."""
    if x2d.dtype != torch.float32 or x2d.ndim != 2 or x2d.shape[0] != dp * buckets:
        raise ValueError(f"pack_transposed takes ({dp}*{buckets}, seg) float32, "
                         f"got {tuple(x2d.shape)} {x2d.dtype}")
    if wire_dtype not in _WIRE_DTYPES:
        raise ValueError(f"wire dtype must be one of {_WIRE_DTYPES}, got {wire_dtype}")
    _, fn = kernels.resolve("ring_wire.pack_transposed", x2d.device)
    return fn(x2d, dp, buckets, wire_dtype)


def unpack_transposed(x3d: torch.Tensor) -> torch.Tensor:
    """(buckets, dp, seg) f32/bf16 -> (dp*buckets, seg) f32."""
    if x3d.ndim != 3 or x3d.dtype not in _WIRE_DTYPES:
        raise ValueError(f"unpack_transposed takes (buckets, dp, seg) float32 or "
                         f"bfloat16, got {tuple(x3d.shape)} {x3d.dtype}")
    _, fn = kernels.resolve("ring_wire.unpack_transposed", x3d.device)
    return fn(x3d)


#: kernel launches, counted by the ``cuda`` variants only
pack_transposed.launches = 0
unpack_transposed.launches = 0


def pack_eligible(padded: int, dp: int, buckets: int) -> bool:
    """Can the pack/unpack kernels build the zero1 bucket parts?  The
    layout must divide; there is no size cap."""
    return padded > 0 and dp > 0 and buckets > 0 and padded % (dp * buckets) == 0


def pack_parts(flat: torch.Tensor, dp: int, buckets: int,
               wire_dtype: torch.dtype) -> list:
    """Fused ``_transposed_bucket_parts`` + wire cast: ``flat`` (padded,) f32
    -> ``buckets`` parts of ``(padded // buckets,)`` in ``wire_dtype``."""
    seg = flat.shape[0] // (dp * buckets)
    out = pack_transposed(flat.reshape(dp * buckets, seg), dp, buckets, wire_dtype)
    return [out[b].reshape(-1) for b in range(buckets)]


def unpack_gathers(outs, dp: int) -> torch.Tensor:
    """Fused ``_interleave_bucket_gathers``: per-bucket all-gather outputs
    (each ``(padded // buckets,)``) back to one (padded,) f32 vector."""
    seg = outs[0].shape[0] // dp
    x3d = torch.stack([o.reshape(dp, seg) for o in outs])
    return unpack_transposed(x3d).reshape(-1)
