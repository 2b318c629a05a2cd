"""Wrapper of the WKV6 scan kernel — what the rwkv6 family's time-mix
calls on the full sequence (``models/rwkv.py:time_mix`` with no state).

:func:`wkv6_apply` takes the model layout, r, k, v and wlog (B, T, H, N)
and u (H, N), as the reference's ``wkv6_apply`` does, and returns
y (B, T, H, N) in float32 (float64 from float64 inputs, which only the
plain version takes: a float64 model's scan on the CPU).  It casts to
float32, checks what the kernel takes, then runs the variant the kernel
registry (:mod:`repro_torch.kernels`) holds for the tensors' device: on a
CUDA tensor :func:`launch_wkv6`, which launches ``csrc/wkv6_wgmma.cu`` (entry point :data:`ENTRY`: the four
products of every chunk as 3xTF32 wgmma on the tensor cores) on the current
stream (raising if the launch is refused) and adds one to
``wkv6_apply.launches``; on a CPU tensor :func:`.ref.wkv6`.  Any other
device raises, and nothing falls back from a CUDA tensor to the plain
version.

Unlike the reference's wrapper, nothing is transposed to (B*H, T, N): the
kernel reads the model layout in place, one (b, h) per thread block, at any
4-byte aligned base, so the wrapper copies only what is not already
contiguous float32.

The gradient.  The reference has no Pallas backward: it trains through its
lax ``wkv6_chunked``, and XLA differentiates that.  Both variants here run
inside ``kernels.plain_gradient``, an autograd function whose forward is the
registry's variant (the kernel on a CUDA tensor, one launch counted) and
whose backward recomputes the plain chunked form from a zero state
(:func:`.ref.wkv6`) under ``enable_grad`` and takes its gradient with
respect to r, k, v, wlog and u: the same function differentiated the same
way as the reference.  A backward kernel is ROADMAP queue 2's.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ... import kernels
from .. import _build
from . import ref

SOURCES = (Path(__file__).with_name("csrc") / "wkv6_wgmma.cu",)
#: the C entry point that :func:`launch_wkv6` calls
ENTRY = "pax_wkv6_wgmma"

#: head widths N and chunk lengths the kernel takes: each is zero-padded to
#: one tile of 64 channels and of 32 or 64 steps
MAX_HEAD_DIM = 64
MAX_CHUNK = 64

_P, _N = ctypes.c_void_p, ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = _build.load("wkv6", SOURCES)
    getattr(lib, ENTRY).argtypes = [_P] * 6 + [_N] * 5 + [_P]
    getattr(lib, ENTRY).restype = ctypes.c_int
    lib.pax_wkv6_wgmma_blocks_per_sm.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.pax_wkv6_wgmma_blocks_per_sm.restype = ctypes.c_int
    return lib


def blocks_per_sm() -> int:
    """Blocks of the kernel at N = 64, chunk 32 that one SM of the current
    card holds at once (its registers and shared memory as built)."""
    n = ctypes.c_int(0)
    rc = _lib().pax_wkv6_wgmma_blocks_per_sm(ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"pax_wkv6_wgmma_blocks_per_sm failed: CUDA error {rc}")
    return n.value


def launch_wkv6(r, k, v, wlog, u, *, chunk: int) -> torch.Tensor:
    """The ``cuda`` variant of :func:`wkv6_apply`: one kernel launch on
    contiguous float32 tensors."""
    if r.dtype != torch.float32:
        raise ValueError(f"the wkv6 kernel takes float32, got {r.dtype}")
    y = torch.empty_like(r)
    _build.launch(_lib, ENTRY, (r, k, v, wlog, u, y), *r.shape, chunk)
    wkv6_apply.launches += 1
    return y


def shape_wkv6(r, k, v, wlog, u, *, chunk: int) -> torch.Tensor:
    """The shape-only variant (a ``FakeTensor``): the kernel's empty
    output, no launch."""
    return torch.empty_like(v)


def wkv6_apply(r, k, v, wlog, u, *, chunk: int = 32) -> torch.Tensor:
    """r, k, v, wlog: (B, T, H, N); u: (H, N) -> y (B, T, H, N) float32
    (float64 from float64), the WKV6 scan from a zero state.  N and chunk
    in [1, 64], T a positive multiple of chunk."""
    tensors = (r, k, v, wlog, u)
    shapes_ok = (r.ndim == 4 and k.shape == v.shape == wlog.shape == r.shape
                 and u.shape == r.shape[2:] and r.shape[0] * r.shape[2] > 0)
    if not shapes_ok or not all(t.is_floating_point() for t in tensors):
        raise ValueError("wkv6_apply takes floating r, k, v, wlog (B, T, H, N) and u (H, N); "
                         f"got {[tuple(t.shape) for t in tensors]}, "
                         f"{[t.dtype for t in tensors]}")
    T, N = r.shape[1], r.shape[3]
    if not (1 <= N <= MAX_HEAD_DIM and 1 <= chunk <= MAX_CHUNK and T > 0 and T % chunk == 0):
        raise ValueError(f"wkv6_apply takes N and chunk in [1, {MAX_CHUNK}] and T a positive "
                         f"multiple of chunk; got N={N}, chunk={chunk}, T={T}")
    if any(t.device != r.device for t in tensors):
        raise ValueError(f"wkv6_apply takes tensors on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    _, fn = kernels.resolve("rwkv6_scan", r)
    # the casts stay outside the Function, so the gradient reaches bf16 inputs
    dtype = torch.float64 if r.dtype == torch.float64 else torch.float32
    return kernels.plain_gradient(fn, ref.wkv6,
                                  *(t.to(dtype).contiguous() for t in tensors), chunk=chunk)


wkv6_apply.launches = 0  # counted by the ``cuda`` variant only
