"""Wrapper of the Mamba2 SSD kernel — what the Mamba2 block calls on the
full sequence (``models/mamba.py:mamba_block`` with no state).

:func:`ssd_apply` takes the model layout, as the reference's ``ssd_apply``
does: x (Bb, T, H, P), dt (Bb, T, H), A and D (H,), B and C (Bb, T, N)
shared by the heads (Mamba2 with one group), and returns y (Bb, T, H, P) in
float32.  It casts to float32, checks what the kernel takes, then runs the
variant the kernel registry (:mod:`repro_torch.kernels`) holds for the
tensors' device: on a CUDA tensor :func:`launch_ssd`, which launches
``csrc/ssd_wgmma.cu`` (entry point :data:`ENTRY`: the four products of
every chunk as 3xTF32 wgmma on the tensor cores) on the current stream
(raising if the launch is refused) and adds one to ``ssd_apply.launches``;
on a CPU tensor :func:`.ref.ssd`.
Any other device raises, and nothing falls back from a CUDA tensor to the
plain version.

Unlike the reference's wrapper, nothing is transposed and B, C are not
broadcast to every head: the kernel reads the model layout in place and
head ``bh`` reads batch row ``bh // H`` of B and C (at full zamba2 width the
broadcast copies would be 2 x 168 MB a layer).

After the scan the kernel's entry point :data:`NAN_ENTRY` runs the
non-finite pass: the scan's TF32 split is unscreened, so a NaN or inf input
can come out finite, and the pass writes NaN wherever the plain chunked
form is not finite (:func:`.ref.ssd_nonfinite_mask` is its rule: flags of
the non-finite inputs by chunk, OR-ed over the chunks so far).

The gradient.  The reference has no Pallas backward: it trains through its
lax ``ssd_chunked``, and XLA differentiates that.  Both variants here run
inside ``kernels.plain_gradient``, an autograd function whose forward is the
registry's variant (the kernel on a CUDA tensor, one launch counted) and
whose backward recomputes the plain chunked form from a zero state
(:func:`.ref.ssd`) under ``enable_grad`` and takes its gradient with
respect to x, dt, A, B, C and D.  A backward kernel is ROADMAP queue 2's.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ... import kernels
from .. import _build
from . import ref

SOURCES = (Path(__file__).with_name("csrc") / "ssd_wgmma.cu",)
#: the C entry points that :func:`launch_ssd` calls: the scan, then the
#: non-finite pass over its output
ENTRY = "pax_ssd_wgmma"
NAN_ENTRY = "pax_ssd_nan_pass"

#: head widths P, state widths N and chunk lengths the kernel takes: each is
#: zero-padded to one 64-wide tile in shared memory
MAX_HEAD_DIM = 64
MAX_STATE = 64
MAX_CHUNK = 64
#: at P = N = chunk = 64, float32 words of B's and C's split tiles per
#: (batch row, chunk): hi and lo of two 64 x 64 tiles, shared by the heads
SPLIT_TILE_WORDS = 4 * 64 * 64

_P, _N = ctypes.c_void_p, ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd", SOURCES)
    getattr(lib, ENTRY).argtypes = [_P] * 8 + [_N] * 6 + [_P]
    getattr(lib, ENTRY).restype = ctypes.c_int
    getattr(lib, NAN_ENTRY).argtypes = [_P] * 6 + [_N] * 6 + [_P]
    getattr(lib, NAN_ENTRY).restype = ctypes.c_int
    lib.pax_ssd_nan_flag_bytes.argtypes = [_N] * 5
    lib.pax_ssd_nan_flag_bytes.restype = ctypes.c_longlong
    lib.pax_ssd_wgmma_blocks_per_sm.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.pax_ssd_wgmma_blocks_per_sm.restype = ctypes.c_int
    return lib


def blocks_per_sm() -> int:
    """Blocks of the kernel that one SM of the current card holds at once
    (its registers and shared memory as built)."""
    n = ctypes.c_int(0)
    rc = _lib().pax_ssd_wgmma_blocks_per_sm(ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"pax_ssd_wgmma_blocks_per_sm failed: CUDA error {rc}")
    return n.value


def scan(x, dt, A, B, C, D, *, chunk: int) -> torch.Tensor:
    """The scan alone: one call of :data:`ENTRY` on contiguous float32
    tensors (at P = N = chunk = 64 it splits B and C once per batch row and
    chunk into a scratch buffer, then scans).  Finite inputs only; counted
    nowhere (``chip_smoke.py`` times the non-finite pass against it)."""
    Bb, T, _, Pd = x.shape
    N = B.shape[-1]
    full = Pd == N == chunk == MAX_CHUNK
    y = torch.empty_like(x)
    tiles = torch.empty(Bb * (T // chunk) * SPLIT_TILE_WORDS if full else 0, device=x.device)
    _build.launch(_lib, ENTRY, (x, dt, A, B, C, D, y, tiles), *x.shape, N, chunk)
    return y


def launch_ssd(x, dt, A, B, C, D, *, chunk: int) -> torch.Tensor:
    """The ``cuda`` variant of :func:`ssd_apply`: :func:`scan`, then the
    non-finite pass (:data:`NAN_ENTRY`) over its output."""
    y = scan(x, dt, A, B, C, D, chunk=chunk)
    Bb, T, H, Pd = x.shape
    flags = torch.empty(_lib().pax_ssd_nan_flag_bytes(Bb, T, H, Pd, chunk), dtype=torch.uint8,
                        device=x.device)
    _build.launch(_lib, NAN_ENTRY, (x, dt, B, C, y, flags), *x.shape, B.shape[-1], chunk)
    ssd_apply.launches += 1
    return y


def shape_ssd(x, dt, A, B, C, D, *, chunk: int) -> torch.Tensor:
    """The shape-only variant (a ``FakeTensor``): the kernel's empty
    output, no launch."""
    return torch.empty_like(x)


def ssd_apply(x, dt, A, B, C, D, *, chunk: int = 64) -> torch.Tensor:
    """x: (Bb, T, H, P); dt: (Bb, T, H); A, D: (H,); B, C: (Bb, T, N) ->
    y (Bb, T, H, P) float32, the SSD scan from a zero state.  P, N and chunk
    in [1, 64], T a positive multiple of chunk."""
    tensors = (x, dt, A, B, C, D)
    shapes_ok = (x.ndim == 4 and dt.shape == x.shape[:3] and A.shape == D.shape == x.shape[2:3]
                 and B.ndim == 3 and B.shape == C.shape and B.shape[:2] == x.shape[:2]
                 and x.shape[0] * x.shape[2] > 0)
    if not shapes_ok or not all(t.is_floating_point() for t in tensors):
        raise ValueError("ssd_apply takes floating x (Bb, T, H, P), dt (Bb, T, H), A and D (H,), "
                         f"B and C (Bb, T, N); got {[tuple(t.shape) for t in tensors]}, "
                         f"{[t.dtype for t in tensors]}")
    T, Pd, N = x.shape[1], x.shape[3], B.shape[2]
    if not (1 <= Pd <= MAX_HEAD_DIM and 1 <= N <= MAX_STATE and 1 <= chunk <= MAX_CHUNK
            and T > 0 and T % chunk == 0):
        raise ValueError(f"ssd_apply takes P, N and chunk in [1, {MAX_CHUNK}] and T a positive "
                         f"multiple of chunk; got P={Pd}, N={N}, chunk={chunk}, T={T}")
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"ssd_apply takes tensors on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    _, fn = kernels.resolve("mamba2_ssd", x)
    # the casts stay outside the Function, so the gradient reaches bf16 inputs
    return kernels.plain_gradient(fn, ref.ssd, *(t.float().contiguous() for t in tensors),
                                  chunk=chunk)


ssd_apply.launches = 0  # counted by the ``cuda`` variant only
