"""Wrappers of the flash-attention kernel — what the model's
``attention_impl="flash"`` path calls.

:func:`flash_attention` takes the kernel's layout, q (BH, S, D) and k/v
(BKV, S, D); :func:`flash_mha` takes the model's, q (B, S, H, D) and k/v
(B, S, Hkv, D), with the reference's head order (``ops.py:22-24`` there:
batch-major, then heads, so the query heads of one kv group are
contiguous).  The wrapper checks what the kernel takes, then runs the
variant the kernel registry (:mod:`repro_torch.kernels`) holds for the
tensor's device: on a CUDA tensor :func:`launch_flash_attention`, which
launches one kernel on the current stream (raising if the launch is
refused) and adds one to ``flash_attention.launches``; on a CPU tensor
:func:`.ref.attention_ref`.  Any other device raises, and nothing falls
back from a CUDA tensor to the plain version.

Two hand-written kernels compute the function, chosen by the inputs' dtype
(:func:`route`): bf16 runs ``csrc/flash_attention_wgmma.cu`` on the tensor
cores (wgmma on TMA-fed tiles, P carried as two bf16 terms), f32 runs
``csrc/flash_attention.cu`` on the CUDA cores (TF32 products would break
the f32 tolerance of 2e-5).  The choice is made before the launch, never
after a failed one.  ``flash_attention.by_entry`` counts the launches of
each entry point.

Unlike the reference's ``flash_mha``, nothing pads S to the block size:
the kernel masks keys at or past S itself, so a non-causal call with a
ragged S computes ``attention_ref``'s function (the reference lets its
zero padding into the softmax there).  The reference's ``block_q`` /
``block_k`` tiling arguments are not taken: the CUDA kernels' tiles are
constants of their sources.

The reference defines no gradient for this kernel (``jax.grad`` of its
``flash_mha`` fails), so both variants run inside an autograd function
whose backward raises: the forward path is the only one.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ... import kernels
from .. import _build

_CSRC = Path(__file__).with_name("csrc")
#: the f32 kernel (CUDA cores)
SOURCES = (_CSRC / "flash_attention.cu",)
#: the bf16 kernel (tensor cores)
WGMMA_SOURCES = (_CSRC / "flash_attention_wgmma.cu",)

#: head dims the kernels take: multiples of 8 up to 256
MAX_HEAD_DIM = 256
#: query tiles of 64 rows sit on the grid's y axis, which CUDA caps at 65535
MAX_SEQ = 64 * 65535

_P, _N = ctypes.c_void_p, ctypes.c_longlong
_ARGS = [_P, _P, _P, _P, _N, _N, _N, _N, ctypes.c_int, _P]


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention", SOURCES)
    lib.pax_flash_attention.argtypes = _ARGS
    lib.pax_flash_attention.restype = ctypes.c_int
    return lib


def _wgmma_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_wgmma", WGMMA_SOURCES)
    lib.pax_flash_attention_wgmma.argtypes = _ARGS
    lib.pax_flash_attention_wgmma.restype = ctypes.c_int
    return lib


#: input dtype -> the entry point it launches and the loader of its library
ROUTES = {torch.bfloat16: ("pax_flash_attention_wgmma", _wgmma_lib),
          torch.float32: ("pax_flash_attention", _lib)}


def _check_head_dim(D: int) -> None:
    if D % 8 or not 8 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes a head dim that is a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}, got {D}")


def route(dtype: torch.dtype) -> str:
    """The entry point that CUDA inputs of ``dtype`` launch: the
    tensor-core kernel for bf16, the CUDA-core kernel for f32."""
    if dtype not in ROUTES:
        raise ValueError(f"flash_attention takes float32 or bfloat16, got {dtype}")
    return ROUTES[dtype][0]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (TMA's requirement)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           causal: bool = True) -> torch.Tensor:
    """The ``cuda`` variant of :func:`flash_attention`: one kernel launch,
    of the entry point :func:`route` names for the inputs' dtype."""
    q, k, v = (_aligned(t) for t in (q, k, v))
    BH, S, D = q.shape
    entry, load = ROUTES[q.dtype]
    out = torch.empty_like(q)
    _build.launch(load, entry, (q, k, v, out), BH, k.shape[0], S, D, int(causal))
    flash_attention.launches += 1
    flash_attention.by_entry[entry] += 1
    return out


def shape_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True) -> torch.Tensor:
    """The shape-only variant (a ``FakeTensor``): the kernel's empty
    output, no launch."""
    return torch.empty_like(q)


_NO_BACKWARD = ("flash_attention has no backward: the reference defines no gradient for "
                "this kernel (jax.grad of its flash_mha fails); train with "
                "attention_impl='xla' or 'blockwise'")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (BH, S, D); k/v: (BKV, S, D), BH % BKV == 0 -> (BH, S, D) in q's
    dtype.  f32 or bf16 (all three alike), D a multiple of 8 up to 256."""
    shapes_ok = (q.ndim == k.ndim == v.ndim == 3 and k.shape == v.shape
                 and k.shape[0] > 0 and q.shape[0] % k.shape[0] == 0
                 and q.shape[1:] == k.shape[1:] and 1 <= q.shape[1] <= MAX_SEQ)
    if not shapes_ok or not q.dtype == k.dtype == v.dtype or q.dtype not in ROUTES:
        raise ValueError(
            "flash_attention takes q (BH, S, D) and k, v (BKV, S, D) with BH % BKV == 0, "
            f"1 <= S <= {MAX_SEQ}, all float32 or all bfloat16; got {tuple(q.shape)} "
            f"{q.dtype}, {tuple(k.shape)} {k.dtype}, {tuple(v.shape)} {v.dtype}")
    _check_head_dim(q.shape[2])
    if not q.device == k.device == v.device:
        raise ValueError(f"flash_attention takes q, k, v on one device, got {q.device}, "
                         f"{k.device}, {v.device}")
    _, fn = kernels.resolve("flash_attention", q)
    return kernels.forward_only(_NO_BACKWARD, fn, q, k, v, causal=causal)


flash_attention.launches = 0  # counted by the ``cuda`` variant only
flash_attention.by_entry = {entry: 0 for entry, _ in ROUTES.values()}  # the same, by entry point


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """q: (B, S, H, D); k/v: (B, S, Hkv, D) -> (B, S, H, D)."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    qf = q.transpose(1, 2).reshape(B * H, S, D)
    kf = k.transpose(1, 2).reshape(B * Hkv, S, D)
    vf = v.transpose(1, 2).reshape(B * Hkv, S, D)
    out = flash_attention(qf, kf, vf, causal=causal)
    return out.reshape(B, H, S, D).transpose(1, 2)
