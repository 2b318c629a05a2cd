"""Kernel registry: one place that answers "CUDA kernel or plain torch?".

Callers name a kernel; the variant is chosen by the device of the tensors
it will run on: ``cuda`` for a CUDA device (the hand-written kernel, which
is launched or raises — there is no fallback), ``torch`` for the CPU (the
plain PyTorch version beside the kernel).  Registration is lazy —
targets are ``"module:attr"`` strings resolved on first use — so importing
:mod:`repro_torch.kernels` builds and loads nothing.
"""
from __future__ import annotations

import importlib
from typing import Any

import torch

VARIANTS = ("cuda", "torch")

#: name -> variant -> lazy "module[:attr]" target
_REGISTRY: dict[str, dict[str, Any]] = {}


def register(name: str, variant: str, target: Any) -> None:
    """Register a kernel implementation.  ``target`` is a callable or a
    lazy ``"module[:attr]"`` string resolved on first :func:`get`."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown kernel variant {variant!r}")
    _REGISTRY.setdefault(name, {})[variant] = target


def get(name: str, variant: str):
    """The registered implementation, resolved lazily; None if absent."""
    target = _REGISTRY.get(name, {}).get(variant)
    if target is None:
        return None
    if isinstance(target, str):
        mod_name, _, attr = target.partition(":")
        mod = importlib.import_module(mod_name)
        target = getattr(mod, attr) if attr else mod
        _REGISTRY[name][variant] = target
    return target


def variant_for(device) -> str:
    """``"cuda"`` for a CUDA device, ``"torch"`` for the CPU; any other
    device has no implementation and raises."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "cuda"
    if kind == "cpu":
        return "torch"
    raise ValueError(f"no kernel variant for device type {kind!r}: kernels "
                     "take CUDA or CPU tensors")


def resolve(name: str, device):
    """-> ``(variant, fn)`` for tensors on ``device``.  Raises when the
    variant the device calls for is not registered (never substitutes)."""
    variant = variant_for(device)
    fn = get(name, variant)
    if fn is None:
        raise LookupError(f"kernel {name!r} has no {variant!r} variant")
    return variant, fn


# -- built-in kernels (lazy: nothing imports until first resolve) -----------
# The wrappers in ring_wire/ops.py resolve through here by their tensor's
# device: the CUDA launch for a CUDA tensor, the plain version for a CPU one.
register("ring_wire.pack_transposed", "cuda",
         "repro_torch.kernels.ring_wire.ops:launch_pack_transposed")
register("ring_wire.pack_transposed", "torch",
         "repro_torch.kernels.ring_wire.ref:pack_transposed")
register("ring_wire.unpack_transposed", "cuda",
         "repro_torch.kernels.ring_wire.ops:launch_unpack_transposed")
register("ring_wire.unpack_transposed", "torch",
         "repro_torch.kernels.ring_wire.ref:unpack_transposed")
