"""Kernel registry: one place that answers "CUDA kernel or plain torch?".

Callers name a kernel; the variant is chosen by the tensor it will run on:
``cuda`` for a CUDA tensor (the hand-written kernel, which is launched or
raises — there is no fallback), ``torch`` for a CPU tensor that holds data
(the plain PyTorch version beside the kernel), and ``shape`` for a
``FakeTensor``, which holds no data — the dry run (``launch/dryrun.py``)
runs the program on them — and gets empty outputs of the kernel's shapes
and dtypes, no arithmetic (the plain version's would misstate what the
kernel moves: the plain ``pack_transposed`` at dp=1 is a view).  A tensor
on any other device (``meta`` too) raises.  Registration is lazy —
targets are ``"module:attr"`` strings resolved on first use — so importing
:mod:`repro_torch.kernels` builds and loads nothing.
"""
from __future__ import annotations

import importlib
from typing import Any

import torch

VARIANTS = ("cuda", "torch", "shape")

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


def variant_for(x) -> str:
    """``"shape"`` for a ``FakeTensor`` (no data), else by the tensor's
    device (or for a device): ``"cuda"`` for a CUDA device, ``"torch"`` for
    the CPU; any other device has no implementation and raises."""
    if isinstance(x, torch.Tensor):
        from torch._subclasses.fake_tensor import FakeTensor

        if isinstance(x, FakeTensor):
            return "shape"
        x = x.device
    kind = torch.device(x).type
    if kind == "cuda":
        return "cuda"
    if kind == "cpu":
        return "torch"
    raise ValueError(f"no kernel variant for device type {kind!r}: kernels "
                     "take CUDA or CPU tensors")


def resolve(name: str, x):
    """-> ``(variant, fn)`` for the tensor ``x`` (or a device,
    :func:`variant_for`).  Raises when the variant it calls for is not
    registered (never substitutes)."""
    variant = variant_for(x)
    fn = get(name, variant)
    if fn is None:
        raise LookupError(f"kernel {name!r} has no {variant!r} variant")
    return variant, fn


class _ForwardOnly(torch.autograd.Function):
    @staticmethod
    def forward(ctx, why, fn, kwargs, *tensors):
        ctx.why = why
        return fn(*tensors, **kwargs)

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(ctx.why)


def forward_only(why: str, fn, *tensors, **kwargs):
    """``fn(*tensors, **kwargs)`` under autograd with a backward that raises
    ``why``.  The kernels are forward only: without this, the output of a
    CUDA launch would carry no ``grad_fn`` and a gradient through it would
    be silently zero."""
    return _ForwardOnly.apply(why, fn, kwargs, *tensors)


class _PlainGradient(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fn, plain, kwargs, *tensors):
        ctx.plain, ctx.kwargs = plain, kwargs
        ctx.save_for_backward(*tensors)
        return fn(*tensors, **kwargs)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = ctx.plain(*inputs, **ctx.kwargs)
        return (None, None, None, *torch.autograd.grad(out, inputs, grad))


def plain_gradient(fn, plain, *tensors, **kwargs):
    """``fn(*tensors, **kwargs)`` forward (the kernel on a CUDA tensor) under
    autograd with the gradient of ``plain``, the same function in plain
    torch: the backward saves the inputs, recomputes ``plain`` on them under
    ``enable_grad`` and returns its gradient with respect to every one.
    A kernel without a backward of its own trains so, as the reference's
    lax forms do under XLA's autodiff."""
    return _PlainGradient.apply(fn, plain, kwargs, *tensors)


# -- built-in kernels (lazy: nothing imports until first resolve) -----------
# The wrappers in ring_wire/ops.py, flash_attention/ops.py, rwkv6_scan/ops.py
# and mamba2_ssd/ops.py resolve through here by their tensor: the CUDA
# launch for a CUDA tensor, the plain version for a CPU one, the shape-only
# variant (``shape_*`` beside each launch) for a FakeTensor.
RING_WIRE_KERNELS = ("pack_transposed", "unpack_transposed", "pack_transposed_ef",
                     "quant_i8", "hop_add_quant_i8", "hop_accum_i8",
                     "hop_add_quant_bf16", "hop_accum_bf16")
for _name in RING_WIRE_KERNELS:
    register(f"ring_wire.{_name}", "cuda",
             f"repro_torch.kernels.ring_wire.ops:launch_{_name}")
    register(f"ring_wire.{_name}", "torch", f"repro_torch.kernels.ring_wire.ref:{_name}")
    register(f"ring_wire.{_name}", "shape", f"repro_torch.kernels.ring_wire.ops:shape_{_name}")
del _name
register("flash_attention", "cuda",
         "repro_torch.kernels.flash_attention.ops:launch_flash_attention")
register("flash_attention", "torch", "repro_torch.kernels.flash_attention.ref:attention_ref")
register("flash_attention", "shape",
         "repro_torch.kernels.flash_attention.ops:shape_flash_attention")
register("rwkv6_scan", "cuda", "repro_torch.kernels.rwkv6_scan.ops:launch_wkv6")
register("rwkv6_scan", "torch", "repro_torch.kernels.rwkv6_scan.ref:wkv6")
register("rwkv6_scan", "shape", "repro_torch.kernels.rwkv6_scan.ops:shape_wkv6")
register("mamba2_ssd", "cuda", "repro_torch.kernels.mamba2_ssd.ops:launch_ssd")
register("mamba2_ssd", "torch", "repro_torch.kernels.mamba2_ssd.ref:ssd")
register("mamba2_ssd", "shape", "repro_torch.kernels.mamba2_ssd.ops:shape_ssd")
