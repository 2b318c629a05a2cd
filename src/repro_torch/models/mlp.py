"""Dense FFN variants: GLU (swiglu/geglu) and plain (gelu/relu²/silu).

Weights are ``(in, out)`` and multiply as ``x @ W``, the reference layout,
so a weight moves between the packages unchanged.
"""
from __future__ import annotations

import torch

from .common import GLU_ACTIVATIONS, activation_fn, is_glu


def mlp_shapes(d: int, f: int, activation: str, dtype, lead: tuple = ()) -> dict:
    """Parameter shapes of one FFN, stacked on ``lead``."""
    out = {"wi": ((*lead, d, f), dtype), "wo": ((*lead, f, d), dtype)}
    if is_glu(activation):
        out["wg"] = ((*lead, d, f), dtype)
    return out


def spec_mlp(activation: str, fsdp, tp) -> dict:
    if is_glu(activation):
        return {"wi": (fsdp, tp), "wg": (fsdp, tp), "wo": (tp, fsdp)}
    return {"wi": (fsdp, tp), "wo": (tp, fsdp)}


def mlp(p: dict, x: torch.Tensor, activation: str) -> torch.Tensor:
    """``p``: one layer's weights (``wi``, ``wo`` and, for GLU, ``wg``)."""
    if is_glu(activation):
        act = activation_fn(GLU_ACTIVATIONS[activation])
        h = act(x @ p["wg"].to(x.dtype)) * (x @ p["wi"].to(x.dtype))
    else:
        h = activation_fn(activation)(x @ p["wi"].to(x.dtype))
    return h @ p["wo"].to(x.dtype)
