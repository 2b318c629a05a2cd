"""Mamba2 (SSD, state-space duality) block, as zamba2-2.7b uses it: the
full-sequence form (training, prefill) and the one-token decode over the
conv and SSM states.

Per head h (scalar decay a_t = exp(dt_t * A_h), A_h < 0):

    state[p, n] <- a_t * state[p, n] + dt_t * x_t[p] * B_t[n]
    y_t[p]      =  state[p, n] . C_t[n]  + D_h * x_t[p]

The full-sequence form runs it from a zero state and drops the final
state.  The reference runs it in lax (``ssd_chunked``); the port runs the
SSD kernel through ``kernels/mamba2_ssd/ops.ssd_apply``: the CUDA kernel on
a CUDA tensor, the plain chunked version on the CPU, and in the backward
the plain chunked form's gradient (the reference's lax gradient).

Decode (``mamba_block(..., state=MambaState)``) keeps the last K - 1 conv
inputs (in the compute dtype) as a rolling window and the SSM state
(float32), advanced by ``ssd_step``; no kernel runs.

On the model axis (``mamba_block(..., par=)`` where the layer splits) a
rank holds 1/model_axis of ``in_proj``'s columns, of the conv's channels
and of ``out_proj``'s rows, as the reference's ``spec_mamba_layer`` does,
but per segment (:func:`mamba_segments`): its ``d_inner / R`` columns of
z and of x, its ``N / R`` of B and of C and its ``H / R`` of dt, so its
heads' x, dt and gate and its share of B and C come out of one product.
After the causal conv the ranks' B and C are all-gathered (every head
reads all of them); the scan runs on the rank's heads; ``out_norm`` (an
RMSNorm over the whole ``d_inner``) all-reduces the rank's sum of squares
forward and backward (``tensor_parallel.sum_over``); ``out_proj``'s
partial output leaves through ``reduce_from``.  The decode state holds the
rank's conv channels (per segment) and SSM heads.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..kernels.mamba2_ssd.ops import ssd_apply
from ..kernels.mamba2_ssd.ref import ssd_chunked  # noqa: F401  (the reference's name)
from ..runtime.device import resolve_device
from .common import (apply_norm, dense_init_, dtype_of, norm, norm_shapes, normal_init_,
                     spec_norm)
from .tensor_parallel import Part, TensorParallel, gather, held_layout, is_split, sum_over


class MambaState(NamedTuple):
    conv: torch.Tensor  # (B, K-1, d_inner + 2N) rolling conv input window, compute dtype
    ssm: torch.Tensor   # (B, H, P, N) float32


def _dims(cfg):
    d = cfg.d_model
    s = cfg.ssm
    d_inner = s.expand * d
    return d, d_inner, d_inner // s.head_dim, s.head_dim, s.state_size


def mamba_layer_shapes(cfg, dtype, L: int) -> tuple[dict, dict]:
    """(the stacked parameters' shapes, the stacked norms' shapes) of ``L``
    Mamba2 layers; x, B and C all go through the causal conv."""
    d, d_inner, H, _, N = _dims(cfg)
    f32, conv_ch = torch.float32, d_inner + 2 * N
    params = {
        "in_proj": ((L, d, 2 * d_inner + 2 * N + H), dtype),   # -> [z, x, B, C, dt]
        "conv_w": ((L, cfg.ssm.conv_kernel, conv_ch), dtype),
        "conv_b": ((L, conv_ch), dtype),
        "A_log": ((L, H), f32), "D": ((L, H), f32), "dt_bias": ((L, H), f32),
        "out_proj": ((L, d_inner, d), dtype),
    }
    norms = {"norm": norm_shapes((L, d), cfg.norm),
             "out_norm": norm_shapes((L, d_inner), "rmsnorm")}
    return params, norms


def mamba_segments(cfg) -> dict:
    """Leaf -> the sizes its model-axis dimension concatenates: ``in_proj``'s
    columns ``[z, x, B, C, dt]`` and the conv's channels ``[x, B, C]``."""
    _, d_inner, H, _, N = _dims(cfg)
    conv = (d_inner, N, N)
    return {"in_proj": (d_inner, d_inner, N, N, H), "conv_w": conv, "conv_b": conv}


def mamba_divides(cfg, R: int) -> bool:
    """Does a model axis of ``R`` split a Mamba2 layer: whole heads and
    the state's B and C channels divide it (then ``d_inner`` does)."""
    _, _, H, _, N = _dims(cfg)
    return H % R == 0 and N % R == 0


def spec_mamba_layer(cfg, fsdp, tp) -> dict:
    """One Mamba2 layer's parameter specs (the reference's)."""
    return {
        "norm": spec_norm(cfg.norm),
        "in_proj": (fsdp, tp),
        "conv_w": (None, tp),
        "conv_b": (tp,),
        "A_log": (None,),
        "D": (None,),
        "dt_bias": (None,),
        "out_norm": spec_norm("rmsnorm"),
        "out_proj": (tp, fsdp),
    }


@torch.no_grad()
def init_mamba_param_(leaf: str, p: torch.Tensor, gen: torch.Generator, cfg,
                      **block) -> None:
    """One stacked Mamba2 parameter with the reference's initial values
    (``mamba.py:39-56`` there): the deterministic ``A_log`` =
    log(linspace(1, 16, H)), ``D`` = 1 and ``dt_bias`` = log(e - 1) (so
    softplus(dt_bias) = 1), conv weights N(0, 0.1), zero conv bias,
    N(0,1)/sqrt(in) projections with ``out_proj`` scaled by 1/sqrt(2L);
    ``block``: a rank's block of the draw (``tensor_parallel.draw_block``)."""
    H = p.shape[-1]
    if leaf == "A_log":
        p.copy_(torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32)).expand_as(p))
    elif leaf == "D":
        p.fill_(1.0)
    elif leaf == "dt_bias":
        p.fill_(math.log(math.e - 1))
    elif leaf == "conv_w":
        normal_init_(p, gen, 0.1, **block)
    elif leaf == "conv_b":
        p.zero_()
    elif leaf == "out_proj":
        dense_init_(p, gen, scale=1.0 / math.sqrt(2 * cfg.num_layers), **block)
    elif leaf == "in_proj":
        dense_init_(p, gen, **block)
    else:
        raise KeyError(f"not a Mamba2 parameter: {leaf!r}")


def _causal_conv(x, w, b):
    """Depthwise causal conv via shifts. x: (B, T, C); w: (K, C)."""
    K = w.shape[0]
    y = x * w[K - 1]
    for i in range(1, K):
        shifted = F.pad(x, (0, 0, i, 0))[:, : x.shape[1]]
        y = y + shifted * w[K - 1 - i]
    return F.silu(y + b)


def ssd_step(x, dt, A, B, C, D, state):
    """x: (B, H, P); dt: (B, H); B, C: (B, N); state: (B, H, P, N)."""
    a = torch.exp(dt * A[None, :])
    upd = torch.einsum("bhp,bn->bhpn", x * dt[..., None], B)
    state = a[..., None, None] * state + upd
    y = torch.einsum("bhpn,bn->bhp", state, C) + x * D[None, :, None]
    return y, state


def mamba_block(p: dict, x, cfg, chunk: int | None = None, state: MambaState | None = None,
                par: Optional[TensorParallel] = None):
    """x: (B, T, d) -> (B, T, d): the SSD scan from a zero state through the
    kernel registry.  With ``state``, x is one token (B, 1, d) and the
    result is (output, new state): the conv over the window of the stored
    inputs and this one, then ``ssd_step``.  As in the reference, the
    layer's ``norm`` is not applied here.  Where ``par`` splits the layer,
    ``p`` and ``state`` hold the rank's block (the module's docstring)."""
    d, d_inner, H, Pd, N = _dims(cfg)
    chunk = chunk or cfg.ssm.chunk_size
    split = par is not None and par.splits("layers.in_proj")
    R, r = (par.part.tp_size, par.part.tp_rank) if split else (1, 0)
    di, n, h = d_inner // R, N // R, H // R
    if split:
        x = par.enter(x, True)
    B_, T, _ = x.shape
    proj = x @ p["in_proj"].to(x.dtype)
    z, xin, Bc, Cc, dt = torch.split(proj, [di, di, n, n, h], dim=-1)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)
    w, b = p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype)
    if state is None:
        conv_out = _causal_conv(conv_in, w, b)
    else:
        window = torch.cat([state.conv, conv_in], dim=1)  # (B, K, C)
        conv_out = F.silu((window * w[None]).sum(1, keepdim=True) + b)
    xc, Bc, Cc = torch.split(conv_out, [di, n, n], dim=-1)
    if split:  # every head reads the whole B and C: the ranks' channels gathered
        bc = gather(torch.cat([Bc, Cc], dim=-1), par.tp_group, -1)
        bc = bc.reshape(B_, T, R, 2, n)
        Bc, Cc = bc[..., 0, :].reshape(B_, T, N), bc[..., 1, :].reshape(B_, T, N)
    heads = slice(r * h, (r + 1) * h)
    xh = xc.reshape(B_, T, h, Pd).float()
    dtp = F.softplus(dt.float() + p["dt_bias"][heads])
    A = -torch.exp(p["A_log"][heads])
    D = p["D"][heads]
    if state is None:
        y = ssd_apply(xh, dtp, A, Bc.float(), Cc.float(), D, chunk=chunk)
    else:
        y, S = ssd_step(xh[:, 0], dtp[:, 0], A, Bc[:, 0].float(), Cc[:, 0].float(), D,
                        state.ssm)
        y = y[:, None]
    y = y.reshape(B_, T, di).to(x.dtype)
    if split:
        # the statistic spans every rank's columns: its sum of squares is
        # all-reduced forward and backward (each rank's feeds its own columns)
        y = apply_norm(p["out_norm"]["scale"][r * di:(r + 1) * di], y, "rmsnorm",
                       reduce=lambda s: sum_over(s, par.tp_group), width=d_inner)
    else:
        y = norm(p["out_norm"], y, "rmsnorm")
    out = (y * F.silu(z)) @ p["out_proj"].to(x.dtype)
    if split:
        out = par.leave(out, True)
    return out if state is None else (out, MambaState(window[:, 1:], S))


def init_mamba_state(cfg, batch: int, device=None, layers: int | None = None,
                     model_axis: int = 1) -> MambaState:
    """The zero state of one Mamba2 layer for ``batch`` sequences, or with
    ``layers`` every layer's, stacked on a leading axis; on ``model_axis``
    ranks whose layers split, a rank's conv channels and SSM heads."""
    _, d_inner, H, Pd, N = _dims(cfg)
    R = model_axis if model_axis > 1 and is_split(
        held_layout(cfg, Part(0, model_axis))["layers.in_proj"]) else 1
    dev = resolve_device(device)
    lead = () if layers is None else (layers,)
    return MambaState(
        torch.zeros((*lead, batch, cfg.ssm.conv_kernel - 1, (d_inner + 2 * N) // R),
                    dtype=dtype_of(cfg.compute_dtype), device=dev),
        torch.zeros((*lead, batch, H // R, Pd, N), dtype=torch.float32, device=dev))


def mamba_state_specs() -> MambaState:
    """The reference's specs of one layer's decode state: batch over the
    data axes, the conv's channels and the SSM state's heads over the
    model axis."""
    return MambaState((("pod", "data"), None, "model"), (("pod", "data"), "model", None, None))
