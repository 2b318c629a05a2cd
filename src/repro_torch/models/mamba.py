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
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..kernels.mamba2_ssd.ops import ssd_apply
from ..kernels.mamba2_ssd.ref import ssd_chunked  # noqa: F401  (the reference's name)
from ..runtime.device import resolve_device
from .common import dense_init_, dtype_of, norm, norm_shapes, normal_init_, spec_norm


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
def init_mamba_param_(leaf: str, p: torch.Tensor, gen: torch.Generator, cfg) -> None:
    """One stacked Mamba2 parameter with the reference's initial values
    (``mamba.py:39-56`` there): the deterministic ``A_log`` =
    log(linspace(1, 16, H)), ``D`` = 1 and ``dt_bias`` = log(e - 1) (so
    softplus(dt_bias) = 1), conv weights N(0, 0.1), zero conv bias,
    N(0,1)/sqrt(in) projections with ``out_proj`` scaled by 1/sqrt(2L)."""
    H = p.shape[-1]
    if leaf == "A_log":
        p.copy_(torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32)).expand_as(p))
    elif leaf == "D":
        p.fill_(1.0)
    elif leaf == "dt_bias":
        p.fill_(math.log(math.e - 1))
    elif leaf == "conv_w":
        normal_init_(p, gen, 0.1)
    elif leaf == "conv_b":
        p.zero_()
    elif leaf == "out_proj":
        dense_init_(p, gen, scale=1.0 / math.sqrt(2 * cfg.num_layers))
    elif leaf == "in_proj":
        dense_init_(p, gen)
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


def mamba_block(p: dict, x, cfg, chunk: int | None = None, state: MambaState | None = None):
    """x: (B, T, d) -> (B, T, d): the SSD scan from a zero state through the
    kernel registry.  With ``state``, x is one token (B, 1, d) and the
    result is (output, new state): the conv over the window of the stored
    inputs and this one, then ``ssd_step``.  As in the reference, the
    layer's ``norm`` is not applied here."""
    d, d_inner, H, Pd, N = _dims(cfg)
    chunk = chunk or cfg.ssm.chunk_size
    B_, T, _ = x.shape
    proj = x @ p["in_proj"].to(x.dtype)
    z, xin, Bc, Cc, dt = torch.split(proj, [d_inner, d_inner, N, N, H], dim=-1)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)
    w, b = p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype)
    if state is None:
        conv_out = _causal_conv(conv_in, w, b)
    else:
        window = torch.cat([state.conv, conv_in], dim=1)  # (B, K, C)
        conv_out = F.silu((window * w[None]).sum(1, keepdim=True) + b)
    xc, Bc, Cc = torch.split(conv_out, [d_inner, N, N], dim=-1)
    xh = xc.reshape(B_, T, H, Pd).float()
    dtp = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    if state is None:
        y = ssd_apply(xh, dtp, A, Bc.float(), Cc.float(), p["D"], chunk=chunk)
    else:
        y, S = ssd_step(xh[:, 0], dtp[:, 0], A, Bc[:, 0].float(), Cc[:, 0].float(), p["D"],
                        state.ssm)
        y = y[:, None]
    y = y.reshape(B_, T, d_inner).to(x.dtype)
    y = norm(p["out_norm"], y, "rmsnorm") * F.silu(z)
    out = y @ p["out_proj"].to(x.dtype)
    return out if state is None else (out, MambaState(window[:, 1:], S))


def init_mamba_state(cfg, batch: int, device=None, layers: int | None = None) -> MambaState:
    """The zero state of one Mamba2 layer for ``batch`` sequences, or with
    ``layers`` every layer's, stacked on a leading axis."""
    _, d_inner, H, Pd, N = _dims(cfg)
    dev = resolve_device(device)
    lead = () if layers is None else (layers,)
    return MambaState(
        torch.zeros((*lead, batch, cfg.ssm.conv_kernel - 1, d_inner + 2 * N),
                    dtype=dtype_of(cfg.compute_dtype), device=dev),
        torch.zeros((*lead, batch, H, Pd, N), dtype=torch.float32, device=dev))
