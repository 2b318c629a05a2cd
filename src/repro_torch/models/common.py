"""Shared model building blocks: norms, activations, RoPE, embeddings,
initializers and the loss — the reference's (``repro.models.common``) math,
operation for operation, on tensors.

Numbers that matter for parity with the reference: RMSNorm computes in f32
with ``eps=1e-6`` and its scales stay f32 in a bf16 model; RoPE
frequencies are f32 and the rotation runs in the activation dtype; the loss
is a token mean over f32 logits with a ``z_loss=1e-4`` term.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# initializers (the reference's distributions; its random bits differ).  The
# numbers come from a CPU generator, so one seed gives the same weights on
# every device.
# ---------------------------------------------------------------------------
def dense_init_(w: torch.Tensor, gen: torch.Generator, scale: float = 1.0) -> None:
    """Fill ``w`` (…, in, out) with N(0, 1) * scale / sqrt(in)."""
    std = scale / math.sqrt(w.shape[-2])
    w.copy_(torch.randn(w.shape, generator=gen) * std)


def embed_init_(w: torch.Tensor, gen: torch.Generator) -> None:
    w.copy_(torch.randn(w.shape, generator=gen) * 0.02)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def apply_norm(scale: torch.Tensor, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6, bias: torch.Tensor | None = None) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * scale.float()
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * scale.float() + bias.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------
def activation_fn(name: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
        "relu2": lambda x: torch.square(F.relu(x)),
    }[name]


GLU_ACTIVATIONS = {"swiglu": "silu", "geglu": "gelu"}


def is_glu(name: str) -> bool:
    return name in GLU_ACTIVATIONS


# ---------------------------------------------------------------------------
# RoPE (full or partial fraction)
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, fraction: float, theta: float, device=None):
    rot_dim = int(head_dim * fraction) // 2 * 2
    inv = 1.0 / (theta ** (torch.arange(0, rot_dim, 2, dtype=torch.float32,
                                        device=device) / rot_dim))
    return inv, rot_dim


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    head_dim = x.shape[-1]
    inv, rot_dim = rope_frequencies(head_dim, fraction, theta, x.device)
    if rot_dim == 0:
        return x
    ang = positions[..., :, None].float() * inv  # (..., seq, rot/2)
    cos = torch.cos(ang)[..., :, None, :].to(x.dtype)  # broadcast over heads
    sin = torch.sin(ang)[..., :, None, :].to(x.dtype)
    xr, xp = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    xr = torch.stack([r1, r2], dim=-1).reshape(xr.shape)
    return torch.cat([xr, xp], dim=-1) if rot_dim < head_dim else xr


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------
def embed_tokens(tok: torch.Tensor, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    return F.embedding(tokens, tok.to(compute_dtype))


def unembed(tok: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: ``x @ tok.T``."""
    return x @ tok.t().to(x.dtype)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def softmax_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                          ignore_id: int = -1, z_loss: float = 1e-4) -> torch.Tensor:
    """Token-mean CE with z-loss; fp32 reduction."""
    logits = logits.float()
    mask = (targets != ignore_id).float()
    tclip = targets.clamp_min(0).long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, tclip[..., None])[..., 0]
    nll = (lse - ll) * mask
    zl = z_loss * torch.square(lse) * mask
    denom = torch.clamp_min(mask.sum(), 1.0)
    return (nll.sum() + zl.sum()) / denom
