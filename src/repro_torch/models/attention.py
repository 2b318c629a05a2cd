"""Grouped-query attention for training (full sequence, causal).

The reference's plain path (``attention_impl="xla"``): QKV projections
with optional bias, RoPE on q and k, scores in f32 scaled by 1/sqrt(D),
a causal mask of ``-1e30``, softmax in f32 and probabilities cast back to
the query dtype before they weight the values.  Supports MHA / GQA / MQA
through ``num_kv_heads``.  The cached and paged forms arrive with serving.
"""
from __future__ import annotations

import math

import torch

from .common import apply_rope


def _project_qkv(p: dict, x: torch.Tensor, cfg):
    hd = cfg.resolved_head_dim
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    B, S = x.shape[0], x.shape[1]
    return (q.reshape(B, S, cfg.num_heads, hd),
            k.reshape(B, S, cfg.num_kv_heads, hd),
            v.reshape(B, S, cfg.num_kv_heads, hd))


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
          q_offset: int = 0) -> torch.Tensor:
    """q: (B,Sq,Hq,D), k/v: (B,Skv,Hkv,D) with Hq = G*Hkv."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float()
    scores = scores / math.sqrt(D)
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(Skv, device=q.device)[None, :]
        scores = torch.where(qpos >= kpos, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, Hq, D)


def attention(p: dict, x: torch.Tensor, cfg, *, positions: torch.Tensor,
              causal: bool = True) -> torch.Tensor:
    """One layer's attention block on (B, S, d) -> (B, S, d)."""
    if cfg.attention_impl != "xla":
        raise NotImplementedError(
            f"attention_impl={cfg.attention_impl!r} is not ported yet")
    q, k, v = _project_qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    out = _sdpa(q, k, v, causal=causal)
    out = out.reshape(*x.shape[:2], -1)
    return out @ p["wo"].to(x.dtype)
