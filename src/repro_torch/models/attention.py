"""Grouped-query attention for the full-sequence forward (train / prefill
without a cache).

QKV projections with optional bias and RoPE on q and k, then one of the
reference's three causal paths, chosen by ``cfg.attention_impl``:

* ``"xla"``: scores in f32 scaled by 1/sqrt(D), a causal mask of
  ``-1e30``, softmax in f32 and probabilities cast back to the query dtype
  before they weight the values (:func:`_sdpa`);
* ``"blockwise"``: the same per query block of ``BLOCKWISE_Q`` rows
  against only its causal key prefix (:func:`_sdpa_blockwise`);
* ``"flash"``: the flash-attention kernel through the kernel registry
  (``kernels/flash_attention/ops.py:flash_mha``), forward only.

Supports MHA / GQA / MQA through ``num_kv_heads``.  The cached and paged
forms arrive with serving.
"""
from __future__ import annotations

import math

import torch

from ..kernels.flash_attention.ops import flash_mha
from .common import apply_rope

ATTENTION_IMPLS = ("xla", "blockwise", "flash")


def attention_shapes(cfg, dtype, lead: tuple = ()) -> dict:
    """Parameter shapes of one attention block, stacked on ``lead``."""
    hd, nq, nkv, d = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads, cfg.d_model
    out = {"wq": ((*lead, d, nq * hd), dtype), "wk": ((*lead, d, nkv * hd), dtype),
           "wv": ((*lead, d, nkv * hd), dtype), "wo": ((*lead, nq * hd, d), dtype)}
    if cfg.qkv_bias:
        out.update(bq=((*lead, nq * hd), dtype), bk=((*lead, nkv * hd), dtype),
                   bv=((*lead, nkv * hd), dtype))
    return out


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


BLOCKWISE_Q = 512


def _sdpa_blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    block_q: int = BLOCKWISE_Q) -> torch.Tensor:
    """Causal attention per query block against only its causal key prefix
    (about half the score FLOPs of :func:`_sdpa`, one (block_q x prefix)
    score tile live at a time).  As in the reference, the block widens
    until there are at most 16 blocks, and a sequence that the block does
    not divide, or that fits in one block, takes :func:`_sdpa`."""
    S = q.shape[1]
    while S // block_q > 16:
        block_q *= 2
    if S % block_q or S <= block_q:
        return _sdpa(q, k, v, causal=True)
    outs = [_sdpa(q[:, i:i + block_q], k[:, :i + block_q], v[:, :i + block_q], causal=True,
                  q_offset=i)
            for i in range(0, S, block_q)]
    return torch.cat(outs, dim=1)


def attention(p: dict, x: torch.Tensor, cfg, *, positions: torch.Tensor,
              causal: bool = True) -> torch.Tensor:
    """One layer's attention block on (B, S, d) -> (B, S, d)."""
    if cfg.attention_impl not in ATTENTION_IMPLS:
        raise ValueError(f"attention_impl must be one of {ATTENTION_IMPLS}, "
                         f"got {cfg.attention_impl!r}")
    q, k, v = _project_qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    if causal and cfg.attention_impl == "blockwise":
        out = _sdpa_blockwise(q, k, v)
    elif causal and cfg.attention_impl == "flash":
        # the registry's variant for q's device; unlike the reference's
        # _flash_or_sdpa there is no lax fallback: a device with no variant raises
        out = flash_mha(q, k, v, causal=True)
    else:
        out = _sdpa(q, k, v, causal=causal)
    out = out.reshape(*x.shape[:2], -1)
    return out @ p["wo"].to(x.dtype)
