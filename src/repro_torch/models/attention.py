"""Grouped-query attention: the full-sequence forward (train / prefill
without a cache), the cached decode and the paged serving path.

QKV projections with optional bias and RoPE on q and k, then one of the
reference's three causal paths, chosen by ``cfg.attention_impl``:

* ``"xla"``: scores in f32 scaled by 1/sqrt(D), a causal mask of
  ``-1e30``, softmax in f32 and probabilities cast back to the query dtype
  before they weight the values (:func:`_sdpa`);
* ``"blockwise"``: the same per query block of ``BLOCKWISE_Q`` rows
  against only its causal key prefix (:func:`_sdpa_blockwise`);
* ``"flash"``: the flash-attention kernel through the kernel registry
  (``kernels/flash_attention/ops.py:flash_mha``), forward only.

Supports MHA / GQA / MQA through ``num_kv_heads``, and cross-attention
to precomputed encoder K/V (``cross_kv``, always :func:`_sdpa`).

The cached forms follow the reference's ``_sdpa_decode``: scores by an
einsum in the compute dtype, cast to f32 and scaled, a ``-1e30`` mask of
the positions a query may not see, an f32 softmax cast back, then the
einsum with the values.  ``attention(kv_cache=, cache_index=)`` writes the
new K/V rows into a contiguous cache; :func:`attention_paged` scatters them
into fixed-size pages through per-request block tables and attends through
the same tables.  Unlike the reference, which returns updated copies, both
write the cache in place and return it.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..kernels.flash_attention.ops import flash_mha
from .common import apply_rope

ATTENTION_IMPLS = ("xla", "blockwise", "flash")


class KVCache(NamedTuple):
    k: torch.Tensor  # (batch, max_seq, kv_heads, head_dim), or pages (see paged_update)
    v: torch.Tensor


def attention_shapes(cfg, dtype, lead: tuple = ()) -> dict:
    """Parameter shapes of one attention block, stacked on ``lead``."""
    hd, nq, nkv, d = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads, cfg.d_model
    out = {"wq": ((*lead, d, nq * hd), dtype), "wk": ((*lead, d, nkv * hd), dtype),
           "wv": ((*lead, d, nkv * hd), dtype), "wo": ((*lead, nq * hd, d), dtype)}
    if cfg.qkv_bias:
        out.update(bq=((*lead, nq * hd), dtype), bk=((*lead, nkv * hd), dtype),
                   bv=((*lead, nkv * hd), dtype))
    return out


def spec_attention(cfg, fsdp, tp) -> dict:
    """Projections over ``tp`` only where whole heads divide the
    production model axis (``parallelism.tp_size``), else replicated over
    it (Megatron's GQA/MQA practice)."""
    ts = cfg.parallelism.tp_size
    q_tp = tp if ts and cfg.num_heads % ts == 0 else None
    kv_tp = tp if ts and cfg.num_kv_heads % ts == 0 else None
    p = {"wq": (fsdp, q_tp), "wk": (fsdp, kv_tp), "wv": (fsdp, kv_tp), "wo": (q_tp, fsdp)}
    if cfg.qkv_bias:
        p.update({"bq": (q_tp,), "bk": (kv_tp,), "bv": (kv_tp,)})
    return p


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
    # the heads the weights hold: all of them, or a rank's under tensor parallelism
    return q.reshape(B, S, -1, hd), k.reshape(B, S, -1, hd), v.reshape(B, S, -1, hd)


def _kv_select(t: torch.Tensor, kv_heads: Optional[list]) -> torch.Tensor:
    """The K/V heads (axis 2) a rank's query heads read: all (None), a
    contiguous run, or one per query head."""
    if kv_heads is None:
        return t
    lo = kv_heads[0]
    if kv_heads == list(range(lo, lo + len(kv_heads))):
        return t.narrow(2, lo, len(kv_heads))
    return t.index_select(2, torch.tensor(kv_heads, device=t.device))


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
              causal: bool = True, kv_cache: Optional[KVCache] = None,
              cache_index: int = 0, cross_kv: Optional[tuple] = None,
              kv_heads: Optional[list] = None):
    """One layer's attention block on (B, S, d) -> (B, S, d).

    With ``kv_cache`` (one layer's (B, max_seq, Hkv, D) cache) the new K/V
    rows are written at ``cache_index`` onward, every query attends to the
    cache positions up to its own (``cache_index + i``), and the result is
    ``(out, kv_cache)``; without one it is ``out``.  With ``cross_kv =
    (k, v)``, each (B, Skv, Hkv, D), it is cross-attention (the encoder-
    decoder's): q from ``wq`` alone, no bias and no RoPE, every query
    attending to all ``Skv`` keys through :func:`_sdpa`, whatever
    ``attention_impl`` says; the result is ``out``.

    Under tensor parallelism ``p`` holds a rank's heads (the projections'
    columns, ``wo``'s rows): q, k and v carry the heads the weights give,
    and ``kv_heads`` names the K/V heads the rank's query heads read where
    the query heads split and the K/V heads do not (the cache, and
    ``cross_kv``, then hold every K/V head)."""
    if cfg.attention_impl not in ATTENTION_IMPLS:
        raise ValueError(f"attention_impl must be one of {ATTENTION_IMPLS}, "
                         f"got {cfg.attention_impl!r}")
    if cross_kv is not None:
        q = (x @ p["wq"].to(x.dtype)).reshape(*x.shape[:2], -1, cfg.resolved_head_dim)
        k, v = (_kv_select(t, kv_heads) for t in cross_kv)
        out = _sdpa(q, k, v, causal=False).reshape(*x.shape[:2], -1)
        return out @ p["wo"].to(x.dtype)
    q, k, v = _project_qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    if kv_cache is not None:
        Sq = x.shape[1]
        kv_cache.k[:, cache_index:cache_index + Sq] = k.to(kv_cache.k.dtype)
        kv_cache.v[:, cache_index:cache_index + Sq] = v.to(kv_cache.v.dtype)
        qpos = cache_index + torch.arange(Sq, device=x.device)[:, None]
        kpos = torch.arange(kv_cache.k.shape[1], device=x.device)[None, :]
        out = _sdpa_decode(q, _kv_select(kv_cache.k, kv_heads),
                           _kv_select(kv_cache.v, kv_heads), kpos <= qpos)
        out = out.reshape(*x.shape[:2], -1)
        return out @ p["wo"].to(x.dtype), kv_cache
    k, v = _kv_select(k, kv_heads), _kv_select(v, kv_heads)
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


def _sdpa_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """``valid``: (Sq, Skv) shared across the batch, or (B, Sq, Skv) per
    request (the paged path, where each row's length differs)."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(q.dtype)).float()
    scores = scores / math.sqrt(D)
    mask = valid[None, None, None] if valid.ndim == 2 else valid[:, None, None]
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(q.dtype))
    return out.reshape(B, Sq, Hq, D)


# ---------------------------------------------------------------------------
# Paged KV: blocks are (block_size, Hkv, D) slabs of one page tensor
# (num_blocks, block_size, Hkv, D) per side, and a request's block table
# maps its logical page j to the physical block table[b, j]
# (serve/kv_cache.py owns the allocator; block 0 is the reserved null block).
# ---------------------------------------------------------------------------
def paged_update(k_pages: torch.Tensor, v_pages: torch.Tensor, k_new: torch.Tensor,
                 v_new: torch.Tensor, block_table: torch.Tensor,
                 positions: torch.Tensor) -> None:
    """Scatter the new K/V rows (B, S, Hkv, D), already rotated, into their
    pages in place: position ``positions[b, s]`` of request ``b`` lands at
    offset ``pos % block_size`` of block ``block_table[b, pos // block_size]``.

    Live rows own their blocks, so their writes never collide.  Inactive
    rows (length 0, an all-null table) all write offset 0 of the null
    block; on CUDA the order of such duplicate writes is unspecified, which
    is harmless because no live row reads the null block: its table entries
    past the request's own pages point there, and the ``kpos <= qpos`` mask
    of :func:`paged_attention` hides every position they cover."""
    bs = k_pages.shape[1]
    pos = positions.long()
    blk = torch.gather(block_table.long(), 1, pos // bs)
    off = pos % bs
    k_pages.index_put_((blk, off), k_new.to(k_pages.dtype))
    v_pages.index_put_((blk, off), v_new.to(v_pages.dtype))


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                    block_table: torch.Tensor, qpos: torch.Tensor) -> torch.Tensor:
    """Attention of the rotated queries (B, Sq, Hq, D) at absolute
    positions ``qpos`` (B, Sq) over the pages named by ``block_table``
    (B, W).  The gather lays each request's W pages out in logical order,
    so key ``j`` of the gathered view is position ``j`` of the sequence,
    and the mask ``kpos <= qpos`` hides the unwritten tail and the null
    block's padding at once."""
    B, W = block_table.shape
    bs = k_pages.shape[1]
    tbl = block_table.long()
    k = k_pages[tbl].reshape(B, W * bs, *k_pages.shape[2:])
    v = v_pages[tbl].reshape(B, W * bs, *v_pages.shape[2:])
    kpos = torch.arange(W * bs, dtype=torch.int32, device=q.device)
    valid = kpos[None, None, :] <= qpos[:, :, None]  # (B, Sq, W*bs)
    return _sdpa_decode(q, k, v, valid)


def attention_paged(p: dict, x: torch.Tensor, cfg, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_table: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
    """One attention block over a paged cache on (B, Sq, d) at absolute
    ``positions`` (B, Sq): project, rotate, write the new K/V rows into
    their pages, then attend through the block table (write-then-attend: a
    token sees itself and every predecessor in its chunk)."""
    q, k, v = _project_qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    paged_update(k_pages, v_pages, k, v, block_table, positions)
    out = paged_attention(q, k_pages, v_pages, block_table, positions)
    out = out.reshape(*x.shape[:2], -1)
    return out @ p["wo"].to(x.dtype)


def init_kv_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
                  device=None, *, layers: Optional[int] = None,
                  kv_heads: Optional[int] = None) -> KVCache:
    """One layer's zeroed (batch, max_seq, Hkv, D) cache, or with ``layers``
    every layer's, stacked on a leading axis; bfloat16 by default whatever
    the model's dtypes, as in the reference.  The paged slab is the same
    shape with (num_blocks, block_size) for (batch, max_seq).  ``kv_heads``:
    the heads a rank holds (default all)."""
    shape = (() if layers is None else (layers,)) + (
        batch, max_seq, kv_heads or cfg.num_kv_heads, cfg.resolved_head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))
