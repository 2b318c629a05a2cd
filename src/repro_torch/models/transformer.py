"""Dense and MoE decoder-only transformer LM (the qwen2, gemma, chatglm3
families and qwen2-moe, grok-1).

Parameters keep the reference's layout: every per-layer weight is stacked
on a leading ``L`` axis and multiplies as ``x @ W[l]`` with ``W`` shaped
``(in, out)``, and module names spell the reference's parameter-tree paths
(``layers.attn.wq``, ``final_norm.scale``...).  A reference pytree maps
onto the module by name alone (``model.from_jax_params``) and the ZeRO-1
flat vector can follow the reference's leaf order.

The reference scans the layers with optional rematerialisation; neither
changes a number, and here the layers run in a Python loop (:func:`_layers`,
the one layer body of every path, from an embedded residual).  With
``cfg.moe`` set each layer's FFN is the MoE block (``layers.moe.*``,
``models/moe.py``), the forward carries the sum of the layers' router aux
losses and the loss is cross-entropy plus that sum, as in the reference.
The layer body runs under ``maybe_remat`` for the moe family and for the
vlm (``models/vlm.py``), not for the dense family (:func:`_remat`).
Every function takes the ``dist`` the MoE block's expert parallelism runs
on (the dense FFN ignores it).

Serving: :func:`prefill` and :func:`decode_step` run on a contiguous
cache (:func:`init_cache`); :func:`prefill_chunk_paged` and
:func:`decode_step_paged` run on the paged slab (:func:`init_paged_cache`)
through per-request block tables.  Caches hold bfloat16 unless asked
otherwise, as in the reference, and are written in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from ..runtime.device import resolve_device
from .attention import (KVCache, attention, attention_paged, attention_shapes, init_kv_cache,
                        spec_attention)
from .common import (
    ParamBlock,
    dense_init_,
    dtype_of,
    embed_init_,
    embed_shapes,
    embed_tokens,
    maybe_remat,
    norm,
    norm_shapes,
    softmax_cross_entropy,
    spec_embedding,
    spec_norm,
    stack_specs,
    unembed,
)
from .mlp import mlp, mlp_shapes, spec_mlp
from .moe import expert_shards, moe_block, moe_shapes, spec_moe


class TransformerLM(nn.Module):
    """Parameters of the dense or MoE LM; the forward math is :func:`forward`.
    ``model_rank``/``model_axis``: under expert parallelism on a model axis
    of ``model_axis`` ranks, this rank's part of the experts only
    (``moe.expert_shards``); every other leaf whole."""

    #: the families this module's parameter tree builds
    FAMILIES = ("dense", "moe")

    def __init__(self, cfg, device, model_rank: int = 0, model_axis: int = 1) -> None:
        super().__init__()
        if cfg.family not in self.FAMILIES:
            raise ValueError(f"{type(self).__name__} builds the {' and '.join(self.FAMILIES)} "
                             f"families, got {cfg.family!r}")
        shards = expert_shards(cfg, model_axis)
        if not 0 <= model_rank < max(shards, 1) or (shards == 1 and model_rank):
            raise ValueError(f"model rank {model_rank} of {model_axis} holds no expert part")
        #: (this rank, the parts) of each layer's experts it holds
        self.expert_part = (model_rank, shards)
        L, d = cfg.num_layers, cfg.d_model
        pdt = dtype_of(cfg.param_dtype)
        self.embed = ParamBlock(embed_shapes(cfg, pdt), device)
        self.final_norm = ParamBlock(norm_shapes((d,), cfg.norm), device)
        self.layers = nn.Module()
        self.layers.attn = ParamBlock(attention_shapes(cfg, pdt, (L,)), device)
        self.layers.ln1 = ParamBlock(norm_shapes((L, d), cfg.norm), device)
        self.layers.ln2 = ParamBlock(norm_shapes((L, d), cfg.norm), device)
        if cfg.moe is not None:
            own, children = moe_shapes(cfg, pdt, (L,), shards)
            self.layers.moe = ParamBlock(own, device)
            for name, shapes in children.items():
                self.layers.moe.add_module(name, ParamBlock(shapes, device))
        else:
            self.layers.mlp = ParamBlock(mlp_shapes(d, cfg.d_ff, cfg.activation, pdt, (L,)),
                                         device)


def spec_layer(cfg, fsdp, tp) -> dict:
    """One layer's parameter specs (the reference's)."""
    p = {"ln1": spec_norm(cfg.norm), "attn": spec_attention(cfg, fsdp, tp),
         "ln2": spec_norm(cfg.norm)}
    if cfg.moe is not None:
        p["moe"] = spec_moe(cfg, fsdp, tp)
    else:
        p["mlp"] = spec_mlp(cfg.activation, fsdp, tp)
    return p


def spec_lm(cfg, fsdp="data", tp="model") -> dict:
    """Parameter specs with :class:`TransformerLM`'s keys; the stacked
    layer leaves lead with the layer axis (``None``)."""
    return {
        "embed": spec_embedding(cfg.tie_embeddings, tp, fsdp,
                                vocab=cfg.vocab_size, tp_size=cfg.parallelism.tp_size),
        "layers": stack_specs(spec_layer(cfg, fsdp, tp)),
        "final_norm": spec_norm(cfg.norm),
    }


@torch.no_grad()
def init_lm(cfg, seed: int, device, model_rank: int = 0, model_axis: int = 1) -> TransformerLM:
    """Random weights from ``seed`` (:func:`init_weights_`)."""
    return init_weights_(TransformerLM(cfg, device, model_rank, model_axis), cfg, seed)


@torch.no_grad()
def init_weights_(model: TransformerLM, cfg, seed: int) -> TransformerLM:
    """Fill ``model`` from ``seed`` with the reference's distributions:
    N(0,1)/sqrt(in) projections (``wo`` of attention further scaled by
    1/sqrt(2L)), N(0, 0.02) embeddings, zero biases, unit norm scales.  A
    model holding one rank's part of the experts holds those experts of
    the whole model's draw."""
    part = model.expert_part
    gen = torch.Generator().manual_seed(seed)
    for name, p in sorted(model.named_parameters()):
        leaf = name.rsplit(".", 1)[-1]
        if name.startswith("layers.moe.experts."):
            dense_init_(p, gen, part=part)
        elif name.startswith("embed."):
            if leaf == "tok":
                embed_init_(p, gen)
            else:
                dense_init_(p, gen)
        elif leaf == "scale":
            p.fill_(1.0)
        elif leaf in ("bias", "bq", "bk", "bv"):
            p.zero_()
        elif name == "layers.attn.wo":
            dense_init_(p, gen, scale=1.0 / math.sqrt(2 * cfg.num_layers))
        else:
            dense_init_(p, gen)
    return model


def _remat(cfg) -> str:
    """The layer bodies' remat: the config's, except for the dense family,
    whose layers run without it (ROADMAP queue 3; remat changes no number)."""
    return "none" if cfg.family == "dense" else cfg.parallelism.remat


def _embed(model: TransformerLM, tokens: torch.Tensor, cfg) -> torch.Tensor:
    return embed_tokens(model.embed.tok, tokens, dtype_of(cfg.compute_dtype))


def _layers(lay, x: torch.Tensor, cfg, attend, dist=None, remat: str = "none") -> tuple:
    """Every layer of ``lay`` on the residual ``x``: pre-norm attention
    (``attend(p, h, l)``, layer ``l``'s attention on its normed input: the
    forward's, a contiguous cache's or the pages'), then the pre-norm MLP
    or MoE block, each added; each layer body under ``maybe_remat(remat)``.
    Returns the residual and the layers' summed aux loss (None for the
    dense FFN)."""
    def body(p, xx, l):
        xx = xx + attend(p["attn"], norm(p["ln1"], xx, cfg.norm), l)
        h = norm(p["ln2"], xx, cfg.norm)
        if cfg.moe is None:
            return xx + mlp(p["mlp"], h, cfg.activation), None
        f, aux = moe_block(p["moe"], h, cfg, dist)
        return xx + f, aux

    body = maybe_remat(body, remat)
    auxes = []
    for l in range(cfg.num_layers):
        x, aux = body({name: node.layer(l) for name, node in lay.named_children()}, x, l)
        auxes.append(aux)
    return x, None if cfg.moe is None else torch.stack(auxes).sum()


def _trunk(model: TransformerLM, x: torch.Tensor, cfg, attend, dist=None) -> tuple:
    """:func:`_layers` over ``model``'s layers from the embedded residual
    ``x`` (the tokens' embedding, or the vlm's image tokens before it),
    under :func:`_remat`.  Returns the hidden state before the final norm
    and the summed aux loss."""
    return _layers(model.layers, x, cfg, attend, dist, _remat(cfg))


def _logits(model: TransformerLM, x: torch.Tensor, cfg) -> torch.Tensor:
    x = norm(model.final_norm.layer(), x, cfg.norm)
    return unembed(model.embed.layer(), x, cfg.tie_embeddings)


def _positions(start, n: int, batch: int, device) -> torch.Tensor:
    """(batch, n) int32 positions ``start .. start+n``."""
    return (int(start) + torch.arange(n, dtype=torch.int32, device=device))[None, :].expand(
        batch, n)


@torch.no_grad()
def stage_model(model: TransformerLM, cfg, stage: int, stages: int, device=None) -> tuple:
    """One pipeline stage of a dense (or vlm) ``model``: (the stage's
    config, a module of ``model``'s class holding layers ``[stage L/S,
    (stage+1) L/S)`` and every other leaf whole: the embedding, the final
    norm, the vlm's projector) on ``device``."""
    if cfg.moe is not None:
        raise ValueError("the pipeline stages run the dense family")
    L = cfg.num_layers
    if L % stages:
        raise ValueError(f"{L} layers do not split into {stages} stages")
    n = L // stages
    scfg = dataclasses.replace(cfg, num_layers=n)
    part = type(model)(scfg, resolve_device(device))
    whole = dict(model.named_parameters())
    for name, p in part.named_parameters():
        src = whole[name]
        p.copy_(src[stage * n:(stage + 1) * n] if name.startswith("layers.") else src)
    return scfg, part


def pipeline_fns(part: TransformerLM, cfg) -> tuple:
    """(embed_fn, layer_stack_fn, head_fn) of
    ``runtime.pipeline.pipelined_loss_fn`` over a stage model
    (:func:`stage_model`): the embedding of ``batch["tokens"]``, the
    stage's layers on a (mb, S, d) microbatch, and the final norm, the
    unembedding and the token-mean cross-entropy of ``batch["targets"]``."""
    def embed_fn(batch):
        return _embed(part, batch["tokens"], cfg)

    def layer_stack_fn(stage: TransformerLM, x):
        B, S = x.shape[:2]
        positions = _positions(0, S, B, x.device)
        return _layers(stage.layers, x, cfg, lambda p, h, l: attention(
            p, h, cfg, positions=positions, causal=True))[0]

    def head_fn(y, batch):
        return softmax_cross_entropy(_logits(part, y, cfg), batch["targets"])

    return embed_fn, layer_stack_fn, head_fn


def forward_aux(model: TransformerLM, tokens: torch.Tensor, cfg, last_only: bool = False,
                dist=None) -> tuple:
    """Full-sequence forward -> (logits (B, S, vocab), or (B, 1, vocab) with
    ``last_only``, which slices the residual to the final position before
    the final norm and the unembed (prefill needs one position); the summed
    aux loss, None for the dense FFN)."""
    B, S = tokens.shape
    positions = _positions(0, S, B, tokens.device)
    x, aux = _trunk(model, _embed(model, tokens, cfg), cfg, lambda p, h, l: attention(
        p, h, cfg, positions=positions, causal=True), dist)
    if last_only:
        x = x[:, -1:]
    return _logits(model, x, cfg), aux


def forward(model: TransformerLM, tokens: torch.Tensor, cfg, last_only: bool = False,
            dist=None) -> torch.Tensor:
    """:func:`forward_aux`'s logits."""
    return forward_aux(model, tokens, cfg, last_only, dist)[0]


def loss_fn(model: TransformerLM, batch: dict, cfg, dist=None) -> torch.Tensor:
    """Token-mean cross-entropy, plus the aux loss with the MoE block."""
    logits, aux = forward_aux(model, batch["tokens"], cfg, dist=dist)
    loss = softmax_cross_entropy(logits, batch["targets"])
    return loss if aux is None else loss + aux


# ---------------------------------------------------------------------------
# serving: prefill fills the cache; decode appends one token
# ---------------------------------------------------------------------------
def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16, device=None) -> KVCache:
    """The contiguous cache, (L, batch, max_seq, kv_heads, head_dim) per side."""
    return init_kv_cache(cfg, batch, max_seq, dtype, resolve_device(device),
                         layers=cfg.num_layers)


def _run_cached(model: TransformerLM, x: torch.Tensor, cache: KVCache, index: int,
                positions: torch.Tensor, cfg, dist) -> torch.Tensor:
    """The layers over a contiguous cache from the embedded residual ``x``,
    writing from position ``index``."""
    return _trunk(model, x, cfg, lambda p, h, l: attention(
        p, h, cfg, positions=positions, causal=True,
        kv_cache=KVCache(cache.k[l], cache.v[l]), cache_index=index)[0], dist)[0]


def decode_step(model: TransformerLM, token: torch.Tensor, cache: KVCache, index: int,
                cfg, dist=None) -> tuple:
    """token: (B, 1) int; ``index``: the position it is written at.
    Returns (logits (B, vocab), cache)."""
    B = token.shape[0]
    positions = torch.full((B, 1), int(index), dtype=torch.int32, device=token.device)
    x = _run_cached(model, _embed(model, token, cfg), cache, int(index), positions, cfg, dist)
    return _logits(model, x, cfg)[:, 0, :], cache


def prefill(model: TransformerLM, tokens: torch.Tensor, cfg, dist=None,
            max_seq: Optional[int] = None) -> tuple:
    """Run the prompt (B, S) into a fresh cache of ``max_seq`` positions
    (default the config's); returns (last logits (B, vocab), cache, S)."""
    B, S = tokens.shape
    cache = init_cache(cfg, B, max_seq or cfg.max_seq_len, device=tokens.device)
    x = _run_cached(model, _embed(model, tokens, cfg), cache, 0,
                    _positions(0, S, B, tokens.device), cfg, dist)
    return _logits(model, x[:, -1:, :], cfg)[:, 0, :], cache, S


# ---------------------------------------------------------------------------
# paged serving: decode and chunked prefill through per-request block tables
# (serve/ owns the allocator; this is the model side)
# ---------------------------------------------------------------------------
def init_paged_cache(cfg, num_blocks: int, block_size: int, dtype=torch.bfloat16,
                     device=None) -> KVCache:
    """The paged slab, (L, num_blocks, block_size, kv_heads, head_dim) per
    side.  Block 0 is the serving tier's reserved null block."""
    return init_kv_cache(cfg, num_blocks, block_size, dtype, resolve_device(device),
                         layers=cfg.num_layers)


def _run_paged(model: TransformerLM, tokens: torch.Tensor, pages: KVCache,
               block_tables: torch.Tensor, positions: torch.Tensor, cfg, dist) -> torch.Tensor:
    x = _trunk(model, _embed(model, tokens, cfg), cfg, lambda p, h, l: attention_paged(
        p, h, cfg, pages.k[l], pages.v[l], block_tables, positions), dist)[0]
    return _logits(model, x, cfg)


def decode_step_paged(model: TransformerLM, token: torch.Tensor, pages: KVCache,
                      block_tables: torch.Tensor, lengths: torch.Tensor, cfg,
                      dist=None) -> tuple:
    """One decode step: ``token`` (B, 1); ``block_tables`` (B, W) physical
    block ids; ``lengths`` (B,) tokens already cached per request — the new
    token is written at position ``lengths[b]`` and attends to
    ``0..lengths[b]``.  Inactive rows carry the null table and length 0.
    Returns (logits (B, vocab), pages)."""
    positions = lengths[:, None].to(torch.int32)
    return _run_paged(model, token, pages, block_tables, positions, cfg, dist)[:, 0, :], pages


def prefill_chunk_paged(model: TransformerLM, tokens: torch.Tensor, pages: KVCache,
                        block_tables: torch.Tensor, start: int, cfg, dist=None) -> tuple:
    """One prefill chunk: ``tokens`` (B, C) are positions ``start ..
    start+C`` of the prompt.  The last chunk may carry pad tokens past the
    prompt; their K/V land at positions that decode writes before its mask
    exposes them (each layer writes a position, then reads it), so padding
    needs no mask.  Returns (logits (B, C, vocab), pages)."""
    B, C = tokens.shape
    positions = _positions(start, C, B, tokens.device)
    return _run_paged(model, tokens, pages, block_tables, positions, cfg, dist), pages
