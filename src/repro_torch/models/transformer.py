"""Dense and MoE decoder-only transformer LM (the qwen2, gemma, chatglm3
families and qwen2-moe, grok-1).

Parameters keep the reference's layout: every per-layer weight is stacked
on a leading ``L`` axis and multiplies as ``x @ W[l]`` with ``W`` shaped
``(in, out)``, and module names spell the reference's parameter-tree paths
(``layers.attn.wq``, ``final_norm.scale``...).  A reference pytree maps
onto the module by name alone (``model.from_jax_params``) and the ZeRO-1
flat vector can follow the reference's leaf order.

The reference scans the layers with optional rematerialisation; here the
layers run in a Python loop (:func:`_layers`, the one layer body of every
path, from an embedded residual), each layer body under the config's
``parallelism.remat`` (``maybe_remat``: ``"full"`` recomputes the body in
the backward and changes no number).  With ``cfg.moe`` set each layer's
FFN is the MoE block (``layers.moe.*``, ``models/moe.py``), the forward
carries the sum of the layers' router aux losses and the loss is
cross-entropy plus that sum, as in the reference.  Every function takes the
``dist`` the tensor parallelism and the MoE block's expert parallelism run
on.

Tensor parallelism and FSDP (the dense, moe and vlm families): a model built
for a :class:`~.tensor_parallel.Part` of the mesh
(``model_rank``/``model_axis``, ``fsdp_rank``/``fsdp_size``) holds its
block of each leaf as ``tensor_parallel.held_layout`` places it (the reference's
specs, with its divisibility rules: under expert parallelism its
``E_pad / model_axis`` experts of each layer, under ``parallelism="tp"``
its block of every expert's ``d_ff``), and every path computes through
:class:`~.tensor_parallel.TensorParallel`: Megatron's collectives on the
model axis, sequence parallelism where the config asks for it and the
sequence divides, the fsdp gathers inside the remat body, the moe block in
that layout (``moe._moe_split``), the vocabulary-parallel embedding and
loss, and full logits gathered where a path returns them.

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
from .moe import moe_block, moe_shapes, spec_moe
from .tensor_parallel import Part, TensorParallel, draw_block, held_layout, hold, is_split
from .tensor_parallel import vocab_parallel_cross_entropy


class TransformerLM(nn.Module):
    """Parameters of the dense or MoE LM; the forward math is :func:`forward`.
    ``model_rank``/``model_axis`` and ``fsdp_rank``/``fsdp_size``: this
    rank's block (``part``) of every leaf the model axis and the fsdp axes
    split, as :func:`held_layout` places it; every other leaf whole.
    ``held`` is each leaf's held spec (empty for the whole model) and
    ``full_shapes`` each leaf's whole shape."""

    #: the families this module's parameter tree builds
    FAMILIES = ("dense", "moe")

    def __init__(self, cfg, device, model_rank: int = 0, model_axis: int = 1,
                 fsdp_rank: int = 0, fsdp_size: int = 1) -> None:
        super().__init__()
        if cfg.family not in self.FAMILIES:
            raise ValueError(f"{type(self).__name__} builds the {' and '.join(self.FAMILIES)} "
                             f"families, got {cfg.family!r}")
        hold(self, cfg, self.blocks(cfg), device,
             Part(model_rank, model_axis, fsdp_rank, fsdp_size))

    @classmethod
    def blocks(cls, cfg) -> dict:
        """The parameter tree's nodes -> their leaves' whole (shape, dtype)
        (``tensor_parallel.hold``)."""
        L, d = cfg.num_layers, cfg.d_model
        pdt = dtype_of(cfg.param_dtype)
        blocks = {"embed": embed_shapes(cfg, pdt),
                  "final_norm": norm_shapes((d,), cfg.norm),
                  "layers.attn": attention_shapes(cfg, pdt, (L,)),
                  "layers.ln1": norm_shapes((L, d), cfg.norm),
                  "layers.ln2": norm_shapes((L, d), cfg.norm)}
        if cfg.moe is not None:
            blocks["layers.moe"], children = moe_shapes(cfg, pdt, (L,))
            blocks.update({f"layers.moe.{k}": v for k, v in children.items()})
        else:
            blocks["layers.mlp"] = mlp_shapes(d, cfg.d_ff, cfg.activation, pdt, (L,))
        return blocks


def full_shapes(cfg) -> dict:
    """Leaf name -> the whole leaf's shape."""
    return TransformerLM(cfg, "meta").full_shapes


def split_units(cfg, R: int) -> tuple:
    """(leaves, do they split) of the units :func:`~.tensor_parallel.held_layout`
    splits together over a model axis of ``R``: the attention's query and
    K/V projections only where whole heads divide the axis.  Under expert
    parallelism the axis must divide the (padded) experts: each rank holds
    its ``E_pad / R`` of them."""
    m = cfg.moe
    if m is not None and m.parallelism == "ep" and R > 1:
        E_pad = m.padded_experts or m.num_experts
        if E_pad % R:
            raise ValueError(f"EP needs the model axis ({R}) to divide {E_pad} experts")
    return attention_units(ATTENTIONS[0], cfg, R)


def attention_units(prefix: str, cfg, R: int) -> tuple:
    """The attention's two units: its query heads (``wq``, ``wo``, ``bq``)
    and its K/V heads (``wk``, ``wv``, ``bk``, ``bv``), each split only
    where whole heads divide a model axis of ``R``."""
    return (tuple(prefix + k for k in ("wq", "wo", "bq")), cfg.num_heads % R == 0), \
        (tuple(prefix + k for k in ("wk", "wv", "bk", "bv")), cfg.num_kv_heads % R == 0)


def segments(cfg) -> dict:
    """No leaf of the transformer concatenates segments."""
    return {}


#: where the attention's leaves are and the MLP's ``wi`` (``TensorParallel.of``
#: reads their split)
ATTENTIONS = ("layers.attn.",)
FFNS = ("layers.mlp.wi",)
#: the residual stream splits along the sequence under ``sequence_parallel``
SEQUENCE_PARALLEL = True


def read_partly(cfg) -> dict:
    """No unit of the transformer reads a whole leaf partly by itself
    (``TensorParallel.of`` adds the K/V projections, the router and the
    shared experts' gate by the layout)."""
    return {}


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
def init_lm(cfg, seed: int, device, model_rank: int = 0, model_axis: int = 1,
            fsdp_rank: int = 0, fsdp_size: int = 1) -> TransformerLM:
    """Random weights from ``seed`` (:func:`init_weights_`)."""
    return init_weights_(TransformerLM(cfg, device, model_rank, model_axis, fsdp_rank,
                                       fsdp_size), cfg, seed)


@torch.no_grad()
def init_weights_(model: TransformerLM, cfg, seed: int) -> TransformerLM:
    """Fill ``model`` from ``seed`` with the reference's distributions:
    N(0,1)/sqrt(in) projections (``wo`` of attention further scaled by
    1/sqrt(2L)), N(0, 0.02) embeddings, zero biases, unit norm scales.  A
    model holding one rank's part of the experts, or a rank's block of the
    dense layers, holds that part of the whole model's draw."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in sorted(model.named_parameters()):
        leaf = name.rsplit(".", 1)[-1]
        block = draw_block(model, name)
        if name.startswith("embed."):
            if leaf == "tok":
                embed_init_(p, gen, **block)
            else:
                dense_init_(p, gen, **block)
        elif leaf == "scale":
            p.fill_(1.0)
        elif leaf in ("bias", "bq", "bk", "bv"):
            p.zero_()
        elif name == "layers.attn.wo":
            dense_init_(p, gen, scale=1.0 / math.sqrt(2 * cfg.num_layers), **block)
        else:
            dense_init_(p, gen, **block)
    return model


def _embed(model: TransformerLM, tokens: torch.Tensor, cfg, par=None) -> torch.Tensor:
    """The tokens' embedding in the compute dtype (under tensor parallelism
    in the residual stream's layout, :meth:`TensorParallel.embed`)."""
    dtype = dtype_of(cfg.compute_dtype)
    if par is None:
        return embed_tokens(model.embed.tok, tokens, dtype)
    return par.embed(par.params(model.embed.layer(), "embed.")["tok"], tokens, dtype)


def _layers(lay, x: torch.Tensor, cfg, attend, dist=None, remat: str = "none",
            par: Optional[TensorParallel] = None) -> tuple:
    """Every layer of ``lay`` on the residual ``x``: pre-norm attention
    (``attend(p, h, l)``, layer ``l``'s attention on its normed input: the
    forward's, a contiguous cache's or the pages'), then the pre-norm MLP
    or MoE block, each added; each layer body under ``maybe_remat(remat)``.
    With ``par`` the layer's leaves are gathered and wrapped first
    (:meth:`TensorParallel.params`, inside the remat body), and each block
    is entered and left in Megatron's layout (``attend`` then takes the
    K/V heads its query heads read; the moe block enters and leaves it
    itself).  Returns the residual and the layers'
    summed aux loss (None for the dense FFN)."""
    kw = {"kv_heads": par.kv_heads} if par is not None and par.kv_heads else {}

    def body(p, xx, l):
        if par is not None:
            p = par.params(p, "layers.", stacked=True)
        h = norm(p["ln1"], xx, cfg.norm)
        if par is None:
            xx = xx + attend(p["attn"], h, l)
        else:
            xx = xx + par.leave(attend(p["attn"], par.enter(h, par.q_split), l, **kw),
                                par.q_split)
        h = norm(p["ln2"], xx, cfg.norm)
        if cfg.moe is None:
            if par is None:
                return xx + mlp(p["mlp"], h, cfg.activation), None
            f = mlp(p["mlp"], par.enter(h, par.ffn_split), cfg.activation)
            return xx + par.leave(f, par.ffn_split), None
        f, aux = moe_block(p["moe"], h, cfg, dist, par)
        return xx + f, aux

    body = maybe_remat(body, remat)
    auxes = []
    for l in range(cfg.num_layers):
        x, aux = body({name: node.layer(l) for name, node in lay.named_children()}, x, l)
        auxes.append(aux)
    return x, None if cfg.moe is None else torch.stack(auxes).sum()


def _trunk(model: TransformerLM, x: torch.Tensor, cfg, attend, dist=None,
           par: Optional[TensorParallel] = None) -> tuple:
    """:func:`_layers` over ``model``'s layers from the embedded residual
    ``x`` (the tokens' embedding, or the vlm's image tokens before it),
    under the config's remat.  Returns the hidden state before the final
    norm and the summed aux loss."""
    return _layers(model.layers, x, cfg, attend, dist, cfg.parallelism.remat, par)


def _head(model: TransformerLM, x: torch.Tensor, cfg, par: Optional[TensorParallel] = None,
          last_only: bool = False) -> torch.Tensor:
    """The final norm and the unembedding of the residual ``x`` (with
    ``last_only`` its final position): the logits of the whole vocabulary,
    or of this rank's columns where the vocabulary splits."""
    fn, emb = model.final_norm.layer(), model.embed.layer()
    if par is not None:
        fn, emb = par.params(fn, "final_norm."), par.params(emb, "embed.")
    x = norm(fn, x, cfg.norm)
    if par is not None:
        x = par.enter(x, par.vocab_split)
    if last_only:
        x = x[:, -1:]
    return unembed(emb, x, cfg.tie_embeddings)


def _logits(model: TransformerLM, x: torch.Tensor, cfg, par: Optional[TensorParallel] = None,
            last_only: bool = False) -> torch.Tensor:
    """:func:`_head`'s logits over the whole vocabulary."""
    logits = _head(model, x, cfg, par, last_only)
    return logits if par is None else par.full_logits(logits)


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
    if model.part != Part():
        raise ValueError(f"the pipeline stages split a whole model, not one holding {model.part}")
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


def _forward_local(model: TransformerLM, tokens: torch.Tensor, cfg, last_only: bool,
                   dist) -> tuple:
    """(:func:`_head`'s logits, the summed aux loss, the call's layout)."""
    B, S = tokens.shape
    par = TensorParallel.of(model, cfg, dist, S)
    positions = _positions(0, S, B, tokens.device)
    x, aux = _trunk(model, _embed(model, tokens, cfg, par), cfg,
                    lambda p, h, l, **kw: attention(p, h, cfg, positions=positions,
                                                    causal=True, **kw), dist, par)
    return _head(model, x, cfg, par, last_only), aux, par


def forward_aux(model: TransformerLM, tokens: torch.Tensor, cfg, last_only: bool = False,
                dist=None) -> tuple:
    """Full-sequence forward -> (logits (B, S, vocab), or (B, 1, vocab) with
    ``last_only``, which slices the residual to the final position before
    the unembed (prefill needs one position); the summed aux loss, None
    for the dense FFN)."""
    logits, aux, par = _forward_local(model, tokens, cfg, last_only, dist)
    return (logits if par is None else par.full_logits(logits)), aux


def forward(model: TransformerLM, tokens: torch.Tensor, cfg, last_only: bool = False,
            dist=None) -> torch.Tensor:
    """:func:`forward_aux`'s logits."""
    return forward_aux(model, tokens, cfg, last_only, dist)[0]


def loss_fn(model: TransformerLM, batch: dict, cfg, dist=None) -> torch.Tensor:
    """Token-mean cross-entropy (vocabulary-parallel where the vocabulary
    splits), plus the aux loss with the MoE block."""
    logits, aux, par = _forward_local(model, batch["tokens"], cfg, False, dist)
    loss = _lm_loss(logits, batch["targets"], cfg, par)
    return loss if aux is None else loss + aux


def _lm_loss(logits: torch.Tensor, targets: torch.Tensor, cfg,
             par: Optional[TensorParallel]) -> torch.Tensor:
    """The token-mean cross-entropy of :func:`_head`'s logits: the
    vocabulary-parallel form where the vocabulary splits."""
    if par is not None and par.vocab_split:
        return vocab_parallel_cross_entropy(logits, targets,
                                            par.vocab_range(cfg.vocab_size)[0], par.tp_group)
    return softmax_cross_entropy(logits, targets)


def cache_specs(cfg) -> KVCache:
    """The reference's specs of the contiguous cache: batch over the data
    axes, K/V heads over the model axis, each side."""
    one = (("pod", "data"), None, "model", None)
    return KVCache((None, *one), (None, *one))


# ---------------------------------------------------------------------------
# serving: prefill fills the cache; decode appends one token
# ---------------------------------------------------------------------------
def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16, device=None,
               model_axis: int = 1) -> KVCache:
    """The contiguous cache, (L, batch, max_seq, kv_heads, head_dim) per
    side; a dense, moe or vlm model on ``model_axis`` ranks whose K/V heads
    split holds its ``kv_heads / model_axis`` of them."""
    heads = cfg.num_kv_heads
    if model_axis > 1 and is_split(held_layout(cfg, Part(0, model_axis))["layers.attn.wk"]):
        heads //= model_axis
    return init_kv_cache(cfg, batch, max_seq, dtype, resolve_device(device),
                         layers=cfg.num_layers, kv_heads=heads)


def _run_cached(model: TransformerLM, x: torch.Tensor, cache: KVCache, index: int,
                positions: torch.Tensor, cfg, dist, par: Optional[TensorParallel] = None
                ) -> torch.Tensor:
    """The layers over a contiguous cache from the embedded residual ``x``,
    writing from position ``index``."""
    return _trunk(model, x, cfg, lambda p, h, l, **kw: attention(
        p, h, cfg, positions=positions, causal=True,
        kv_cache=KVCache(cache.k[l], cache.v[l]), cache_index=index, **kw)[0], dist, par)[0]


def decode_step(model: TransformerLM, token: torch.Tensor, cache: KVCache, index: int,
                cfg, dist=None) -> tuple:
    """token: (B, 1) int; ``index``: the position it is written at.
    Returns (logits (B, vocab), cache)."""
    B = token.shape[0]
    par = TensorParallel.of(model, cfg, dist)
    positions = torch.full((B, 1), int(index), dtype=torch.int32, device=token.device)
    x = _run_cached(model, _embed(model, token, cfg, par), cache, int(index), positions, cfg,
                    dist, par)
    return _logits(model, x, cfg, par)[:, 0, :], cache


def prefill(model: TransformerLM, tokens: torch.Tensor, cfg, dist=None,
            max_seq: Optional[int] = None) -> tuple:
    """Run the prompt (B, S) into a fresh cache of ``max_seq`` positions
    (default the config's); returns (last logits (B, vocab), cache, S)."""
    B, S = tokens.shape
    par = TensorParallel.of(model, cfg, dist)
    cache = init_cache(cfg, B, max_seq or cfg.max_seq_len, device=tokens.device,
                       model_axis=model.part.tp_size)
    x = _run_cached(model, _embed(model, tokens, cfg, par), cache, 0,
                    _positions(0, S, B, tokens.device), cfg, dist, par)
    return _logits(model, x, cfg, par, last_only=True)[:, 0, :], cache, S


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
    if model.part != Part():
        raise NotImplementedError("the paged path serves a whole model; a model holding "
                                  f"{model.part} decodes through decode_step")
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
