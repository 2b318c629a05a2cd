"""Zamba2-style hybrid: a Mamba2 backbone with one SHARED attention block
applied after every k-th layer (``cfg.hybrid.shared_attn_every``) — the
full-sequence forward (training, prefill) and the one-token decode.

As in the reference (``repro/models/hybrid.py``):
* the shared block's weights are one parameter set reused at every
  application (Zamba's parameter-efficiency trick);
* its input is concat(hidden, initial embedding), 2d wide, projected to d,
  then attention and a GLU MLP, each behind a norm, and a projection whose
  output is added to the residual stream.

The reference scans the stacked Mamba layers and fires the block with
``lax.cond`` on the layer index; here the layers run in a Python loop and
the block fires under ``if (l + 1) % every == 0``.  Each layer together with
the firing that follows it is one body under ``maybe_remat``, as the
reference's ``body``.  The Mamba layers run the SSD kernel
(``mamba.mamba_block``); the block's attention follows
``cfg.attention_impl`` (the flash kernel under ``"flash"``, which has no
gradient: training runs the configs' ``"xla"``).

Decode (:func:`decode_step`) carries :class:`HybridState`: every layer's
Mamba2 state and one bfloat16 KV cache per firing of the shared block
(firing f = (l + 1) // every - 1 after layer l), written in place.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from ..runtime.device import resolve_device
from .attention import KVCache, attention, attention_shapes, init_kv_cache, spec_attention
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
from .mamba import (MambaState, init_mamba_param_, init_mamba_state, mamba_block,
                    mamba_layer_shapes, spec_mamba_layer)
from .mlp import mlp, mlp_shapes, spec_mlp


class HybridState(NamedTuple):
    mamba: MambaState   # every layer's, stacked (L, ...)
    attn_kv: KVCache    # (F, B, max_seq, Hkv, hd) bfloat16, one cache per firing


class HybridLM(nn.Module):
    """Parameters of the hybrid LM (``layers``: the stacked Mamba2 layers;
    ``shared``: the one attention block); the math is :func:`forward`."""

    def __init__(self, cfg, device) -> None:
        super().__init__()
        if cfg.family != "hybrid":
            raise ValueError(f"HybridLM builds the hybrid family, got {cfg.family!r}")
        d, pdt = cfg.d_model, dtype_of(cfg.param_dtype)
        self.embed = ParamBlock(embed_shapes(cfg, pdt), device)
        self.final_norm = ParamBlock(norm_shapes((d,), cfg.norm), device)
        params, norms = mamba_layer_shapes(cfg, pdt, cfg.num_layers)
        self.layers = ParamBlock(params, device)
        for name, shapes in norms.items():
            self.layers.add_module(name, ParamBlock(shapes, device))
        shared_in = 2 * d if cfg.hybrid.concat_embedding else d
        self.shared = ParamBlock({"in_proj": ((shared_in, d), pdt),
                                  "out_proj": ((d, d), pdt)}, device)
        self.shared.ln1 = ParamBlock(norm_shapes((d,), cfg.norm), device)
        self.shared.attn = ParamBlock(attention_shapes(cfg, pdt), device)
        self.shared.ln2 = ParamBlock(norm_shapes((d,), cfg.norm), device)
        self.shared.mlp = ParamBlock(mlp_shapes(d, cfg.d_ff, cfg.activation, pdt), device)


def spec_lm(cfg, fsdp="data", tp="model") -> dict:
    """Parameter specs with :class:`HybridLM`'s keys (the reference's)."""
    shared = {
        "in_proj": (fsdp, tp),
        "ln1": spec_norm(cfg.norm),
        "attn": spec_attention(cfg, fsdp, tp),
        "ln2": spec_norm(cfg.norm),
        "mlp": spec_mlp(cfg.activation, fsdp, tp),
        "out_proj": (fsdp, tp),
    }
    return {
        "embed": spec_embedding(cfg.tie_embeddings, tp, fsdp,
                                vocab=cfg.vocab_size, tp_size=cfg.parallelism.tp_size),
        "layers": stack_specs(spec_mamba_layer(cfg, fsdp, tp)),
        "shared": shared,
        "final_norm": spec_norm(cfg.norm),
    }


@torch.no_grad()
def init_lm(cfg, seed: int, device) -> HybridLM:
    """Random weights from ``seed`` with the reference's distributions: the
    Mamba2 layers' (``mamba.init_mamba_param_``); in the shared block
    N(0,1)/sqrt(in) projections, attention's ``wo`` scaled by 1/sqrt(2L)
    and ``out_proj`` by 0.5; N(0, 0.02) embeddings, unit norm scales and
    zero biases."""
    model = HybridLM(cfg, device)
    gen = torch.Generator().manual_seed(seed)
    for name, p in sorted(model.named_parameters()):
        leaf = name.rsplit(".", 1)[-1]
        if name == "embed.tok":
            embed_init_(p, gen)
        elif leaf == "scale":
            p.fill_(1.0)
        elif leaf in ("bias", "bq", "bk", "bv"):
            p.zero_()
        elif name.startswith("layers."):
            init_mamba_param_(leaf, p, gen, cfg)
        elif name == "shared.attn.wo":
            dense_init_(p, gen, scale=1.0 / math.sqrt(2 * cfg.num_layers))
        elif name == "shared.out_proj":
            dense_init_(p, gen, scale=0.5)
        else:
            dense_init_(p, gen)
    return model


def _shared_block(p: dict, x, emb0, positions, cfg, kv_cache=None, cache_index: int = 0):
    inp = torch.cat([x, emb0], dim=-1) if cfg.hybrid.concat_embedding else x
    h = inp @ p["in_proj"].to(x.dtype)
    a = attention(p["attn"], norm(p["ln1"], h, cfg.norm), cfg, positions=positions,
                  causal=True, kv_cache=kv_cache, cache_index=cache_index)
    h = h + (a if kv_cache is None else a[0])
    h = h + mlp(p["mlp"], norm(p["ln2"], h, cfg.norm), cfg.activation)
    return x + h @ p["out_proj"].to(x.dtype)


def forward(model: HybridLM, tokens: torch.Tensor, cfg, last_only: bool = False) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, vocab), or (B, 1, vocab) with
    ``last_only``."""
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)[None, :].expand(B, S)
    emb0 = embed_tokens(model.embed.tok, tokens, dtype_of(cfg.compute_dtype))
    shared = model.shared.layer()
    every = cfg.hybrid.shared_attn_every

    def body(p, xx, fire: bool):
        xx = xx + mamba_block(p, xx, cfg)
        return _shared_block(shared, xx, emb0, positions, cfg) if fire else xx

    body = maybe_remat(body, cfg.parallelism.remat)
    x = emb0
    for l in range(cfg.num_layers):
        x = body(model.layers.layer(l), x, (l + 1) % every == 0)
    if last_only:
        x = x[:, -1:]
    x = norm(model.final_norm.layer(), x, cfg.norm)
    return unembed(model.embed.layer(), x, cfg.tie_embeddings)


def loss_fn(model: HybridLM, batch: dict, cfg) -> torch.Tensor:
    return softmax_cross_entropy(forward(model, batch["tokens"], cfg), batch["targets"])


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def num_firings(cfg) -> int:
    return cfg.num_layers // cfg.hybrid.shared_attn_every


def init_state(cfg, batch: int, max_seq: int, device=None) -> HybridState:
    """Zero Mamba2 states for every layer and a zero bfloat16 KV cache of
    ``max_seq`` positions for every firing of the shared block (bfloat16
    whatever the model's dtypes, as in the reference)."""
    dev = resolve_device(device)
    return HybridState(init_mamba_state(cfg, batch, dev, layers=cfg.num_layers),
                       init_kv_cache(cfg, batch, max_seq, torch.bfloat16, dev,
                                     layers=num_firings(cfg)))


def decode_step(model: HybridLM, token: torch.Tensor, state: HybridState, index,
                cfg) -> tuple:
    """One token per sequence at position ``index``: token (B, 1) ->
    (logits (B, vocab), state).  The state is written in place."""
    B = token.shape[0]
    index = int(index)
    positions = torch.full((B, 1), index, dtype=torch.int32, device=token.device)
    emb0 = embed_tokens(model.embed.tok, token, dtype_of(cfg.compute_dtype))
    shared = model.shared.layer()
    every = cfg.hybrid.shared_attn_every
    ms, kv = state.mamba, state.attn_kv
    x = emb0
    for l in range(cfg.num_layers):
        y, new = mamba_block(model.layers.layer(l), x, cfg,
                             state=MambaState(ms.conv[l], ms.ssm[l]))
        ms.conv[l].copy_(new.conv)
        ms.ssm[l].copy_(new.ssm)
        x = x + y
        if (l + 1) % every == 0:
            f = (l + 1) // every - 1
            x = _shared_block(shared, x, emb0, positions, cfg, kv_cache=KVCache(kv.k[f], kv.v[f]),
                              cache_index=index)
    x = norm(model.final_norm.layer(), x, cfg.norm)
    return unembed(model.embed.layer(), x, cfg.tie_embeddings)[:, 0, :], state
