"""Zamba2-style hybrid: a Mamba2 backbone with one SHARED attention block
applied after every k-th layer (``cfg.hybrid.shared_attn_every``),
full-sequence forward.

As in the reference (``repro/models/hybrid.py``):
* the shared block's weights are one parameter set reused at every
  application (Zamba's parameter-efficiency trick);
* its input is concat(hidden, initial embedding), 2d wide, projected to d,
  then attention and a GLU MLP, each behind a norm, and a projection whose
  output is added to the residual stream.

The reference scans the stacked Mamba layers and fires the block with
``lax.cond`` on the layer index; here the layers run in a Python loop and
the block fires under ``if (l + 1) % every == 0``.  The Mamba layers run
the SSD kernel (``mamba.mamba_block``); the block's attention follows
``cfg.attention_impl`` (the flash kernel under ``"flash"``).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .attention import attention, attention_shapes
from .common import (
    ParamBlock,
    dense_init_,
    dtype_of,
    embed_init_,
    embed_shapes,
    embed_tokens,
    norm,
    norm_shapes,
    softmax_cross_entropy,
    unembed,
)
from .mamba import init_mamba_param_, mamba_block, mamba_layer_shapes
from .mlp import mlp, mlp_shapes


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


def _shared_block(p: dict, x, emb0, positions, cfg):
    inp = torch.cat([x, emb0], dim=-1) if cfg.hybrid.concat_embedding else x
    h = inp @ p["in_proj"].to(x.dtype)
    h = h + attention(p["attn"], norm(p["ln1"], h, cfg.norm), cfg, positions=positions,
                      causal=True)
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
    x = emb0
    for l in range(cfg.num_layers):
        x = x + mamba_block(model.layers.layer(l), x, cfg)
        if (l + 1) % every == 0:
            x = _shared_block(shared, x, emb0, positions, cfg)
    if last_only:
        x = x[:, -1:]
    x = norm(model.final_norm.layer(), x, cfg.norm)
    return unembed(model.embed.layer(), x, cfg.tie_embeddings)


def loss_fn(model: HybridLM, batch: dict, cfg) -> torch.Tensor:
    return softmax_cross_entropy(forward(model, batch["tokens"], cfg), batch["targets"])
