"""Dense decoder-only transformer LM (the qwen2 family).

Parameters keep the reference's layout: every per-layer weight is stacked
on a leading ``L`` axis and multiplies as ``x @ W[l]`` with ``W`` shaped
``(in, out)``, and module names spell the reference's parameter-tree paths
(``layers.attn.wq``, ``final_norm.scale``...).  A reference pytree maps
onto the module by name alone (``model.from_jax_params``) and the ZeRO-1
flat vector can follow the reference's leaf order.

The reference scans the layers with optional rematerialisation; neither
changes a number, and here the layers run in a Python loop.
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
from .mlp import mlp, mlp_shapes


class TransformerLM(nn.Module):
    """Parameters of the dense LM; the forward math is :func:`forward`."""

    def __init__(self, cfg, device) -> None:
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
        L, d = cfg.num_layers, cfg.d_model
        pdt = dtype_of(cfg.param_dtype)
        self.embed = ParamBlock(embed_shapes(cfg, pdt), device)
        self.final_norm = ParamBlock(norm_shapes((d,), cfg.norm), device)
        self.layers = nn.Module()
        self.layers.attn = ParamBlock(attention_shapes(cfg, pdt, (L,)), device)
        self.layers.ln1 = ParamBlock(norm_shapes((L, d), cfg.norm), device)
        self.layers.ln2 = ParamBlock(norm_shapes((L, d), cfg.norm), device)
        self.layers.mlp = ParamBlock(mlp_shapes(d, cfg.d_ff, cfg.activation, pdt, (L,)),
                                     device)


@torch.no_grad()
def init_lm(cfg, seed: int, device) -> TransformerLM:
    """Random weights from ``seed``, with the reference's distributions:
    N(0,1)/sqrt(in) projections (``wo`` of attention further scaled by
    1/sqrt(2L)), N(0, 0.02) embeddings, zero biases, unit norm scales."""
    model = TransformerLM(cfg, device)
    gen = torch.Generator().manual_seed(seed)
    for name, p in sorted(model.named_parameters()):
        leaf = name.rsplit(".", 1)[-1]
        if name.startswith("embed."):
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


def forward(model: TransformerLM, tokens: torch.Tensor, cfg,
            last_only: bool = False) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, vocab), or (B, 1, vocab) with
    ``last_only``, which slices the residual to the final position before
    the final norm and the unembed (prefill needs one position)."""
    cdt = dtype_of(cfg.compute_dtype)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)[None, :].expand(B, S)
    x = embed_tokens(model.embed.tok, tokens, cdt)
    lay = model.layers
    for l in range(cfg.num_layers):
        h = norm(lay.ln1.layer(l), x, cfg.norm)
        x = x + attention(lay.attn.layer(l), h, cfg, positions=positions, causal=True)
        h2 = norm(lay.ln2.layer(l), x, cfg.norm)
        x = x + mlp(lay.mlp.layer(l), h2, cfg.activation)
    if last_only:
        x = x[:, -1:]
    x = norm(model.final_norm.layer(), x, cfg.norm)
    return unembed(model.embed.layer(), x, cfg.tie_embeddings)


def loss_fn(model: TransformerLM, batch: dict, cfg) -> torch.Tensor:
    return softmax_cross_entropy(forward(model, batch["tokens"], cfg), batch["targets"])
