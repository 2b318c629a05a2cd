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

from .attention import attention
from .common import (
    apply_norm,
    dense_init_,
    dtype_of,
    embed_init_,
    embed_tokens,
    softmax_cross_entropy,
    unembed,
)
from .common import is_glu
from .mlp import mlp


class ParamBlock(nn.Module):
    """A named set of parameters (one node of the reference's tree)."""

    def __init__(self, shapes: dict, device) -> None:
        super().__init__()
        for name, (shape, dtype) in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=dtype, device=device)))

    def layer(self, l: int) -> dict:
        """Layer ``l``'s slice of every stacked parameter."""
        return {name: p[l] for name, p in self.named_parameters(recurse=False)}


def _norm_shapes(shape: tuple, kind: str) -> dict:
    # norm scales stay float32 whatever the model's parameter dtype
    out = {"scale": (shape, torch.float32)}
    if kind != "rmsnorm":
        out["bias"] = (shape, torch.float32)
    return out


class TransformerLM(nn.Module):
    """Parameters of the dense LM; the forward math is :func:`forward`."""

    def __init__(self, cfg, device) -> None:
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
        L, d, f, V = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
        hd, nq, nkv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
        pdt = dtype_of(cfg.param_dtype)
        embed = {"tok": ((V, d), pdt)}
        if not cfg.tie_embeddings:
            embed["unembed"] = ((d, V), pdt)
        self.embed = ParamBlock(embed, device)
        self.final_norm = ParamBlock(_norm_shapes((d,), cfg.norm), device)
        attn = {"wq": ((L, d, nq * hd), pdt), "wk": ((L, d, nkv * hd), pdt),
                "wv": ((L, d, nkv * hd), pdt), "wo": ((L, nq * hd, d), pdt)}
        if cfg.qkv_bias:
            attn.update(bq=((L, nq * hd), pdt), bk=((L, nkv * hd), pdt),
                        bv=((L, nkv * hd), pdt))
        ffn = {"wi": ((L, d, f), pdt), "wo": ((L, f, d), pdt)}
        if is_glu(cfg.activation):
            ffn["wg"] = ((L, d, f), pdt)
        self.layers = nn.Module()
        self.layers.attn = ParamBlock(attn, device)
        self.layers.ln1 = ParamBlock(_norm_shapes((L, d), cfg.norm), device)
        self.layers.ln2 = ParamBlock(_norm_shapes((L, d), cfg.norm), device)
        self.layers.mlp = ParamBlock(ffn, device)


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


def _norm(block: ParamBlock, x, kind: str, l=None):
    scale = block.scale if l is None else block.scale[l]
    bias = None
    if kind != "rmsnorm":
        bias = block.bias if l is None else block.bias[l]
    return apply_norm(scale, x, kind, bias=bias)


def forward(model: TransformerLM, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, vocab)."""
    cdt = dtype_of(cfg.compute_dtype)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)[None, :].expand(B, S)
    x = embed_tokens(model.embed.tok, tokens, cdt)
    lay = model.layers
    for l in range(cfg.num_layers):
        h = _norm(lay.ln1, x, cfg.norm, l)
        x = x + attention(lay.attn.layer(l), h, cfg, positions=positions, causal=True)
        h2 = _norm(lay.ln2, x, cfg.norm, l)
        x = x + mlp(lay.mlp.layer(l), h2, cfg.activation)
    x = _norm(model.final_norm, x, cfg.norm)
    if cfg.tie_embeddings:
        return unembed(model.embed.tok, x)
    return x @ model.embed.unembed.to(x.dtype)


def loss_fn(model: TransformerLM, batch: dict, cfg) -> torch.Tensor:
    return softmax_cross_entropy(forward(model, batch["tokens"], cfg), batch["targets"])
