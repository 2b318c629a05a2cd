"""Whisper-style encoder-decoder (the reference's ``repro/models/encdec.py``).

As in the reference the conv frontend is a stub: a batch carries
precomputed frame embeddings ``frames`` (B, encoder_frames, d_model).

* **encoder** (:func:`encode`): the frames plus the f32 sinusoidal table
  (``common.sinusoidal_positions``), then bidirectional pre-norm layers
  (self-attention, MLP) and ``enc_norm``;
* **decoder** (:func:`decode_train`): the token embedding plus the learned
  table ``pos_dec[:S]``, then causal pre-norm layers of self-attention,
  cross-attention to the encoder's output (``attention(cross_kv=)``: K and V
  projected from it by each layer's ``cross.wk``/``cross.wv``) and MLP;
  ``final_norm`` and the tied unembedding.

Every self-attention call also rotates q and k by RoPE, the encoder's too,
because the reference's ``attention`` does for every call that is not
cross-attention; the port keeps the function, not Whisper's design.  Under
``attention_impl="flash"`` only the decoder's causal self-attention
launches the flash kernel (one launch a decoder layer); the encoder's
bidirectional attention and cross-attention take ``_sdpa``.  Both layer
bodies run under ``maybe_remat``.

Parameters keep the reference's tree: ``embed``, ``pos_dec`` (a leaf at
the top, (max_seq_len, d_model)), ``enc_layers`` (``ln1``, ``attn``,
``ln2``, ``mlp``), ``enc_norm``, ``dec_layers`` (also ``ln_cross``,
``cross``), ``final_norm``; every per-layer leaf stacked on a leading
layer axis.

Decode (:func:`init_cache`, :func:`decode_step`): the encoder runs once and
every decoder layer's cross K/V is kept, cast to bfloat16 whatever the
compute dtype, as the self-attention caches are (the reference's
``EncDecCache``); the self-attention cache is written in place.  The model
API has no ``decode_init`` for the family, as in the reference: the cache
needs the frames.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

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
    normal_init_,
    sinusoidal_positions,
    softmax_cross_entropy,
    spec_embedding,
    spec_norm,
    stack_specs,
    unembed,
)
from .mlp import mlp, mlp_shapes, spec_mlp
from .transformer import _positions


class EncDecCache(NamedTuple):
    self_kv: KVCache         # (L, B, max_seq, Hkv, D) decoder self-attention, bfloat16
    cross_k: torch.Tensor    # (L, B, F, Hkv, D) from the encoder's output, bfloat16
    cross_v: torch.Tensor


def _layer_block(cfg, dtype, layers: int, device, cross: bool) -> ParamBlock:
    """One stack of layers: ``ln1``, ``attn``, ``ln2``, ``mlp`` and, in the
    decoder, ``ln_cross`` and ``cross``, each leaf stacked on ``layers``."""
    d = cfg.d_model
    block = ParamBlock({}, device)
    block.ln1 = ParamBlock(norm_shapes((layers, d), cfg.norm), device)
    block.attn = ParamBlock(attention_shapes(cfg, dtype, (layers,)), device)
    block.ln2 = ParamBlock(norm_shapes((layers, d), cfg.norm), device)
    block.mlp = ParamBlock(mlp_shapes(d, cfg.d_ff, cfg.activation, dtype, (layers,)), device)
    if cross:
        block.ln_cross = ParamBlock(norm_shapes((layers, d), cfg.norm), device)
        block.cross = ParamBlock(attention_shapes(cfg, dtype, (layers,)), device)
    return block


class EncDecLM(nn.Module):
    """Parameters of the encoder-decoder; the math is :func:`forward`."""

    def __init__(self, cfg, device) -> None:
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"EncDecLM builds the encdec family, got {cfg.family!r}")
        d, pdt = cfg.d_model, dtype_of(cfg.param_dtype)
        self.embed = ParamBlock(embed_shapes(cfg, pdt), device)
        self.pos_dec = nn.Parameter(torch.empty((cfg.max_seq_len, d), dtype=pdt, device=device))
        self.enc_layers = _layer_block(cfg, pdt, cfg.encdec.encoder_layers, device, cross=False)
        self.enc_norm = ParamBlock(norm_shapes((d,), cfg.norm), device)
        self.dec_layers = _layer_block(cfg, pdt, cfg.num_layers, device, cross=True)
        self.final_norm = ParamBlock(norm_shapes((d,), cfg.norm), device)


def spec_lm(cfg, fsdp="data", tp="model") -> dict:
    """Parameter specs with :class:`EncDecLM`'s keys (the reference's)."""
    enc = {"ln1": spec_norm(cfg.norm), "attn": spec_attention(cfg, fsdp, tp),
           "ln2": spec_norm(cfg.norm), "mlp": spec_mlp(cfg.activation, fsdp, tp)}
    dec = dict(enc, ln_cross=spec_norm(cfg.norm), cross=spec_attention(cfg, fsdp, tp))
    return {
        "embed": spec_embedding(cfg.tie_embeddings, tp, fsdp,
                                vocab=cfg.vocab_size, tp_size=cfg.parallelism.tp_size),
        "pos_dec": (None, None),
        "enc_layers": stack_specs(enc),
        "enc_norm": spec_norm(cfg.norm),
        "dec_layers": stack_specs(dec),
        "final_norm": spec_norm(cfg.norm),
    }


@torch.no_grad()
def init_lm(cfg, seed: int, device) -> EncDecLM:
    """Random weights from ``seed`` with the reference's distributions:
    N(0, 0.02) embeddings, ``pos_dec`` N(0, 1) * 0.01, N(0,1)/sqrt(in)
    projections (both attentions' ``wo`` further scaled by 1/sqrt(2L), L the
    decoder's depth, in the encoder too), unit norm scales, zero biases."""
    model = EncDecLM(cfg, device)
    gen = torch.Generator().manual_seed(seed)
    for name, p in sorted(model.named_parameters()):
        *path, leaf = name.split(".")
        if name == "embed.tok":
            embed_init_(p, gen)
        elif name == "pos_dec":
            normal_init_(p, gen, 0.01)
        elif leaf == "scale":
            p.fill_(1.0)
        elif leaf in ("bias", "bq", "bk", "bv"):
            p.zero_()
        elif leaf == "wo" and path[-1] in ("attn", "cross"):
            dense_init_(p, gen, scale=1.0 / math.sqrt(2 * cfg.num_layers))
        else:
            dense_init_(p, gen)
    return model


def _enc_layer(p: dict, x: torch.Tensor, positions: torch.Tensor, cfg) -> torch.Tensor:
    x = x + attention(p["attn"], norm(p["ln1"], x, cfg.norm), cfg, positions=positions,
                      causal=False)
    return x + mlp(p["mlp"], norm(p["ln2"], x, cfg.norm), cfg.activation)


def _dec_layer(p: dict, x: torch.Tensor, positions: torch.Tensor, cross_kv: tuple, cfg,
               kv_cache=None, cache_index: int = 0) -> torch.Tensor:
    """One decoder layer: causal self-attention (over ``kv_cache`` from
    ``cache_index`` when given), cross-attention to ``cross_kv``, MLP."""
    a = attention(p["attn"], norm(p["ln1"], x, cfg.norm), cfg, positions=positions,
                  causal=True, kv_cache=kv_cache, cache_index=cache_index)
    x = x + (a if kv_cache is None else a[0])
    x = x + attention(p["cross"], norm(p["ln_cross"], x, cfg.norm), cfg, positions=positions,
                      cross_kv=cross_kv)
    return x + mlp(p["mlp"], norm(p["ln2"], x, cfg.norm), cfg.activation)


def encode(model: EncDecLM, frames: torch.Tensor, cfg) -> torch.Tensor:
    """frames (B, F, d) -> the encoder's output (B, F, d)."""
    frames = frames.to(dtype_of(cfg.compute_dtype))
    B, F = frames.shape[:2]
    x = frames + sinusoidal_positions(F, cfg.d_model, frames.device).to(frames.dtype)
    positions = _positions(0, F, B, frames.device)
    body = maybe_remat(lambda p, xx: _enc_layer(p, xx, positions, cfg), cfg.parallelism.remat)
    for l in range(cfg.encdec.encoder_layers):
        x = body(model.enc_layers.layer(l), x)
    return norm(model.enc_norm.layer(), x, cfg.norm)


def _cross_kv(p: dict, enc_out: torch.Tensor, cfg) -> tuple:
    """One decoder layer's cross K and V (B, F, Hkv, D) from the encoder's
    output, by its ``cross`` block's ``wk`` and ``wv``."""
    B, F = enc_out.shape[:2]
    shape = (B, F, cfg.num_kv_heads, cfg.resolved_head_dim)
    return ((enc_out @ p["wk"].to(enc_out.dtype)).reshape(shape),
            (enc_out @ p["wv"].to(enc_out.dtype)).reshape(shape))


def decode_train(model: EncDecLM, tokens: torch.Tensor, enc_out: torch.Tensor, cfg,
                 last_only: bool = False) -> torch.Tensor:
    """The teacher-forced decoder: tokens (B, S) -> logits (B, S, vocab),
    or (B, 1, vocab) with ``last_only``."""
    cdt = dtype_of(cfg.compute_dtype)
    B, S = tokens.shape
    positions = _positions(0, S, B, tokens.device)
    x = embed_tokens(model.embed.tok, tokens, cdt) + model.pos_dec[:S].to(cdt)[None]

    def body(p, xx):
        return _dec_layer(p, xx, positions, _cross_kv(p["cross"], enc_out, cfg), cfg)

    body = maybe_remat(body, cfg.parallelism.remat)
    for l in range(cfg.num_layers):
        x = body(model.dec_layers.layer(l), x)
    if last_only:
        x = x[:, -1:]
    return _logits(model, x, cfg)


def _logits(model: EncDecLM, x: torch.Tensor, cfg) -> torch.Tensor:
    x = norm(model.final_norm.layer(), x, cfg.norm)
    return unembed(model.embed.layer(), x, cfg.tie_embeddings)


def forward(model: EncDecLM, batch: dict, cfg, last_only: bool = False) -> torch.Tensor:
    """batch: ``frames`` (B, F, d), ``tokens`` (B, S) -> logits (B, S, vocab)
    (the reference's aux loss is a zero)."""
    return decode_train(model, batch["tokens"], encode(model, batch["frames"], cfg), cfg,
                        last_only)


def loss_fn(model: EncDecLM, batch: dict, cfg) -> torch.Tensor:
    return softmax_cross_entropy(forward(model, batch, cfg), batch["targets"])


# ---------------------------------------------------------------------------
# cached decode
# ---------------------------------------------------------------------------
@torch.no_grad()
def init_cache(model: EncDecLM, frames: torch.Tensor, cfg, batch: int,
               max_seq: int) -> EncDecCache:
    """Run the encoder once on ``frames`` and keep every decoder layer's
    cross K/V, bfloat16; a zero bfloat16 self-attention cache of
    ``max_seq`` positions."""
    enc_out = encode(model, frames, cfg)
    kv = [_cross_kv(model.dec_layers.cross.layer(l), enc_out, cfg)
          for l in range(cfg.num_layers)]
    return EncDecCache(
        init_kv_cache(cfg, batch, max_seq, torch.bfloat16, frames.device, layers=cfg.num_layers),
        torch.stack([k for k, _ in kv]).to(torch.bfloat16),
        torch.stack([v for _, v in kv]).to(torch.bfloat16))


def decode_step(model: EncDecLM, token: torch.Tensor, cache: EncDecCache, index,
                cfg) -> tuple:
    """One token per sequence at position ``index``: token (B, 1) ->
    (logits (B, vocab), cache).  The self-attention cache is written in
    place."""
    cdt = dtype_of(cfg.compute_dtype)
    B = token.shape[0]
    index = int(index)
    positions = _positions(index, 1, B, token.device)
    x = embed_tokens(model.embed.tok, token, cdt) + model.pos_dec[index:index + 1].to(cdt)[None]
    kv = cache.self_kv
    for l in range(cfg.num_layers):
        x = _dec_layer(model.dec_layers.layer(l), x, positions,
                       (cache.cross_k[l].to(cdt), cache.cross_v[l].to(cdt)), cfg,
                       kv_cache=KVCache(kv.k[l], kv.v[l]), cache_index=index)
    return _logits(model, x, cfg)[:, 0, :], cache
