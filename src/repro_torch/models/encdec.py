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

On the model axis (a model built for a :class:`~.tensor_parallel.Part`)
the layout is the reference's ``spec_lm``: Megatron's pair in each of the
three attentions (the encoder's bidirectional self-attention, the
decoder's causal self-attention and its cross-attention: query heads from
the rank's ``wq``, K/V heads from the rank's ``wk``/``wv`` columns applied
to the whole encoder output, which enters through ``copy_to`` since each
rank's heads add to its gradient; ``wo`` reduces), each split only where
whole heads divide the axis; the MLPs by ``d_ff``; the vocabulary where
it divides (whisper's 51,865 never does); ``pos_dec`` whole; under
``gspmd`` at dp > 1 the fsdp block.  The cache holds the rank's K/V heads
of the self-attention and of the cross K/V (:func:`cache_specs`).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from .attention import KVCache, attention, attention_shapes, init_kv_cache, spec_attention
from .common import (
    dense_init_,
    dtype_of,
    embed_init_,
    embed_shapes,
    maybe_remat,
    norm,
    norm_shapes,
    normal_init_,
    sinusoidal_positions,
    spec_embedding,
    spec_norm,
    stack_specs,
)
from .mlp import mlp, mlp_shapes, spec_mlp
from .tensor_parallel import Part, TensorParallel, copy_to, draw_block, hold
from .transformer import _embed, _head, _lm_loss, _logits, _positions, attention_units


class EncDecCache(NamedTuple):
    self_kv: KVCache         # (L, B, max_seq, Hkv, D) decoder self-attention, bfloat16
    cross_k: torch.Tensor    # (L, B, F, Hkv, D) from the encoder's output, bfloat16
    cross_v: torch.Tensor


def _stack_shapes(name: str, cfg, dtype, layers: int, cross: bool) -> dict:
    """One stack of layers (``tensor_parallel.hold``'s blocks): ``ln1``,
    ``attn``, ``ln2``, ``mlp`` and, in the decoder, ``ln_cross`` and
    ``cross``, each leaf stacked on ``layers``."""
    d = cfg.d_model
    out = {f"{name}.ln1": norm_shapes((layers, d), cfg.norm),
           f"{name}.attn": attention_shapes(cfg, dtype, (layers,)),
           f"{name}.ln2": norm_shapes((layers, d), cfg.norm),
           f"{name}.mlp": mlp_shapes(d, cfg.d_ff, cfg.activation, dtype, (layers,))}
    if cross:
        out[f"{name}.ln_cross"] = norm_shapes((layers, d), cfg.norm)
        out[f"{name}.cross"] = attention_shapes(cfg, dtype, (layers,))
    return out


class EncDecLM(nn.Module):
    """Parameters of the encoder-decoder; the math is :func:`forward`.
    ``model_rank``/``model_axis`` and ``fsdp_rank``/``fsdp_size``: this
    rank's block of every leaf the model axis and the fsdp axes split
    (``tensor_parallel.hold``)."""

    def __init__(self, cfg, device, model_rank: int = 0, model_axis: int = 1,
                 fsdp_rank: int = 0, fsdp_size: int = 1) -> None:
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"EncDecLM builds the encdec family, got {cfg.family!r}")
        d, pdt = cfg.d_model, dtype_of(cfg.param_dtype)
        hold(self, cfg, {
            "embed": embed_shapes(cfg, pdt),
            "": {"pos_dec": ((cfg.max_seq_len, d), pdt)},
            **_stack_shapes("enc_layers", cfg, pdt, cfg.encdec.encoder_layers, cross=False),
            "enc_norm": norm_shapes((d,), cfg.norm),
            **_stack_shapes("dec_layers", cfg, pdt, cfg.num_layers, cross=True),
            "final_norm": norm_shapes((d,), cfg.norm),
        }, device, Part(model_rank, model_axis, fsdp_rank, fsdp_size))


def full_shapes(cfg) -> dict:
    """Leaf name -> the whole leaf's shape."""
    return EncDecLM(cfg, "meta").full_shapes


#: the three attentions and the two MLPs (``TensorParallel.of`` reads their
#: split; all have the config's heads and ``d_ff``, so they split alike)
ATTENTIONS = ("enc_layers.attn.", "dec_layers.attn.", "dec_layers.cross.")
FFNS = ("enc_layers.mlp.wi", "dec_layers.mlp.wi")
#: the residual streams never split along the sequence (no config asks)
SEQUENCE_PARALLEL = False


def split_units(cfg, R: int) -> tuple:
    """Each attention's query heads and its K/V heads, split only where
    whole heads divide a model axis of ``R``."""
    return tuple(u for prefix in ATTENTIONS for u in attention_units(prefix, cfg, R))


def segments(cfg) -> dict:
    """No leaf of the encoder-decoder concatenates segments."""
    return {}


def read_partly(cfg) -> dict:
    """No unit reads a whole leaf partly by itself (``TensorParallel.of``
    adds the K/V projections where only the query heads split)."""
    return {}


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


def cache_specs(cfg) -> EncDecCache:
    """The reference's specs of the decode state: every tensor's batch over
    the data axes and its K/V heads over the model axis."""
    kv = (None, ("pod", "data"), None, "model", None)
    return EncDecCache(KVCache(kv, kv), kv, kv)


@torch.no_grad()
def init_lm(cfg, seed: int, device, model_rank: int = 0, model_axis: int = 1,
            fsdp_rank: int = 0, fsdp_size: int = 1) -> EncDecLM:
    """Random weights from ``seed`` with the reference's distributions:
    N(0, 0.02) embeddings, ``pos_dec`` N(0, 1) * 0.01, N(0,1)/sqrt(in)
    projections (both attentions' ``wo`` further scaled by 1/sqrt(2L), L the
    decoder's depth, in the encoder too), unit norm scales, zero biases.  A
    model holding a block holds that block of the whole model's draw."""
    model = EncDecLM(cfg, device, model_rank, model_axis, fsdp_rank, fsdp_size)
    gen = torch.Generator().manual_seed(seed)
    for name, p in sorted(model.named_parameters()):
        *path, leaf = name.split(".")
        block = draw_block(model, name)
        if name == "embed.tok":
            embed_init_(p, gen, **block)
        elif name == "pos_dec":
            normal_init_(p, gen, 0.01)
        elif leaf == "scale":
            p.fill_(1.0)
        elif leaf in ("bias", "bq", "bk", "bv"):
            p.zero_()
        elif leaf == "wo" and path[-1] in ("attn", "cross"):
            dense_init_(p, gen, scale=1.0 / math.sqrt(2 * cfg.num_layers), **block)
        else:
            dense_init_(p, gen, **block)
    return model


# ---------------------------------------------------------------------------
# the layers, whole or in Megatron's layout
# ---------------------------------------------------------------------------
def _params(par: Optional[TensorParallel], node: dict, prefix: str) -> dict:
    """One layer's slices of a stack, ready to compute with under ``par``."""
    return node if par is None else par.params(node, prefix, stacked=True)


def _region(par: Optional[TensorParallel], split: str, fn, h: torch.Tensor) -> torch.Tensor:
    """``fn`` (a column-then-row region: an attention or an MLP) on the
    residual's normed ``h``; under ``par`` entered and left in Megatron's
    layout where its weights split (``par``'s ``split`` flag)."""
    if par is None:
        return fn(h)
    s = getattr(par, split)
    return par.leave(fn(par.enter(h, s)), s)


def _kv_heads(par: Optional[TensorParallel]) -> dict:
    return {"kv_heads": par.kv_heads} if par is not None and par.kv_heads else {}


def _enc_layer(p: dict, x: torch.Tensor, positions: torch.Tensor, cfg,
               par: Optional[TensorParallel] = None) -> torch.Tensor:
    x = x + _region(par, "q_split", lambda h: attention(
        p["attn"], h, cfg, positions=positions, causal=False, **_kv_heads(par)),
        norm(p["ln1"], x, cfg.norm))
    return x + _region(par, "ffn_split", lambda h: mlp(p["mlp"], h, cfg.activation),
                       norm(p["ln2"], x, cfg.norm))


def _dec_layer(p: dict, x: torch.Tensor, positions: torch.Tensor, cross_kv: tuple, cfg,
               kv_cache=None, cache_index: int = 0,
               par: Optional[TensorParallel] = None) -> torch.Tensor:
    """One decoder layer: causal self-attention (over ``kv_cache`` from
    ``cache_index`` when given), cross-attention to ``cross_kv`` (the
    rank's K/V heads, or every head where they do not split), MLP."""
    def self_attention(h):
        a = attention(p["attn"], h, cfg, positions=positions, causal=True, kv_cache=kv_cache,
                      cache_index=cache_index, **_kv_heads(par))
        return a if kv_cache is None else a[0]

    x = x + _region(par, "q_split", self_attention, norm(p["ln1"], x, cfg.norm))
    x = x + _region(par, "q_split", lambda h: attention(
        p["cross"], h, cfg, positions=positions, cross_kv=cross_kv, **_kv_heads(par)),
        norm(p["ln_cross"], x, cfg.norm))
    return x + _region(par, "ffn_split", lambda h: mlp(p["mlp"], h, cfg.activation),
                       norm(p["ln2"], x, cfg.norm))


def _encode(model: EncDecLM, frames: torch.Tensor, cfg,
            par: Optional[TensorParallel]) -> torch.Tensor:
    frames = frames.to(dtype_of(cfg.compute_dtype))
    B, F = frames.shape[:2]
    x = frames + sinusoidal_positions(F, cfg.d_model, frames.device).to(frames.dtype)
    positions = _positions(0, F, B, frames.device)
    body = maybe_remat(lambda p, xx: _enc_layer(_params(par, p, "enc_layers."), xx, positions,
                                                cfg, par), cfg.parallelism.remat)
    for l in range(cfg.encdec.encoder_layers):
        x = body(model.enc_layers.layer(l), x)
    return norm(model.enc_norm.layer(), x, cfg.norm)


def encode(model: EncDecLM, frames: torch.Tensor, cfg, dist=None) -> torch.Tensor:
    """frames (B, F, d) -> the encoder's output (B, F, d), whole on every
    rank."""
    return _encode(model, frames, cfg, TensorParallel.of(model, cfg, dist))


def _cross_input(enc_out: torch.Tensor, par: Optional[TensorParallel]) -> torch.Tensor:
    """The encoder's output as the cross K/V projections read it: through
    :func:`~.tensor_parallel.copy_to` where each rank projects its K/V
    heads (its gradient is the sum of the ranks')."""
    return copy_to(enc_out, par.tp_group) if par is not None and par.q_split else enc_out


def _cross_kv(p: dict, enc_out: torch.Tensor, cfg) -> tuple:
    """One decoder layer's cross K and V (B, F, Hkv, D) from the encoder's
    output, by its ``cross`` block's ``wk`` and ``wv`` (the heads they
    hold: a rank's where they split)."""
    B, F = enc_out.shape[:2]
    shape = (B, F, -1, cfg.resolved_head_dim)
    return ((enc_out @ p["wk"].to(enc_out.dtype)).reshape(shape),
            (enc_out @ p["wv"].to(enc_out.dtype)).reshape(shape))


def _decode(model: EncDecLM, tokens: torch.Tensor, enc_out: torch.Tensor, cfg,
            par: Optional[TensorParallel]) -> torch.Tensor:
    """The teacher-forced decoder's hidden state before the final norm."""
    cdt = dtype_of(cfg.compute_dtype)
    B, S = tokens.shape
    positions = _positions(0, S, B, tokens.device)
    x = _embed(model, tokens, cfg, par) + model.pos_dec[:S].to(cdt)[None]
    enc_in = _cross_input(enc_out, par)

    def body(p, xx):
        p = _params(par, p, "dec_layers.")
        return _dec_layer(p, xx, positions, _cross_kv(p["cross"], enc_in, cfg), cfg, par=par)

    body = maybe_remat(body, cfg.parallelism.remat)
    for l in range(cfg.num_layers):
        x = body(model.dec_layers.layer(l), x)
    return x


def decode_train(model: EncDecLM, tokens: torch.Tensor, enc_out: torch.Tensor, cfg,
                 last_only: bool = False, dist=None) -> torch.Tensor:
    """The teacher-forced decoder: tokens (B, S) -> logits (B, S, vocab),
    or (B, 1, vocab) with ``last_only``."""
    par = TensorParallel.of(model, cfg, dist)
    x = _decode(model, tokens, enc_out, cfg, par)
    return _logits(model, x, cfg, par, last_only)


def _forward_local(model: EncDecLM, batch: dict, cfg, last_only: bool, dist) -> tuple:
    """(the head's logits: the whole vocabulary's, or this rank's columns
    where it splits; the call's layout)."""
    par = TensorParallel.of(model, cfg, dist, batch["tokens"].shape[1])
    x = _decode(model, batch["tokens"], _encode(model, batch["frames"], cfg, par), cfg, par)
    return _head(model, x, cfg, par, last_only), par


def forward(model: EncDecLM, batch: dict, cfg, last_only: bool = False,
            dist=None) -> torch.Tensor:
    """batch: ``frames`` (B, F, d), ``tokens`` (B, S) -> logits (B, S, vocab)
    (the reference's aux loss is a zero)."""
    logits, par = _forward_local(model, batch, cfg, last_only, dist)
    return logits if par is None else par.full_logits(logits)


def loss_fn(model: EncDecLM, batch: dict, cfg, dist=None) -> torch.Tensor:
    """Token-mean cross-entropy (vocabulary-parallel where the vocabulary
    splits)."""
    logits, par = _forward_local(model, batch, cfg, False, dist)
    return _lm_loss(logits, batch["targets"], cfg, par)


# ---------------------------------------------------------------------------
# cached decode
# ---------------------------------------------------------------------------
@torch.no_grad()
def init_cache(model: EncDecLM, frames: torch.Tensor, cfg, batch: int,
               max_seq: int, dist=None, dtype=torch.bfloat16) -> EncDecCache:
    """Run the encoder once on ``frames`` and keep every decoder layer's
    cross K/V in ``dtype`` (bfloat16, as the reference's); a zero
    self-attention cache of ``max_seq`` positions in ``dtype``.  Both hold
    the K/V heads ``model`` holds (a rank's where they split)."""
    par = TensorParallel.of(model, cfg, dist)
    enc_out = _encode(model, frames, cfg, par)
    kv = [_cross_kv(_params(par, model.dec_layers.layer(l), "dec_layers.")["cross"], enc_out,
                    cfg) for l in range(cfg.num_layers)]
    return EncDecCache(
        init_kv_cache(cfg, batch, max_seq, dtype, frames.device, layers=cfg.num_layers,
                      kv_heads=kv[0][0].shape[2]),
        torch.stack([k for k, _ in kv]).to(dtype),
        torch.stack([v for _, v in kv]).to(dtype))


def decode_step(model: EncDecLM, token: torch.Tensor, cache: EncDecCache, index,
                cfg, dist=None) -> tuple:
    """One token per sequence at position ``index``: token (B, 1) ->
    (logits (B, vocab), cache).  The self-attention cache is written in
    place."""
    cdt = dtype_of(cfg.compute_dtype)
    B = token.shape[0]
    index = int(index)
    par = TensorParallel.of(model, cfg, dist)
    positions = _positions(index, 1, B, token.device)
    x = _embed(model, token, cfg, par) + model.pos_dec[index:index + 1].to(cdt)[None]
    kv = cache.self_kv
    for l in range(cfg.num_layers):
        x = _dec_layer(_params(par, model.dec_layers.layer(l), "dec_layers."), x, positions,
                       (cache.cross_k[l].to(cdt), cache.cross_v[l].to(cdt)), cfg,
                       kv_cache=KVCache(kv.k[l], kv.v[l]), cache_index=index, par=par)
    return _logits(model, x, cfg, par)[:, 0, :], cache
