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

On the model axis (a model built for a :class:`~.tensor_parallel.Part`)
the layout is the reference's ``spec_lm``: each Mamba2 layer split as
``mamba.mamba_block`` computes it (per segment); the shared block's
``in_proj`` and ``out_proj`` split by output, each product entered through
``copy_to`` and all-gathered back to the whole ``d`` (every rank computes
the same downstream, so the gather's backward takes the rank's slice);
its attention and MLP split as the dense family's (heads, ``d_ff``);
the vocabulary as the transformer's.  The embedding ``emb0`` is whole
after its reduction and enters the shared block's ``in_proj`` with the
residual.  The decode state holds the rank's conv channels, SSM heads and
K/V heads (:func:`init_state`, :func:`state_specs`).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from ..runtime.device import resolve_device
from .attention import KVCache, attention, attention_shapes, init_kv_cache, spec_attention
from .common import (
    dense_init_,
    dtype_of,
    embed_init_,
    embed_shapes,
    maybe_remat,
    norm,
    norm_shapes,
    spec_embedding,
    spec_norm,
    stack_specs,
)
from .mamba import (MambaState, init_mamba_param_, init_mamba_state, mamba_block,
                    mamba_divides, mamba_layer_shapes, mamba_segments, mamba_state_specs,
                    spec_mamba_layer)
from .mlp import mlp, mlp_shapes, spec_mlp
from .tensor_parallel import Part, TensorParallel, draw_block, gather, held_layout, hold
from .tensor_parallel import is_split
from .transformer import _embed, _head, _lm_loss, _logits, attention_units


class HybridState(NamedTuple):
    mamba: MambaState   # every layer's, stacked (L, ...)
    attn_kv: KVCache    # (F, B, max_seq, Hkv, hd) bfloat16, one cache per firing


class HybridLM(nn.Module):
    """Parameters of the hybrid LM (``layers``: the stacked Mamba2 layers;
    ``shared``: the one attention block); the math is :func:`forward`.
    ``model_rank``/``model_axis`` and ``fsdp_rank``/``fsdp_size``: this
    rank's block of every leaf the model axis and the fsdp axes split
    (``tensor_parallel.hold``)."""

    def __init__(self, cfg, device, model_rank: int = 0, model_axis: int = 1,
                 fsdp_rank: int = 0, fsdp_size: int = 1) -> None:
        super().__init__()
        if cfg.family != "hybrid":
            raise ValueError(f"HybridLM builds the hybrid family, got {cfg.family!r}")
        d, pdt = cfg.d_model, dtype_of(cfg.param_dtype)
        params, norms = mamba_layer_shapes(cfg, pdt, cfg.num_layers)
        shared_in = 2 * d if cfg.hybrid.concat_embedding else d
        hold(self, cfg, {
            "embed": embed_shapes(cfg, pdt),
            "final_norm": norm_shapes((d,), cfg.norm),
            "layers": params,
            **{f"layers.{name}": shapes for name, shapes in norms.items()},
            "shared": {"in_proj": ((shared_in, d), pdt), "out_proj": ((d, d), pdt)},
            "shared.ln1": norm_shapes((d,), cfg.norm),
            "shared.attn": attention_shapes(cfg, pdt),
            "shared.ln2": norm_shapes((d,), cfg.norm),
            "shared.mlp": mlp_shapes(d, cfg.d_ff, cfg.activation, pdt),
        }, device, Part(model_rank, model_axis, fsdp_rank, fsdp_size))


def full_shapes(cfg) -> dict:
    """Leaf name -> the whole leaf's shape."""
    return HybridLM(cfg, "meta").full_shapes


def split_units(cfg, R: int) -> tuple:
    """The units ``tensor_parallel.held_layout`` splits together over a
    model axis of ``R``: a Mamba2 layer where its heads and B/C channels
    divide it, the shared projections where ``d_model`` does, the shared
    attention's query and K/V heads where whole heads do."""
    return ((("layers.in_proj", "layers.conv_w", "layers.conv_b", "layers.out_proj"),
             mamba_divides(cfg, R)),
            (("shared.in_proj", "shared.out_proj"), cfg.d_model % R == 0),
            *attention_units(ATTENTIONS[0], cfg, R))


def segments(cfg) -> dict:
    """The Mamba2 leaves whose model-axis dimension concatenates segments."""
    return {f"layers.{k}": v for k, v in mamba_segments(cfg).items()}


#: the shared block's attention and MLP; the residual stream never splits
#: along the sequence
ATTENTIONS = ("shared.attn.",)
FFNS = ("shared.mlp.wi",)
SEQUENCE_PARALLEL = False


def read_partly(cfg) -> dict:
    """A Mamba2 layer split (``in_proj``) reads its heads' slice of the
    leaves held whole ``A_log``, ``D``, ``dt_bias`` and ``out_norm``'s
    scale: their gradient is summed over the model axis."""
    return {"layers.in_proj": ("layers.A_log", "layers.D", "layers.dt_bias",
                               "layers.out_norm.scale")}


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
def init_lm(cfg, seed: int, device, model_rank: int = 0, model_axis: int = 1,
            fsdp_rank: int = 0, fsdp_size: int = 1) -> HybridLM:
    """Random weights from ``seed`` with the reference's distributions: the
    Mamba2 layers' (``mamba.init_mamba_param_``); in the shared block
    N(0,1)/sqrt(in) projections, attention's ``wo`` scaled by 1/sqrt(2L)
    and ``out_proj`` by 0.5; N(0, 0.02) embeddings, unit norm scales and
    zero biases.  A model holding a block holds that block of the whole
    model's draw."""
    model = HybridLM(cfg, device, model_rank, model_axis, fsdp_rank, fsdp_size)
    gen = torch.Generator().manual_seed(seed)
    for name, p in sorted(model.named_parameters()):
        leaf = name.rsplit(".", 1)[-1]
        block = draw_block(model, name)
        if name == "embed.tok":
            embed_init_(p, gen, **block)
        elif leaf == "scale":
            p.fill_(1.0)
        elif leaf in ("bias", "bq", "bk", "bv"):
            p.zero_()
        elif name.startswith("layers."):
            init_mamba_param_(leaf, p, gen, cfg, **block)
        elif name == "shared.attn.wo":
            dense_init_(p, gen, scale=1.0 / math.sqrt(2 * cfg.num_layers), **block)
        elif name == "shared.out_proj":
            dense_init_(p, gen, scale=0.5, **block)
        else:
            dense_init_(p, gen, **block)
    return model


def _project(par: Optional[TensorParallel], name: str, p: dict, x):
    """``x @ p[name]``: where ``par`` splits the leaf by output, ``x``
    entered and the rank's columns all-gathered back."""
    w = p[name.rsplit(".", 1)[-1]]
    if par is None or not par.splits(name):
        return x @ w.to(x.dtype)
    return gather(par.enter(x, True) @ w.to(x.dtype), par.tp_group, -1, partial=False)


def _shared_block(p: dict, x, emb0, positions, cfg, kv_cache=None, cache_index: int = 0,
                  par: Optional[TensorParallel] = None):
    inp = torch.cat([x, emb0], dim=-1) if cfg.hybrid.concat_embedding else x
    h = _project(par, "shared.in_proj", p, inp)
    kw = {"kv_heads": par.kv_heads} if par is not None and par.kv_heads else {}
    hn = norm(p["ln1"], h, cfg.norm)
    a = attention(p["attn"], hn if par is None else par.enter(hn, par.q_split), cfg,
                  positions=positions, causal=True, kv_cache=kv_cache, cache_index=cache_index,
                  **kw)
    a = a if kv_cache is None else a[0]
    h = h + (a if par is None else par.leave(a, par.q_split))
    hn = norm(p["ln2"], h, cfg.norm)
    f = mlp(p["mlp"], hn if par is None else par.enter(hn, par.ffn_split), cfg.activation)
    h = h + (f if par is None else par.leave(f, par.ffn_split))
    return x + _project(par, "shared.out_proj", p, h)


def _params(par: Optional[TensorParallel], node: dict, prefix: str, stacked: bool) -> dict:
    return node if par is None else par.params(node, prefix, stacked)


def _forward_local(model: HybridLM, tokens: torch.Tensor, cfg, last_only: bool, dist) -> tuple:
    """(the head's logits: the whole vocabulary's, or this rank's columns
    where it splits; the call's layout)."""
    B, S = tokens.shape
    par = TensorParallel.of(model, cfg, dist, S)
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)[None, :].expand(B, S)
    emb0 = _embed(model, tokens, cfg, par)
    shared = model.shared.layer()
    every = cfg.hybrid.shared_attn_every

    def body(p, xx, fire: bool):
        xx = xx + mamba_block(_params(par, p, "layers.", True), xx, cfg, par=par)
        if not fire:
            return xx
        return _shared_block(_params(par, shared, "shared.", False), xx, emb0, positions, cfg,
                             par=par)

    body = maybe_remat(body, cfg.parallelism.remat)
    x = emb0
    for l in range(cfg.num_layers):
        x = body(model.layers.layer(l), x, (l + 1) % every == 0)
    return _head(model, x, cfg, par, last_only), par


def forward(model: HybridLM, tokens: torch.Tensor, cfg, last_only: bool = False,
            dist=None) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, vocab), or (B, 1, vocab) with
    ``last_only``."""
    logits, par = _forward_local(model, tokens, cfg, last_only, dist)
    return logits if par is None else par.full_logits(logits)


def loss_fn(model: HybridLM, batch: dict, cfg, dist=None) -> torch.Tensor:
    logits, par = _forward_local(model, batch["tokens"], cfg, False, dist)
    return _lm_loss(logits, batch["targets"], cfg, par)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def num_firings(cfg) -> int:
    return cfg.num_layers // cfg.hybrid.shared_attn_every


def init_state(cfg, batch: int, max_seq: int, device=None, model_axis: int = 1) -> HybridState:
    """Zero Mamba2 states for every layer and a zero bfloat16 KV cache of
    ``max_seq`` positions for every firing of the shared block (bfloat16
    whatever the model's dtypes, as in the reference); on ``model_axis``
    ranks, a rank's conv channels, SSM heads and K/V heads where they
    split."""
    dev = resolve_device(device)
    heads = cfg.num_kv_heads
    if model_axis > 1 and is_split(held_layout(cfg, Part(0, model_axis))["shared.attn.wk"]):
        heads //= model_axis
    return HybridState(init_mamba_state(cfg, batch, dev, layers=cfg.num_layers,
                                        model_axis=model_axis),
                       init_kv_cache(cfg, batch, max_seq, torch.bfloat16, dev,
                                     layers=num_firings(cfg), kv_heads=heads))


def state_specs(cfg) -> HybridState:
    """The reference's specs of the decode state: every layer's Mamba2
    state's (a leading layer axis) and the caches' batch over the data
    axes and K/V heads over the model axis."""
    ms = mamba_state_specs()
    kv = (None, ("pod", "data"), None, "model", None)
    return HybridState(MambaState(*((None, *s) for s in ms)), KVCache(kv, kv))


def decode_step(model: HybridLM, token: torch.Tensor, state: HybridState, index,
                cfg, dist=None) -> tuple:
    """One token per sequence at position ``index``: token (B, 1) ->
    (logits (B, vocab), state).  The state is written in place."""
    B = token.shape[0]
    index = int(index)
    par = TensorParallel.of(model, cfg, dist)
    positions = torch.full((B, 1), index, dtype=torch.int32, device=token.device)
    emb0 = _embed(model, token, cfg, par)
    shared = _params(par, model.shared.layer(), "shared.", False)
    every = cfg.hybrid.shared_attn_every
    ms, kv = state.mamba, state.attn_kv
    x = emb0
    for l in range(cfg.num_layers):
        y, new = mamba_block(_params(par, model.layers.layer(l), "layers.", True), x, cfg,
                             state=MambaState(ms.conv[l], ms.ssm[l]), par=par)
        ms.conv[l].copy_(new.conv)
        ms.ssm[l].copy_(new.ssm)
        x = x + y
        if (l + 1) % every == 0:
            f = (l + 1) // every - 1
            x = _shared_block(shared, x, emb0, positions, cfg, kv_cache=KVCache(kv.k[f], kv.v[f]),
                              cache_index=index, par=par)
    return _logits(model, x, cfg, par)[:, 0, :], state
