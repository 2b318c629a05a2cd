"""RWKV6 "Finch" (the ssm family): an attention-free LM with a
data-dependent per-channel decay — the full-sequence forward (training,
prefill) and the one-token decode over the O(1) recurrent state.

Time-mix: a data-dependent token shift (ddlerp with a low-rank adapter),
then the WKV6 recurrence

    y_t[j] = sum_i r_t[i] * (S[i,j] + u[i] k_t[i] v_t[j])
    S[i,j] <- w_t[i] * S[i,j] + k_t[i] * v_t[j]

The full-sequence forward runs it from a zero state and drops the final
state.  The reference runs it in lax (``wkv6_chunked``); the port runs the
WKV6 kernel through ``kernels/rwkv6_scan/ops.wkv6_apply``: the CUDA kernel
on a CUDA tensor, the plain chunked version on the CPU, and in the backward
the plain chunked form's gradient (the reference's lax gradient).  Each
layer runs under ``maybe_remat`` (``parallelism.remat``).  Channel-mix: a
relu² FFN with token-shift gates.

Decode (:func:`decode_step`) carries :class:`RwkvState`: each layer's last
time-mix and channel-mix inputs (the token shift, stored float32 and cast
to the stream's dtype on every step, as the reference does) and its WKV
state, advanced by ``wkv6_step``; no kernel runs.  Unlike the reference,
which returns new arrays, the step writes the state in place and returns
it.

Parameters keep the reference's tree (``layers.{ln1, ln2, mu_base, mu,
lora_a, lora_b, wr, wk, wv, wg, wo, w0, u, ln_x, cm_mu_k, cm_mu_r, cm_wk,
cm_wv, cm_wr}`` stacked on ``L``; ``ln_x`` a per-head layernorm), so
``model.from_jax_params`` is a name map.  The layers run in a Python loop.

On the model axis (a model built for a :class:`~.tensor_parallel.Part`)
the layout is the reference's ``spec_lm``: ``wr``, ``wk``, ``wv``, ``wg``
split by output and ``wo`` by input, so the time mix runs ``wkv6`` on the
rank's ``H / model_axis`` heads, their slice of ``w0``, ``u`` and the
decay adapter's ``lora_b[3]`` columns, and the per-head ``ln_x``; its
input (the normed residual) enters through ``copy_to`` before the token
shift and its output leaves through ``reduce_from``.  The channel mix's
``cm_wk``/``cm_wv`` are a Megatron pair and ``cm_wr`` splits by output:
the pair's partial output is reduce-scattered along the features,
multiplied by the rank's gate columns and all-gathered back.  The leaves
held whole that a rank reads only partly have their gradient summed over
the model axis (:func:`read_partly`).  The decode state holds
the rank's WKV heads (:func:`init_state`, :func:`state_specs`).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.rwkv6_scan.ops import wkv6_apply
from ..kernels.rwkv6_scan.ref import wkv6_chunked  # noqa: F401  (the reference's name)
from ..runtime.device import resolve_device
from .common import (
    dense_init_,
    dtype_of,
    embed_init_,
    embed_shapes,
    maybe_remat,
    norm,
    norm_shapes,
    normal_init_,
    spec_embedding,
    spec_norm,
    stack_specs,
    widened,
)
from .tensor_parallel import Part, TensorParallel, draw_block, gather, held_layout, hold
from .tensor_parallel import is_split, scatter
from .transformer import _embed, _head, _lm_loss, _logits

LORA_DIM = 32
BRANCHES = 5                      # r, k, v, w, g
WLOG_MIN, WLOG_MAX = -5.0, -1e-4  # per-step log-decay clamp (fp32-stable chunks)


class RwkvState(NamedTuple):
    """The recurrent decode state of the layer stack."""

    shift_tm: torch.Tensor  # (L, B, d) f32: each layer's last time-mix input
    shift_cm: torch.Tensor  # (L, B, d) f32: its last channel-mix input
    wkv: torch.Tensor       # (L, B, H, N, N) f32


class RwkvLM(nn.Module):
    """Parameters of the rwkv6 LM; the forward math is :func:`forward`.
    ``model_rank``/``model_axis`` and ``fsdp_rank``/``fsdp_size``: this
    rank's block of every leaf the model axis and the fsdp axes split
    (``tensor_parallel.hold``)."""

    def __init__(self, cfg, device, model_rank: int = 0, model_axis: int = 1,
                 fsdp_rank: int = 0, fsdp_size: int = 1) -> None:
        super().__init__()
        if cfg.family != "ssm":
            raise ValueError(f"RwkvLM builds the ssm family, got {cfg.family!r}")
        L, d, f, N = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.ssm.head_dim
        pdt = dtype_of(cfg.param_dtype)
        f32 = torch.promote_types(pdt, torch.float32)  # float64 in a float64 model
        hold(self, cfg, {
            "embed": embed_shapes(cfg, pdt),
            "final_norm": norm_shapes((d,), cfg.norm, f32),
            "layers": {
                "mu_base": ((L, d), f32), "mu": ((L, BRANCHES, d), f32),
                "lora_a": ((L, d, LORA_DIM * BRANCHES), f32),
                "lora_b": ((L, BRANCHES, LORA_DIM, d), f32),
                "wr": ((L, d, d), pdt), "wk": ((L, d, d), pdt), "wv": ((L, d, d), pdt),
                "wg": ((L, d, d), pdt), "wo": ((L, d, d), pdt),
                "w0": ((L, d), f32), "u": ((L, d), f32),
                "cm_mu_k": ((L, d), f32), "cm_mu_r": ((L, d), f32),
                "cm_wk": ((L, d, f), pdt), "cm_wv": ((L, f, d), pdt),
                "cm_wr": ((L, d, d), pdt)},
            "layers.ln1": norm_shapes((L, d), cfg.norm, f32),
            "layers.ln2": norm_shapes((L, d), cfg.norm, f32),
            "layers.ln_x": norm_shapes((L, N), "layernorm", f32),  # per head
        }, device, Part(model_rank, model_axis, fsdp_rank, fsdp_size))


def full_shapes(cfg) -> dict:
    """Leaf name -> the whole leaf's shape."""
    return RwkvLM(cfg, "meta").full_shapes


def split_units(cfg, R: int) -> tuple:
    """The units ``tensor_parallel.held_layout`` splits together over a
    model axis of ``R``: the time mix where whole heads divide it, the
    channel mix where the axis divides both ``d_ff`` and ``d_model``."""
    d, f, N = cfg.d_model, cfg.d_ff, cfg.ssm.head_dim
    return ((tuple(f"layers.{k}" for k in ("wr", "wk", "wv", "wg", "wo")), (d // N) % R == 0),
            (("layers.cm_wk", "layers.cm_wv", "layers.cm_wr"), f % R == 0 and d % R == 0))


def segments(cfg) -> dict:
    """No leaf of rwkv6 concatenates segments."""
    return {}


#: no attention and no MLP (the channel mix is a unit of its own); the
#: residual stream never splits along the sequence
ATTENTIONS = ()
FFNS = ()
SEQUENCE_PARALLEL = False


def read_partly(cfg) -> dict:
    """A unit's leaf that says it splits -> the leaves held whole that the
    unit then reads only partly, whose gradient is summed over the model
    axis: the time mix's token-shift mixes and adapters (the replicated
    input is mixed, then read by the rank's heads), ``w0`` and ``u`` (its
    heads' slice) and the per-head ``ln_x``; the channel mix's mixes."""
    return {"layers.wr": ("layers.mu_base", "layers.mu", "layers.lora_a", "layers.lora_b",
                          "layers.w0", "layers.u", "layers.ln_x.scale", "layers.ln_x.bias"),
            "layers.cm_wk": ("layers.cm_mu_k", "layers.cm_mu_r")}


def spec_rwkv_layer(cfg, fsdp, tp) -> dict:
    """One rwkv6 layer's parameter specs (the reference's)."""
    return {
        "ln1": spec_norm(cfg.norm),
        "ln2": spec_norm(cfg.norm),
        "mu_base": (None,),
        "mu": (None, None),
        "lora_a": (fsdp, None),
        "lora_b": (None, None, fsdp),
        "wr": (fsdp, tp),
        "wk": (fsdp, tp),
        "wv": (fsdp, tp),
        "wg": (fsdp, tp),
        "wo": (tp, fsdp),
        "w0": (None,),
        "u": (None,),
        "ln_x": spec_norm("layernorm"),
        "cm_mu_k": (None,),
        "cm_mu_r": (None,),
        "cm_wk": (fsdp, tp),
        "cm_wv": (tp, fsdp),
        "cm_wr": (fsdp, tp),
    }


def spec_lm(cfg, fsdp="data", tp="model") -> dict:
    """Parameter specs with :class:`RwkvLM`'s keys; the stacked layer
    leaves lead with the layer axis (``None``)."""
    return {
        "embed": spec_embedding(cfg.tie_embeddings, tp, fsdp,
                                vocab=cfg.vocab_size, tp_size=cfg.parallelism.tp_size),
        "layers": stack_specs(spec_rwkv_layer(cfg, fsdp, tp)),
        "final_norm": spec_norm(cfg.norm),
    }


@torch.no_grad()
def init_lm(cfg, seed: int, device, model_rank: int = 0, model_axis: int = 1,
            fsdp_rank: int = 0, fsdp_size: int = 1) -> RwkvLM:
    """Random weights from ``seed`` with the reference's distributions
    (``rwkv.py:58-87`` there): N(0,1)/sqrt(in) projections and adapter
    ``lora_a`` (``wo`` further scaled by 1/sqrt(2L)), ``lora_b`` N(0, 0.01),
    ``u`` N(0, 0.1), ``w0`` -2, zero token-shift mixes, N(0, 0.02)
    embeddings, unit norm scales and zero biases.  A model holding a block
    holds that block of the whole model's draw."""
    model = RwkvLM(cfg, device, model_rank, model_axis, fsdp_rank, fsdp_size)
    gen = torch.Generator().manual_seed(seed)
    for name, p in sorted(model.named_parameters()):
        leaf = name.rsplit(".", 1)[-1]
        block = draw_block(model, name)
        if name == "embed.tok":
            embed_init_(p, gen, **block)
        elif leaf == "scale":
            p.fill_(1.0)
        elif leaf in ("bias", "mu_base", "mu", "cm_mu_k", "cm_mu_r"):
            p.zero_()
        elif leaf == "w0":
            p.fill_(-2.0)
        elif leaf == "lora_b":
            normal_init_(p, gen, 0.01, **block)
        elif leaf == "u":
            normal_init_(p, gen, 0.1, **block)
        elif leaf == "wo":
            dense_init_(p, gen, scale=1.0 / math.sqrt(2 * cfg.num_layers), **block)
        else:
            dense_init_(p, gen, **block)
    return model


# ---------------------------------------------------------------------------
# the recurrence's single step (decode)
# ---------------------------------------------------------------------------
def wkv6_step(r, k, v, wlog, u, state):
    """Single-token recurrence. r..: (B, H, N); state: (B, H, N, N)."""
    kv = torch.einsum("bhi,bhj->bhij", k, v)
    y = torch.einsum("bhi,bhij->bhj", r, state + u[None, :, :, None] * kv)
    state = torch.exp(wlog)[..., None] * state + kv
    return y, state


# ---------------------------------------------------------------------------
# time-mix / channel-mix
# ---------------------------------------------------------------------------
def _ddlerp(p: dict, x, x_prev):
    """Data-dependent token shift (v6). Returns the five mixed branches."""
    xx = x_prev - x
    base = x + xx * p["mu_base"].to(x.dtype)
    lora = torch.tanh(widened(base) @ p["lora_a"])
    lora = lora.reshape(*lora.shape[:-1], BRANCHES, LORA_DIM)
    dyn = torch.einsum("...kl,kld->...kd", lora, p["lora_b"])
    mixes = p["mu"] + dyn  # (..., 5, d)
    return [x + xx * mixes[..., i, :].to(x.dtype) for i in range(BRANCHES)]


def time_mix(p: dict, x, x_prev, cfg, chunk: int = 32, state=None, lo: int = 0):
    """x: (B, T, d), x_prev the shifted x: the WKV6 scan from a zero state
    through the kernel registry, returning the block's output (B, T, d).
    With ``state`` (B, H, N, N), x is one token (B, 1, d), x_prev the
    stored shift, and the result is (output, new state), by ``wkv6_step``.
    ``p`` may hold a rank's heads (``wr``'s columns from ``lo``, ``wo``'s
    rows): the scan then runs on those heads and the output is the rank's
    partial sum."""
    N = cfg.ssm.head_dim
    B, T = x.shape[0], x.shape[1]
    dh = p["wr"].shape[-1]  # the heads' columns this call computes
    H, cols = dh // N, slice(lo, lo + dh)
    xr, xk, xv, xw, xg = _ddlerp(p, x, x_prev)
    r = widened((xr @ p["wr"].to(x.dtype)).reshape(B, T, H, N))
    k = widened((xk @ p["wk"].to(x.dtype)).reshape(B, T, H, N))
    v = widened((xv @ p["wv"].to(x.dtype)).reshape(B, T, H, N))
    g = F.silu(xg @ p["wg"].to(x.dtype))
    # as the reference (rwkv.py:185): the decay branch's adapter is the
    # first branch's lora_a columns with lora_b[3] (its heads' columns)
    wlog_raw = p["w0"][cols] + (widened(xw) @ p["lora_a"][:, :LORA_DIM]) @ p["lora_b"][3][:, cols]
    wlog = torch.clamp(-torch.exp(wlog_raw), WLOG_MIN, WLOG_MAX).reshape(B, T, H, N)
    u = p["u"][cols].reshape(H, N)
    if state is None:
        y = wkv6_apply(r, k, v, wlog, u, chunk=chunk)
    else:
        y, state = wkv6_step(r[:, 0], k[:, 0], v[:, 0], wlog[:, 0], u, state)
        y = y[:, None]
    # per-head group norm, then gate and project
    y = norm(p["ln_x"], y, "layernorm")
    y = y.reshape(B, T, dh).to(x.dtype) * g
    out = y @ p["wo"].to(x.dtype)
    return out if state is None else (out, state)


def channel_mix(p: dict, x, x_prev, cfg, par: Optional[TensorParallel] = None):
    """The relu² FFN with a sigmoid gate.  Where ``par`` splits it, ``p``
    holds the rank's ``cm_wk`` columns, ``cm_wv`` rows and ``cm_wr``
    columns: the pair's partial output is reduce-scattered along the
    features to the gate's columns, and the product all-gathered back."""
    xx = x_prev - x
    xk = x + xx * p["cm_mu_k"].to(x.dtype)
    xr = x + xx * p["cm_mu_r"].to(x.dtype)
    kk = torch.square(F.relu(xk @ p["cm_wk"].to(x.dtype)))
    kv = kk @ p["cm_wv"].to(x.dtype)
    gate = torch.sigmoid(xr @ p["cm_wr"].to(x.dtype))
    if par is None or not par.splits("layers.cm_wk"):
        return gate * kv
    return gather(gate * scatter(kv, par.tp_group, -1), par.tp_group, -1, partial=False)


def _shift(x):
    """x_prev[t] = x[t-1] (zeros at t=0)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _layer_fwd(p: dict, x, cfg, par: Optional[TensorParallel] = None):
    tm, cm = _split_units(par)
    h = norm(p["ln1"], x, cfg.norm)
    if tm:
        h = par.enter(h, True)
    y = time_mix(p, h, _shift(h), cfg, chunk=cfg.ssm.chunk_size, lo=_lo(p, par, tm))
    x = x + (par.leave(y, True) if tm else y)
    h2 = norm(p["ln2"], x, cfg.norm)
    if cm:
        h2 = par.enter(h2, True)
    return x + channel_mix(p, h2, _shift(h2), cfg, par)


def _layer_step(p: dict, x, st_tm, st_cm, wkv, cfg, par: Optional[TensorParallel] = None):
    """One token through one layer.  x: (B, 1, d).  The shift states are
    stored float32 and cast to the stream's dtype here; the new ones are the
    normed inputs cast back to float32.  Returns (x, shift_tm, shift_cm,
    wkv)."""
    tm, cm = _split_units(par)
    h = norm(p["ln1"], x, cfg.norm)
    y, wkv = time_mix(p, par.enter(h, True) if tm else h, st_tm[:, None].to(h.dtype), cfg,
                      state=wkv, lo=_lo(p, par, tm))
    x = x + (par.leave(y, True) if tm else y)
    h2 = norm(p["ln2"], x, cfg.norm)
    x = x + channel_mix(p, par.enter(h2, True) if cm else h2, st_cm[:, None].to(h2.dtype),
                        cfg, par)
    return x, h[:, 0].float(), h2[:, 0].float(), wkv


def _split_units(par: Optional[TensorParallel]) -> tuple:
    """(the time mix splits, the channel mix splits) under ``par``."""
    if par is None:
        return False, False
    return par.splits("layers.wr"), par.splits("layers.cm_wk")


def _lo(p: dict, par: Optional[TensorParallel], tm: bool) -> int:
    """The first of the time mix's columns this rank computes."""
    return par.part.tp_rank * p["wr"].shape[-1] if tm else 0


def _params(par: Optional[TensorParallel], p: dict) -> dict:
    return p if par is None else par.params(p, "layers.", stacked=True)


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------
def _forward_local(model: RwkvLM, tokens: torch.Tensor, cfg, last_only: bool, dist) -> tuple:
    """(the head's logits: the whole vocabulary's, or this rank's columns
    where it splits; the call's layout)."""
    par = TensorParallel.of(model, cfg, dist, tokens.shape[1])
    x = _embed(model, tokens, cfg, par)
    layer = maybe_remat(lambda p, xx: _layer_fwd(_params(par, p), xx, cfg, par),
                        cfg.parallelism.remat)
    for l in range(cfg.num_layers):
        x = layer(model.layers.layer(l), x)
    return _head(model, x, cfg, par, last_only), par


def forward(model: RwkvLM, tokens: torch.Tensor, cfg, last_only: bool = False,
            dist=None) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, vocab), or (B, 1, vocab) with
    ``last_only`` (the residual sliced to the last position before the
    unembed)."""
    logits, par = _forward_local(model, tokens, cfg, last_only, dist)
    return logits if par is None else par.full_logits(logits)


def loss_fn(model: RwkvLM, batch: dict, cfg, dist=None) -> torch.Tensor:
    logits, par = _forward_local(model, batch["tokens"], cfg, False, dist)
    return _lm_loss(logits, batch["targets"], cfg, par)


# ---------------------------------------------------------------------------
# decode: the O(1) recurrent state
# ---------------------------------------------------------------------------
def init_state(cfg, batch: int, device=None, model_axis: int = 1) -> RwkvState:
    """The zero state for ``batch`` sequences, float32; a model on
    ``model_axis`` ranks whose time mix splits holds its
    ``H / model_axis`` WKV heads."""
    d, L, N = cfg.d_model, cfg.num_layers, cfg.ssm.head_dim
    H = d // N
    if model_axis > 1 and is_split(held_layout(cfg, Part(0, model_axis))["layers.wr"]):
        H //= model_axis
    dev = resolve_device(device)
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)  # noqa: E731
    return RwkvState(zeros(L, batch, d), zeros(L, batch, d), zeros(L, batch, H, N, N))


def state_specs(cfg) -> RwkvState:
    """The reference's specs of the decode state: batch over the data
    axes, the WKV state's heads over the model axis."""
    b = (None, ("pod", "data"), None)
    return RwkvState(b, b, (None, ("pod", "data"), "model", None, None))


def decode_step(model: RwkvLM, token: torch.Tensor, state: RwkvState, index, cfg,
                dist=None) -> tuple:
    """One token per sequence: token (B, 1) -> (logits (B, vocab), state).
    ``index`` (the position) is not read: the state carries the history.
    The state is written in place."""
    par = TensorParallel.of(model, cfg, dist)
    x = _embed(model, token, cfg, par)
    for l in range(cfg.num_layers):
        x, tm, cm, wkv = _layer_step(_params(par, model.layers.layer(l)), x,
                                     state.shift_tm[l], state.shift_cm[l], state.wkv[l], cfg,
                                     par)
        state.shift_tm[l].copy_(tm)
        state.shift_cm[l].copy_(cm)
        state.wkv[l].copy_(wkv)
    return _logits(model, x, cfg, par)[:, 0, :], state
