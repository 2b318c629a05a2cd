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
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.rwkv6_scan.ops import wkv6_apply
from ..kernels.rwkv6_scan.ref import wkv6_chunked  # noqa: F401  (the reference's name)
from ..runtime.device import resolve_device
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
    softmax_cross_entropy,
    spec_embedding,
    spec_norm,
    stack_specs,
    unembed,
)

LORA_DIM = 32
BRANCHES = 5                      # r, k, v, w, g
WLOG_MIN, WLOG_MAX = -5.0, -1e-4  # per-step log-decay clamp (fp32-stable chunks)


class RwkvState(NamedTuple):
    """The recurrent decode state of the layer stack."""

    shift_tm: torch.Tensor  # (L, B, d) f32: each layer's last time-mix input
    shift_cm: torch.Tensor  # (L, B, d) f32: its last channel-mix input
    wkv: torch.Tensor       # (L, B, H, N, N) f32


class RwkvLM(nn.Module):
    """Parameters of the rwkv6 LM; the forward math is :func:`forward`."""

    def __init__(self, cfg, device) -> None:
        super().__init__()
        if cfg.family != "ssm":
            raise ValueError(f"RwkvLM builds the ssm family, got {cfg.family!r}")
        L, d, f, N = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.ssm.head_dim
        pdt, f32 = dtype_of(cfg.param_dtype), torch.float32
        self.embed = ParamBlock(embed_shapes(cfg, pdt), device)
        self.final_norm = ParamBlock(norm_shapes((d,), cfg.norm), device)
        self.layers = ParamBlock({
            "mu_base": ((L, d), f32), "mu": ((L, BRANCHES, d), f32),
            "lora_a": ((L, d, LORA_DIM * BRANCHES), f32),
            "lora_b": ((L, BRANCHES, LORA_DIM, d), f32),
            "wr": ((L, d, d), pdt), "wk": ((L, d, d), pdt), "wv": ((L, d, d), pdt),
            "wg": ((L, d, d), pdt), "wo": ((L, d, d), pdt),
            "w0": ((L, d), f32), "u": ((L, d), f32),
            "cm_mu_k": ((L, d), f32), "cm_mu_r": ((L, d), f32),
            "cm_wk": ((L, d, f), pdt), "cm_wv": ((L, f, d), pdt), "cm_wr": ((L, d, d), pdt),
        }, device)
        self.layers.ln1 = ParamBlock(norm_shapes((L, d), cfg.norm), device)
        self.layers.ln2 = ParamBlock(norm_shapes((L, d), cfg.norm), device)
        self.layers.ln_x = ParamBlock(norm_shapes((L, N), "layernorm"), device)  # per head


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
def init_lm(cfg, seed: int, device) -> RwkvLM:
    """Random weights from ``seed`` with the reference's distributions
    (``rwkv.py:58-87`` there): N(0,1)/sqrt(in) projections and adapter
    ``lora_a`` (``wo`` further scaled by 1/sqrt(2L)), ``lora_b`` N(0, 0.01),
    ``u`` N(0, 0.1), ``w0`` -2, zero token-shift mixes, N(0, 0.02)
    embeddings, unit norm scales and zero biases."""
    model = RwkvLM(cfg, device)
    gen = torch.Generator().manual_seed(seed)
    for name, p in sorted(model.named_parameters()):
        leaf = name.rsplit(".", 1)[-1]
        if name == "embed.tok":
            embed_init_(p, gen)
        elif leaf == "scale":
            p.fill_(1.0)
        elif leaf in ("bias", "mu_base", "mu", "cm_mu_k", "cm_mu_r"):
            p.zero_()
        elif leaf == "w0":
            p.fill_(-2.0)
        elif leaf == "lora_b":
            normal_init_(p, gen, 0.01)
        elif leaf == "u":
            normal_init_(p, gen, 0.1)
        elif leaf == "wo":
            dense_init_(p, gen, scale=1.0 / math.sqrt(2 * cfg.num_layers))
        else:
            dense_init_(p, gen)
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
    lora = torch.tanh(base.float() @ p["lora_a"])
    lora = lora.reshape(*lora.shape[:-1], BRANCHES, LORA_DIM)
    dyn = torch.einsum("...kl,kld->...kd", lora, p["lora_b"])
    mixes = p["mu"] + dyn  # (..., 5, d)
    return [x + xx * mixes[..., i, :].to(x.dtype) for i in range(BRANCHES)]


def time_mix(p: dict, x, x_prev, cfg, chunk: int = 32, state=None):
    """x: (B, T, d), x_prev the shifted x: the WKV6 scan from a zero state
    through the kernel registry, returning the block's output (B, T, d).
    With ``state`` (B, H, N, N), x is one token (B, 1, d), x_prev the
    stored shift, and the result is (output, new state), by ``wkv6_step``."""
    d, N = cfg.d_model, cfg.ssm.head_dim
    B, T, H = x.shape[0], x.shape[1], d // N
    xr, xk, xv, xw, xg = _ddlerp(p, x, x_prev)
    r = (xr @ p["wr"].to(x.dtype)).reshape(B, T, H, N).float()
    k = (xk @ p["wk"].to(x.dtype)).reshape(B, T, H, N).float()
    v = (xv @ p["wv"].to(x.dtype)).reshape(B, T, H, N).float()
    g = F.silu(xg @ p["wg"].to(x.dtype))
    # as the reference (rwkv.py:185): the decay branch's adapter is the
    # first branch's lora_a columns with lora_b[3]
    wlog_raw = p["w0"] + (xw.float() @ p["lora_a"][:, :LORA_DIM]) @ p["lora_b"][3]
    wlog = torch.clamp(-torch.exp(wlog_raw), WLOG_MIN, WLOG_MAX).reshape(B, T, H, N)
    u = p["u"].reshape(H, N)
    if state is None:
        y = wkv6_apply(r, k, v, wlog, u, chunk=chunk)
    else:
        y, state = wkv6_step(r[:, 0], k[:, 0], v[:, 0], wlog[:, 0], u, state)
        y = y[:, None]
    # per-head group norm, then gate and project
    y = norm(p["ln_x"], y, "layernorm")
    y = y.reshape(B, T, d).to(x.dtype) * g
    out = y @ p["wo"].to(x.dtype)
    return out if state is None else (out, state)


def channel_mix(p: dict, x, x_prev, cfg):
    xx = x_prev - x
    xk = x + xx * p["cm_mu_k"].to(x.dtype)
    xr = x + xx * p["cm_mu_r"].to(x.dtype)
    kk = torch.square(F.relu(xk @ p["cm_wk"].to(x.dtype)))
    return torch.sigmoid(xr @ p["cm_wr"].to(x.dtype)) * (kk @ p["cm_wv"].to(x.dtype))


def _shift(x):
    """x_prev[t] = x[t-1] (zeros at t=0)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _layer_fwd(p: dict, x, cfg):
    h = norm(p["ln1"], x, cfg.norm)
    x = x + time_mix(p, h, _shift(h), cfg, chunk=cfg.ssm.chunk_size)
    h2 = norm(p["ln2"], x, cfg.norm)
    return x + channel_mix(p, h2, _shift(h2), cfg)


def _layer_step(p: dict, x, st_tm, st_cm, wkv, cfg):
    """One token through one layer.  x: (B, 1, d).  The shift states are
    stored float32 and cast to the stream's dtype here; the new ones are the
    normed inputs cast back to float32.  Returns (x, shift_tm, shift_cm,
    wkv)."""
    h = norm(p["ln1"], x, cfg.norm)
    y, wkv = time_mix(p, h, st_tm[:, None].to(h.dtype), cfg, state=wkv)
    x = x + y
    h2 = norm(p["ln2"], x, cfg.norm)
    x = x + channel_mix(p, h2, st_cm[:, None].to(h2.dtype), cfg)
    return x, h[:, 0].float(), h2[:, 0].float(), wkv


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------
def forward(model: RwkvLM, tokens: torch.Tensor, cfg, last_only: bool = False) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, vocab), or (B, 1, vocab) with
    ``last_only`` (the residual sliced to the last position before the
    final norm and the unembed)."""
    x = embed_tokens(model.embed.tok, tokens, dtype_of(cfg.compute_dtype))
    layer = maybe_remat(lambda p, xx: _layer_fwd(p, xx, cfg), cfg.parallelism.remat)
    for l in range(cfg.num_layers):
        x = layer(model.layers.layer(l), x)
    if last_only:
        x = x[:, -1:]
    x = norm(model.final_norm.layer(), x, cfg.norm)
    return unembed(model.embed.layer(), x, cfg.tie_embeddings)


def loss_fn(model: RwkvLM, batch: dict, cfg) -> torch.Tensor:
    return softmax_cross_entropy(forward(model, batch["tokens"], cfg), batch["targets"])


# ---------------------------------------------------------------------------
# decode: the O(1) recurrent state
# ---------------------------------------------------------------------------
def init_state(cfg, batch: int, device=None) -> RwkvState:
    """The zero state for ``batch`` sequences, float32."""
    d, L, N = cfg.d_model, cfg.num_layers, cfg.ssm.head_dim
    dev = resolve_device(device)
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)  # noqa: E731
    return RwkvState(zeros(L, batch, d), zeros(L, batch, d), zeros(L, batch, d // N, N, N))


def decode_step(model: RwkvLM, token: torch.Tensor, state: RwkvState, index, cfg) -> tuple:
    """One token per sequence: token (B, 1) -> (logits (B, vocab), state).
    ``index`` (the position) is not read: the state carries the history.
    The state is written in place."""
    x = embed_tokens(model.embed.tok, token, dtype_of(cfg.compute_dtype))
    for l in range(cfg.num_layers):
        x, tm, cm, wkv = _layer_step(model.layers.layer(l), x, state.shift_tm[l],
                                     state.shift_cm[l], state.wkv[l], cfg)
        state.shift_tm[l].copy_(tm)
        state.shift_cm[l].copy_(cm)
        state.wkv[l].copy_(wkv)
    x = norm(model.final_norm.layer(), x, cfg.norm)
    return unembed(model.embed.layer(), x, cfg.tie_embeddings)[:, 0, :], state
