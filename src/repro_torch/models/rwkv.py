"""RWKV6 "Finch" (the ssm family): an attention-free LM with a
data-dependent per-channel decay, full-sequence forward.

Time-mix: a data-dependent token shift (ddlerp with a low-rank adapter),
then the WKV6 recurrence

    y_t[j] = sum_i r_t[i] * (S[i,j] + u[i] k_t[i] v_t[j])
    S[i,j] <- w_t[i] * S[i,j] + k_t[i] * v_t[j]

from a zero state, whose final state the full-sequence forward drops.  The
reference runs it in lax (``wkv6_chunked``); the port runs the WKV6 kernel
through ``kernels/rwkv6_scan/ops.wkv6_apply``: the CUDA kernel on a CUDA
tensor, the plain chunked version on the CPU.  Channel-mix: a relu² FFN
with token-shift gates.  ``wkv6_chunked`` (a state in and out) and
``wkv6_step`` are the reference's, for the tests; decode with the
recurrent state arrives with serving.

Parameters keep the reference's tree (``layers.{ln1, ln2, mu_base, mu,
lora_a, lora_b, wr, wk, wv, wg, wo, w0, u, ln_x, cm_mu_k, cm_mu_r, cm_wk,
cm_wv, cm_wr}`` stacked on ``L``; ``ln_x`` a per-head layernorm), so
``model.from_jax_params`` is a name map.  The layers run in a Python loop.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.rwkv6_scan.ops import wkv6_apply
from ..kernels.rwkv6_scan.ref import wkv6_chunked  # noqa: F401  (the reference's name)
from .common import (
    ParamBlock,
    dense_init_,
    dtype_of,
    embed_init_,
    embed_shapes,
    embed_tokens,
    norm,
    norm_shapes,
    normal_init_,
    softmax_cross_entropy,
    unembed,
)

LORA_DIM = 32
BRANCHES = 5                      # r, k, v, w, g
WLOG_MIN, WLOG_MAX = -5.0, -1e-4  # per-step log-decay clamp (fp32-stable chunks)


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
# the recurrence's single step (the reference's, for the tests)
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


def time_mix(p: dict, x, x_prev, cfg, chunk: int = 32):
    """x: (B, T, d), x_prev the shifted x.  The WKV6 scan from a zero state
    through the kernel registry; returns the block's output (B, T, d)."""
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
    y = wkv6_apply(r, k, v, wlog, p["u"].reshape(H, N), chunk=chunk)
    # per-head group norm, then gate and project
    y = norm(p["ln_x"], y, "layernorm")
    y = y.reshape(B, T, d).to(x.dtype) * g
    return y @ p["wo"].to(x.dtype)


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


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------
def forward(model: RwkvLM, tokens: torch.Tensor, cfg, last_only: bool = False) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, vocab), or (B, 1, vocab) with
    ``last_only`` (the residual sliced to the last position before the
    final norm and the unembed)."""
    x = embed_tokens(model.embed.tok, tokens, dtype_of(cfg.compute_dtype))
    for l in range(cfg.num_layers):
        x = _layer_fwd(model.layers.layer(l), x, cfg)
    if last_only:
        x = x[:, -1:]
    x = norm(model.final_norm.layer(), x, cfg.norm)
    return unembed(model.embed.layer(), x, cfg.tie_embeddings)


def loss_fn(model: RwkvLM, batch: dict, cfg) -> torch.Tensor:
    return softmax_cross_entropy(forward(model, batch["tokens"], cfg), batch["targets"])
