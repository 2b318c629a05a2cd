"""AdamW in two layouts, the reference's (``repro.optim.adamw``) math:

* **tree**: per-leaf moments (the per-leaf data-parallel step);
* **flat/ZeRO-1**: moments live only for this data-parallel rank's shard
  of the flattened gradient vector — reduce-scattered through the ABI,
  updated on the shard, all-gathered back.

The flat vector is f32: :func:`flatten` casts every leaf up and
:func:`unflatten_like` casts back to the leaf dtype, so there is no f32
master copy and bf16 parameters are re-rounded every step, exactly as in
the reference.  The gradient is clipped by the global norm inside the
update.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


class AdamState(NamedTuple):
    step: torch.Tensor
    m: list
    v: list


def init_tree(params: Sequence[torch.Tensor]) -> AdamState:
    zeros = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]
    return AdamState(torch.zeros((), dtype=torch.int32, device=params[0].device),
                     zeros, [z.clone() for z in zeros])


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tensors))


def update_tree(cfg: AdamWConfig, grads, state: AdamState, params, lr_scale=1.0):
    """-> (new parameter values, new state, grad norm)."""
    step = state.step + 1
    t = step.float()
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)
    new_p, new_m, new_v = [], [], []
    for g, m, v, p in zip(grads, state.m, state.v, params):
        g = g.float() * scale
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        mhat = m2 / (1 - cfg.b1 ** t)
        vhat = v2 / (1 - cfg.b2 ** t)
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        new_p.append((p.float() - cfg.lr * lr_scale * delta).to(p.dtype))
        new_m.append(m2)
        new_v.append(v2)
    return new_p, AdamState(step, new_m, new_v), gnorm


# ---------------------------------------------------------------------------
# flat / ZeRO-1
# ---------------------------------------------------------------------------
class FlatAdamState(NamedTuple):
    step: torch.Tensor
    m: torch.Tensor   # (padded / dp,) f32 — this rank's shard
    v: torch.Tensor
    #: error-feedback residual of a compressed wire; a (1,) dummy until the
    #: compressed wire is ported
    ef: torch.Tensor


def flatten(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1).float() for t in tensors])


def unflatten_like(vec: torch.Tensor, tensors: Sequence[torch.Tensor]) -> list:
    out, off = [], 0
    for t in tensors:
        n = t.numel()
        out.append(vec[off:off + n].reshape(t.shape).to(t.dtype))
        off += n
    return out


def zero1_padded_size(n: int, dp_size: int, buckets: int = 1) -> int:
    """Flat-vector length padded so ``dp_size * buckets`` divides it."""
    m = dp_size * max(buckets, 1)
    return -(-n // m) * m


def init_flat_global(params: Sequence[torch.Tensor], dp_size: int, *,
                     buckets: int = 1) -> FlatAdamState:
    """This rank's part of the global flat state: the reference builds
    (padded,) moment vectors sharded over the data-parallel axes; one
    process is one rank here, so it holds its (padded / dp,) shard only."""
    n = sum(p.numel() for p in params)
    padded = zero1_padded_size(n, dp_size, buckets)
    dev = params[0].device
    shard = padded // dp_size
    return FlatAdamState(
        torch.zeros((), dtype=torch.int32, device=dev),
        torch.zeros((shard,), dtype=torch.float32, device=dev),
        torch.zeros((shard,), dtype=torch.float32, device=dev),
        torch.zeros((1,), dtype=torch.float32, device=dev),
    )


def update_flat_shard(cfg: AdamWConfig, g_shard: torch.Tensor, state: FlatAdamState,
                      p_shard: torch.Tensor, gnorm: torch.Tensor, lr_scale=1.0):
    """AdamW on this rank's flat shard.  g_shard/p_shard: (shard,) f32."""
    step = state.step + 1
    t = step.float()
    scale = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)
    g = g_shard * scale
    m2 = cfg.b1 * state.m + (1 - cfg.b1) * g
    v2 = cfg.b2 * state.v + (1 - cfg.b2) * torch.square(g)
    mhat = m2 / (1 - cfg.b1 ** t)
    vhat = v2 / (1 - cfg.b2 ** t)
    delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p_shard
    new_p_shard = p_shard - cfg.lr * lr_scale * delta
    return new_p_shard, FlatAdamState(step, m2, v2, state.ef)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------
def warmup_cosine(step, *, warmup: int, total: int, floor: float = 0.1) -> torch.Tensor:
    t = torch.as_tensor(step).float()
    wu = torch.clamp_max(t / max(warmup, 1), 1.0)
    prog = torch.clamp((t - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return wu * cos
