"""AdamW in two layouts, the reference's (``repro.optim.adamw``) math:

* **tree**: per-leaf moments (the per-leaf data-parallel step), held in
  the parameters' nested structure as the reference holds them, so a
  checkpoint names each moment by its parameter (``.opt.m['embed']['tok']``);
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
    m: dict   # nested like the parameter tree: name parts -> f32 moment
    v: dict


def nest(named: Sequence[tuple[str, torch.Tensor]]) -> dict:
    """``[("a.b", t), ...]`` as the nested dict ``{"a": {"b": t}}``."""
    tree: dict = {}
    for name, t in named:
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t
    return tree


def tree_leaves(tree: dict) -> list:
    """A nested dict's leaves with keys sorted at every level: the
    reference's ``jax.tree.leaves`` order, which is ``param_leaves``'."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += tree_leaves(v) if isinstance(v, dict) else [v]
    return out


def _tree_like(tree: dict, leaves) -> dict:
    """``tree``'s structure over ``leaves`` (an iterator, in that order)."""
    return {k: _tree_like(tree[k], leaves) if isinstance(tree[k], dict) else next(leaves)
            for k in sorted(tree)}


def init_tree(named: Sequence[tuple[str, torch.Tensor]]) -> AdamState:
    """Zero moments for the ``(name, parameter)`` leaves, nested by name."""
    zeros = [(n, torch.zeros(p.shape, dtype=torch.float32, device=p.device))
             for n, p in named]
    return AdamState(torch.zeros((), dtype=torch.int32, device=named[0][1].device),
                     nest(zeros), nest([(n, z.clone()) for n, z in zeros]))


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tensors))


#: a leaf of more elements is updated in runs of its leading axis of at most
#: this many (:func:`update_tree`), so AdamW's temporaries are a run's, not
#: the leaf's: a tensor-parallel rank of gemma-7b holds 0.5 G elements in one
#: stacked FFN leaf
SLICE_ELEMENTS = 1 << 26


def update_tree(cfg: AdamWConfig, grads, state: AdamState, params, gnorm: torch.Tensor,
                lr_scale=1.0):
    """``grads`` and ``params`` in ``param_leaves`` order -> (new parameter
    values in that order, new state).  ``gnorm``: the global norm to clip
    by (``global_norm(grads)`` when ``grads`` are the whole set; a larger
    set's when they are one rank's part of it)."""
    step = state.step + 1
    t = step.float()
    scale = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)

    def one(g, m, v, p):
        g = g.float() * scale
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        mhat = m2 / (1 - cfg.b1 ** t)
        vhat = v2 / (1 - cfg.b2 ** t)
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        return (p.float() - cfg.lr * lr_scale * delta).to(p.dtype), m2, v2

    new_p, new_m, new_v = [], [], []
    for g, m, v, p in zip(grads, tree_leaves(state.m), tree_leaves(state.v), params):
        if p.numel() <= SLICE_ELEMENTS or p.ndim < 2:
            out = one(g, m, v, p)
        else:
            # a large leaf in runs of its leading axis of at most
            # SLICE_ELEMENTS: the same arithmetic per element, a run's
            # temporaries at a time
            rows = max(1, SLICE_ELEMENTS // p[0].numel())
            out = (torch.empty_like(p), torch.empty_like(m), torch.empty_like(v))
            for a in range(0, p.shape[0], rows):
                run = slice(a, a + rows)
                for dst, src in zip(out, one(g[run], m[run], v[run], p[run])):
                    dst[run] = src
        for acc, x in zip((new_p, new_m, new_v), out):
            acc.append(x)
    return new_p, AdamState(step, _tree_like(state.m, iter(new_m)),
                            _tree_like(state.v, iter(new_v)))


# ---------------------------------------------------------------------------
# flat / ZeRO-1
# ---------------------------------------------------------------------------
class FlatAdamState(NamedTuple):
    step: torch.Tensor
    m: torch.Tensor   # (padded / dp,) f32 — this rank's shard
    v: torch.Tensor
    #: error-feedback residual of the bf16 wire: this rank's full-length
    #: (padded,) f32 residual with ``with_ef``, else a (1,) dummy
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


def zero1_padded_size(n: int, dp_size: int, buckets: int = 1, granule: int = 1) -> int:
    """Flat-vector length padded so ``dp_size * buckets * granule`` divides
    it.  ``granule`` > 1 makes every per-rank bucket slice a whole number of
    granules (the int8 ring's wire blocks, ``grad_sync.zero1_granule``)."""
    m = dp_size * max(buckets, 1) * max(granule, 1)
    return -(-n // m) * m


def init_flat_global(params: Sequence[torch.Tensor], dp_size: int, *,
                     buckets: int = 1, with_ef: bool = False,
                     granule: int = 1) -> FlatAdamState:
    """This rank's part of the global flat state: the reference builds
    (padded,) moment vectors sharded over the data-parallel axes; one
    process is one rank here, so it holds its (padded / dp,) shard only.
    With ``with_ef`` the error-feedback residual is this rank's
    full-length (padded,) f32 vector (the reference's (dp * padded,)
    buffer sharded over dp).  ``granule``: see :func:`zero1_padded_size`."""
    n = sum(p.numel() for p in params)
    padded = zero1_padded_size(n, dp_size, buckets, granule)
    dev = params[0].device
    shard = padded // dp_size
    return FlatAdamState(
        torch.zeros((), dtype=torch.int32, device=dev),
        torch.zeros((shard,), dtype=torch.float32, device=dev),
        torch.zeros((shard,), dtype=torch.float32, device=dev),
        torch.zeros((padded if with_ef else 1,), dtype=torch.float32, device=dev),
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
