"""Model factory and the weight bridge from the reference package.

``build_model(cfg)`` returns a :class:`ModelApi` with ``init(seed, device)``
(-> the parameter module), ``loss_fn(model, batch)`` and
``forward(model, batch, last_only=False)`` (-> logits).  The port holds
the dense family.

:func:`param_leaves` is the reference's ``jax.tree.leaves`` order — sorted
keys at every level of the parameter tree, each leaf holding all ``L``
layers — which the ZeRO-1 flat vector follows, so moment vectors and the
data-parallel shard boundaries compare element for element.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch import nn

from ..configs.base import ModelConfig
from ..runtime.device import resolve_device
from . import transformer
from .common import is_glu


@dataclasses.dataclass
class ModelApi:
    cfg: ModelConfig
    init: Callable
    loss_fn: Callable
    forward: Callable


def build_model(cfg: ModelConfig) -> ModelApi:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (this slice: dense)")
    return ModelApi(
        cfg,
        init=lambda seed=0, device=None: transformer.init_lm(
            cfg, seed, resolve_device(device)),
        loss_fn=lambda m, b, dist=None: transformer.loss_fn(m, b, cfg),
        forward=lambda m, b, dist=None, last_only=False: transformer.forward(
            m, b["tokens"], cfg, last_only=last_only),
    )


def param_leaves(model: nn.Module) -> list[tuple[str, nn.Parameter]]:
    """(path, parameter) in the reference's tree-leaves order."""
    return sorted(model.named_parameters(), key=lambda kv: kv[0].split("."))


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16 from the reference
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@torch.no_grad()
def from_jax_params(np_tree: dict, cfg: ModelConfig, device=None) -> nn.Module:
    """The reference's parameter pytree (nested dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, api.init(key))``) as the port's parameters.
    Layouts agree, so this is a name map; shapes and dtypes are checked."""
    model = transformer.TransformerLM(cfg, resolve_device(device))
    for name, p in model.named_parameters():
        node = np_tree
        for part in name.split("."):
            node = node[part]
        t = _to_tensor(node)
        if tuple(t.shape) != tuple(p.shape) or t.dtype != p.dtype:
            raise ValueError(f"{name}: reference leaf {tuple(t.shape)} {t.dtype} "
                             f"does not fit {tuple(p.shape)} {p.dtype}")
        p.copy_(t)
    return model


# ---------------------------------------------------------------------------
# analytic parameter counts (the reference's formula)
# ---------------------------------------------------------------------------
def _mlp_params(d: int, f: int, activation: str) -> int:
    return d * f * (3 if is_glu(activation) else 2)


def analytic_param_count(cfg: ModelConfig) -> int:
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    d, f, V, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.num_layers
    hd = cfg.resolved_head_dim
    n = V * d * (1 if cfg.tie_embeddings else 2)
    attn = d * hd * cfg.num_heads * 2 + d * hd * cfg.num_kv_heads * 2
    return n + L * (attn + _mlp_params(d, f, cfg.activation))

