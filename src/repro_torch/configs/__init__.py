"""Config registry: ``get_config("<arch>")`` + reduced smoke variants.

This slice ports one architecture, the dense ``qwen2-0.5b``; the other nine
of the reference arrive with their model families.  ``smoke_config`` makes
the same reduction the reference makes, so both packages build identical
small models.
"""
from __future__ import annotations

import dataclasses

from .base import (  # noqa: F401
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES_BY_NAME,
    TRAIN_4K,
    ModelConfig,
    ParallelismConfig,
    ShapeConfig,
    shapes_for,
)

from . import qwen2_0_5b

_REGISTRY: dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in (qwen2_0_5b,)}

ARCH_NAMES = tuple(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown arch {name!r}; available: {ARCH_NAMES}") from None


def smoke_config(name: str) -> ModelConfig:
    """A reduced same-family config for CPU tests: two layers, width 64,
    vocabulary 512, float32 — the reference's reduction."""
    cfg = get_config(name)
    changes: dict = dict(
        num_layers=2,
        d_model=64,
        d_ff=128,
        vocab_size=512,
        max_seq_len=128,
        param_dtype="float32",
        compute_dtype="float32",
        parallelism=ParallelismConfig(microbatch=0, remat="none",
                                      scan_layers=True, grad_sync="abi"),
    )
    if cfg.num_heads:
        changes.update(num_heads=4, num_kv_heads=2 if cfg.num_kv_heads < cfg.num_heads else 4,
                       head_dim=16)
    return dataclasses.replace(cfg, **changes)
