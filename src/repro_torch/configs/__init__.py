"""Config registry: ``get_config("<arch>")`` + reduced smoke variants.

The port holds the reference's ten architectures: the dense
``qwen2-0.5b``, ``nemotron-4-340b``, ``chatglm3-6b`` and ``gemma-7b``, the
moe ``qwen2-moe-a2.7b`` and ``grok-1-314b``, the ssm ``rwkv6-7b``, the
hybrid ``zamba2-2.7b``, the encdec ``whisper-tiny`` and the vlm
``phi-3-vision-4.2b``, registered in the reference's order.
``smoke_config`` makes the same reduction the reference makes, so both
packages build identical small models.
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

from . import (chatglm3_6b, gemma_7b, grok_1_314b, nemotron_4_340b, phi_3_vision_4_2b,
               qwen2_0_5b, qwen2_moe_a2_7b, rwkv6_7b, whisper_tiny, zamba2_2_7b)

_REGISTRY: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (qwen2_moe_a2_7b, grok_1_314b, qwen2_0_5b, nemotron_4_340b, gemma_7b,
              chatglm3_6b, whisper_tiny, rwkv6_7b, zamba2_2_7b, phi_3_vision_4_2b)}

ARCH_NAMES = tuple(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown arch {name!r}; available: {ARCH_NAMES}") from None


def smoke_config(name: str) -> ModelConfig:
    """A reduced same-family config for CPU tests: two layers, width 64,
    vocabulary 512, float32 — the reference's reduction (moe: four experts,
    top-2, width 32, at most one shared expert, capacity 4.0 so nothing
    drops; ssm: head_dim 16, state 8, chunk 8; hybrid: four layers, the
    shared block every two; encdec: two encoder layers over 16 frames;
    vlm: 8 patches of width 32)."""
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
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, padded_experts=4, top_k=2, expert_d_ff=32,
            num_shared_experts=min(cfg.moe.num_shared_experts, 1),
            capacity_factor=4.0)
        changes["d_ff"] = 32
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(
            cfg.ssm, head_dim=16, state_size=8, chunk_size=8)
    if cfg.hybrid is not None:
        changes["num_layers"] = 4
        changes["hybrid"] = dataclasses.replace(cfg.hybrid, shared_attn_every=2)
    if cfg.encdec is not None:
        changes["encdec"] = dataclasses.replace(cfg.encdec, encoder_layers=2,
                                                encoder_frames=16)
    if cfg.vlm is not None:
        changes["vlm"] = dataclasses.replace(cfg.vlm, num_patches=8, patch_embed_dim=32)
    return dataclasses.replace(cfg, **changes)
