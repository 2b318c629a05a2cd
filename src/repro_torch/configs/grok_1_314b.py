"""Grok-1 314B  [hf:xai-org/grok-1; unverified] — 8 experts top-2.

8 experts don't divide the 16-way model axis, so experts use TP-MoE
(d_ff sharded over model; DESIGN.md §Arch-applicability).
"""
from .base import ModelConfig, MoEConfig, ParallelismConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    d_ff=32768,
    vocab_size=131072,
    num_heads=48,
    num_kv_heads=8,
    activation="geglu",
    moe=MoEConfig(
        num_experts=8,
        top_k=2,
        expert_d_ff=32768,
        parallelism="tp",
        capacity_factor=1.25,
    ),
    parallelism=ParallelismConfig(
        microbatch=16, remat="full", sequence_parallel=True,
        grad_sync="gspmd")  # FSDP/ZeRO via GSPMD for the 300B-class,
)
