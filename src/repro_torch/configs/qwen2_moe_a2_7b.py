"""Qwen1.5-MoE-A2.7B  [hf:Qwen/Qwen1.5-MoE-A2.7B]  — 4 shared + 60 routed top-4.

EP divisibility: 60 routed experts are padded to 64 for the 16-way model
axis (DESIGN.md §Arch-applicability); padding experts get no router mass.
"""
from .base import ModelConfig, MoEConfig, ParallelismConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    d_ff=1408,                 # routed expert width
    vocab_size=151936,
    num_heads=16,
    num_kv_heads=16,
    activation="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(
        num_experts=60,
        padded_experts=64,
        num_shared_experts=4,
        top_k=4,
        expert_d_ff=1408,
        parallelism="ep",
        capacity_factor=1.25,
    ),
    parallelism=ParallelismConfig(microbatch=4, remat="full"),
)
