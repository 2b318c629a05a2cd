"""Zamba2-2.7B  [arXiv:2411.15242] — Mamba2 backbone + shared attention
block (every 6 layers, concat(h, emb0) input); runs long_500k."""
from .base import HybridConfig, ModelConfig, ParallelismConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    d_ff=10240,                # shared block MLP width
    vocab_size=32000,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    activation="geglu",
    ssm=SSMConfig(kind="mamba2", state_size=64, head_dim=64, expand=2,
                  conv_kernel=4, chunk_size=64),
    hybrid=HybridConfig(shared_attn_every=6, concat_embedding=True),
    supports_long_context=True,
    parallelism=ParallelismConfig(microbatch=4, remat="full"),
)
