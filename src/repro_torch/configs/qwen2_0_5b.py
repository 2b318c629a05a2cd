"""Qwen2-0.5B  [arXiv:2407.10671] — GQA (kv=2), QKV bias, tied embeddings."""
from .base import ModelConfig, ParallelismConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    d_ff=4864,
    vocab_size=151936,
    num_heads=14,
    num_kv_heads=2,
    activation="swiglu",
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    parallelism=ParallelismConfig(microbatch=4, remat="full"),
)
