"""Phi-3-vision-4.2B  [hf:microsoft/Phi-3-vision-128k-instruct] —
phi3-mini backbone + CLIP frontend STUB (precomputed patch embeddings)."""
from .base import ModelConfig, ParallelismConfig, VLMConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    d_ff=8192,
    vocab_size=32064,
    num_heads=32,
    num_kv_heads=32,
    activation="swiglu",
    vlm=VLMConfig(num_patches=576, patch_embed_dim=1024),
    parallelism=ParallelismConfig(microbatch=4, remat="full"),
)
