"""Whisper-tiny  [arXiv:2212.04356] — enc-dec, conv frontend STUB.

decode_32k is an architectural stretch (the real decoder caps at 448
positions); the learned position table is extended to the assigned shape.
"""
from .base import EncDecConfig, ModelConfig, ParallelismConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    num_layers=4,              # decoder layers
    d_model=384,
    d_ff=1536,
    vocab_size=51865,
    num_heads=6,
    num_kv_heads=6,
    activation="gelu",
    norm="layernorm",
    tie_embeddings=True,
    encdec=EncDecConfig(encoder_layers=4, encoder_frames=1500),
    parallelism=ParallelismConfig(microbatch=4, remat="full"),
)
