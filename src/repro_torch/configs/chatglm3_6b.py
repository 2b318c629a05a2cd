"""ChatGLM3-6B  [arXiv:2406.12793] — 2d RoPE (half dims), GQA kv=2, QKV bias."""
from .base import ModelConfig, ParallelismConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    d_ff=13696,
    vocab_size=65024,
    num_heads=32,
    num_kv_heads=2,
    activation="swiglu",
    qkv_bias=True,
    rope_fraction=0.5,        # rotary on half the head dims ("RoPE 2d")
    parallelism=ParallelismConfig(microbatch=4, remat="full"),
)
