"""RWKV6-7B "Finch"  [arXiv:2404.05892] — attention-free, data-dependent
decay; O(1) state => runs the long_500k cell."""
from .base import ModelConfig, ParallelismConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=65536,
    ssm=SSMConfig(kind="rwkv6", head_dim=64, chunk_size=32),
    supports_long_context=True,
    parallelism=ParallelismConfig(microbatch=4, remat="full"),
)
