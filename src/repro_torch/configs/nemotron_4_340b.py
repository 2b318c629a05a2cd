"""Nemotron-4-340B  [arXiv:2402.16819] — GQA (kv=8), squared-ReLU, LN."""
from .base import ModelConfig, ParallelismConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    d_ff=73728,
    vocab_size=256000,
    num_heads=96,
    num_kv_heads=8,
    activation="relu2",
    norm="layernorm",
    parallelism=ParallelismConfig(
        microbatch=16, remat="full", sequence_parallel=True,
        grad_sync="gspmd")  # FSDP/ZeRO via GSPMD for the 300B-class,
)
