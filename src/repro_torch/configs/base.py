"""Model / parallelism / run configuration dataclasses.

The reference's (``repro.configs.base``) field for field, so a config means
the same model in both packages.  ``remat`` and ``scan_layers`` change no
numbers in either package and are accepted as-is here (the port runs the
layers in a Python loop and keeps activations for backward).  The
reference's XLA-flag wiring configures XLA itself and has no counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0          # routed experts
    num_shared_experts: int = 0   # always-active shared experts
    top_k: int = 2
    expert_d_ff: int = 0          # per-expert hidden width
    parallelism: str = "ep"       # "ep": experts over model axis via ABI alltoall
    #                               "tp": expert d_ff sharded over model axis
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    padded_experts: int = 0       # experts padded up for EP divisibility (0 = none)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba2"          # "mamba2" | "rwkv6"
    state_size: int = 64          # N (mamba) — rwkv6 state is head_dim x head_dim
    head_dim: int = 64
    expand: int = 2               # mamba d_inner = expand * d_model
    conv_kernel: int = 4
    chunk_size: int = 64          # chunked-scan block length
    dt_rank: int = 0              # 0 = auto


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    shared_attn_every: int = 6    # apply the shared attention block every k layers
    concat_embedding: bool = True # Zamba-style concat(h, emb0) input to shared block


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    encoder_layers: int = 4
    encoder_frames: int = 1500    # whisper 30s @ 50Hz after conv stub
    frontend: str = "stub"        # precomputed frame embeddings via input_specs()


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    num_patches: int = 576
    patch_embed_dim: int = 1024   # CLIP-L/14 hidden
    frontend: str = "stub"        # precomputed patch embeddings via input_specs()


@dataclasses.dataclass(frozen=True)
class ParallelismConfig:
    """How this arch maps onto the production mesh (runtime/sharding.py)."""

    fsdp_axes: tuple[str, ...] = ("pod", "data")  # param/optimizer sharding
    tp_axis: str = "model"
    tp_size: int = 16                 # production model-axis width; param dims
    #                                   that don't divide it evenly (e.g. GQA
    #                                   kv-heads < 16) are replicated instead
    #                                   of unevenly sharded (Megatron practice)
    sequence_parallel: bool = False   # shard long-seq activations over tp axis
    microbatch: int = 0               # 0 = no grad accumulation
    remat: str = "full"               # "none" | "full" | "dots"
    scan_layers: bool = True
    grad_sync: str = "abi"            # "abi" explicit | "gspmd" implicit
    grad_compression: Optional[str] = None  # None | "bf16" | "int8"
    zero1: bool = True                # shard optimizer state over fsdp axes
    #                                   (abi mode: explicit ZeRO-1 round trip
    #                                   through the pooled nonblocking path
    #                                   when init_state is given the dist)
    zero1_buckets: int = 1            # nonblocking buckets per zero1 round
    #                                   trip (must divide the padded shard)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    num_heads: int = 0            # 0 for attention-free archs
    num_kv_heads: int = 0
    head_dim: int = 0             # 0 = d_model // num_heads
    activation: str = "swiglu"    # swiglu | geglu | gelu | relu2 | silu
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0    # chatglm "2d" rope: rotate only this fraction
    max_seq_len: int = 32768
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    attention_impl: str = "xla"   # "xla" (the plain attention path; "flash" waits for its kernel)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    parallelism: ParallelismConfig = dataclasses.field(default_factory=ParallelismConfig)
    # which assigned shapes are architecturally meaningful (DESIGN.md §Arch)
    supports_long_context: bool = False  # sub-quadratic -> long_500k runs

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 0

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks), for roofline
        MODEL_FLOPS = 6*N*D."""
        from repro_torch.models.model import analytic_param_count

        return analytic_param_count(self)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def shapes_for(config: ModelConfig) -> tuple[ShapeConfig, ...]:
    """The assigned shapes that are architecturally meaningful for this arch
    (long_500k only for sub-quadratic archs — DESIGN.md §Arch-applicability)."""
    if config.supports_long_context:
        return ALL_SHAPES
    return (TRAIN_4K, PREFILL_32K, DECODE_32K)
