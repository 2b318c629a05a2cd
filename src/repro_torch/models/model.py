"""Model factory and the weight bridge from the reference package.

``build_model(cfg)`` returns a :class:`ModelApi` with ``init(seed, device,
model_rank=0, model_axis=1, fsdp_rank=0, fsdp_size=1)`` (-> the parameter
module; every family holds its block of every leaf the model axis and the
fsdp axes split, ``tensor_parallel.held_layout``),
``param_specs(fsdp, tp)`` (-> the reference's parameter specs, a nested
dict with the parameters' keys, see ``runtime/sharding.py``),
``loss_fn(model, batch)``,
``forward(model, batch, last_only=False)`` (-> logits),
``decode_init(batch, max_seq, device=None, model_axis=1)`` (-> the decode
state: the dense, moe and vlm families' contiguous KV cache, the ssm
family's recurrent ``RwkvState``, the hybrid's ``HybridState``, a rank's
heads and channels where they split; None for encdec, whose cache needs
the frames: ``encdec.init_cache``), ``decode_step(model, token, state,
index)`` (-> logits, state; the state is written in place) and
``cache_specs()`` (the reference's specs of the decode state).
``loss_fn``, ``forward`` and ``decode_step`` take the ``dist`` the model
axis runs on (tensor parallelism and the moe family's expert
parallelism).  The port holds six families of the reference: ``dense``
and ``moe`` (``transformer``), ``ssm`` (rwkv6, ``rwkv``), ``hybrid``
(Mamba2 + shared attention, ``hybrid``), ``encdec`` (whisper, ``encdec``)
and ``vlm`` (phi-3-vision, ``vlm``); each trains, decodes and splits over
the model axis and the fsdp axes (``tensor_parallel.held_layout``).  The
forward and the loss of encdec and vlm read the whole batch (``frames``,
``patches``), the others its ``tokens``; :func:`make_batch` draws a batch
of the reference's shapes.

:func:`param_leaves` is the reference's ``jax.tree.leaves`` order — sorted
keys at every level of the parameter tree, each leaf holding all ``L``
layers — which the ZeRO-1 flat vector follows, so moment vectors and the
data-parallel shard boundaries compare element for element.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from ..configs.base import ModelConfig
from ..runtime.device import resolve_device
from . import encdec, hybrid, rwkv, transformer, vlm
from .common import is_glu
from .tensor_parallel import FSDP, TP, take_block

#: family -> (its module, its parameter module)
_FAMILIES = {"dense": (transformer, transformer.TransformerLM),
             "moe": (transformer, transformer.TransformerLM),
             "ssm": (rwkv, rwkv.RwkvLM),
             "hybrid": (hybrid, hybrid.HybridLM),
             "encdec": (encdec, encdec.EncDecLM),
             "vlm": (vlm, vlm.VlmLM)}


def _family(cfg: ModelConfig):
    try:
        return _FAMILIES[cfg.family]
    except KeyError:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet (the port "
                                  f"holds {', '.join(_FAMILIES)})") from None


@dataclasses.dataclass
class ModelApi:
    cfg: ModelConfig
    init: Callable
    param_specs: Callable
    loss_fn: Callable
    forward: Callable
    decode_init: Optional[Callable] = None
    decode_step: Optional[Callable] = None
    cache_specs: Optional[Callable] = None


def build_model(cfg: ModelConfig) -> ModelApi:
    fam, _ = _family(cfg)
    # encdec and vlm read the whole batch (frames, patches), the others its tokens
    inputs = (lambda b: b) if fam in (encdec, vlm) else (lambda b: b["tokens"])
    api = ModelApi(
        cfg,
        init=lambda seed=0, device=None, model_rank=0, model_axis=1, fsdp_rank=0, fsdp_size=1:
        fam.init_lm(cfg, seed, resolve_device(device), model_rank, model_axis, fsdp_rank,
                    fsdp_size),
        param_specs=lambda fsdp="data", tp="model": fam.spec_lm(cfg, fsdp, tp),
        loss_fn=lambda m, b, dist=None: fam.loss_fn(m, b, cfg, dist=dist),
        forward=lambda m, b, dist=None, last_only=False: fam.forward(
            m, inputs(b), cfg, last_only=last_only, dist=dist),
        decode_step=lambda m, tok, state, idx, dist=None: fam.decode_step(
            m, tok, state, idx, cfg, dist=dist),
    )
    if fam in (transformer, vlm):
        api.decode_init = lambda batch, max_seq, device=None, model_axis=1: (
            transformer.init_cache(cfg, batch, max_seq, device=device, model_axis=model_axis))
        api.cache_specs = lambda: transformer.cache_specs(cfg)
    elif fam is rwkv:
        api.decode_init = lambda batch, max_seq, device=None, model_axis=1: rwkv.init_state(
            cfg, batch, device=device, model_axis=model_axis)
        api.cache_specs = lambda: rwkv.state_specs(cfg)
    elif fam is hybrid:
        api.decode_init = lambda batch, max_seq, device=None, model_axis=1: hybrid.init_state(
            cfg, batch, max_seq, device=device, model_axis=model_axis)
        api.cache_specs = lambda: hybrid.state_specs(cfg)
    else:  # encdec: its cache needs the frames (encdec.init_cache)
        api.cache_specs = lambda: encdec.cache_specs(cfg)
    return api


def param_leaves(model: nn.Module) -> list[tuple[str, nn.Parameter]]:
    """(path, parameter) in the reference's tree-leaves order."""
    return sorted(model.named_parameters(), key=lambda kv: kv[0].split("."))


def leaf_splits(model: nn.Module) -> tuple:
    """Per leaf, in ``param_leaves`` order: (is it split over the model
    axis, is it split over the fsdp axes) — from what ``model`` holds (its
    ``held`` specs, ``tensor_parallel.held_layout``)."""
    held = getattr(model, "held", {})
    tp, fs = [], []
    for name, _ in param_leaves(model):
        spec = held.get(name, ())
        tp.append(TP in spec)
        fs.append(FSDP in spec)
    return tp, fs


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16 from the reference
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@torch.no_grad()
def from_jax_params(np_tree: dict, cfg: ModelConfig, device=None, model_rank: int = 0,
                    model_axis: int = 1, fsdp_rank: int = 0, fsdp_size: int = 1) -> nn.Module:
    """The reference's parameter pytree (nested dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, api.init(key))``) as the port's parameters.
    Layouts agree, so this is a name map; shapes and dtypes are checked.
    The model keeps its block (``model_rank``, ``fsdp_rank``) of every leaf
    the model axis and the fsdp axes split (``tensor_parallel.take_block``)."""
    model = _family(cfg)[1](cfg, resolve_device(device), model_rank, model_axis, fsdp_rank,
                            fsdp_size)
    for name, p in model.named_parameters():
        node = np_tree
        for part in name.split("."):
            node = node[part]
        t = take_block(model, name, _to_tensor(node))
        if tuple(t.shape) != tuple(p.shape) or t.dtype != p.dtype:
            raise ValueError(f"{name}: reference leaf {tuple(t.shape)} {t.dtype} "
                             f"does not fit {tuple(p.shape)} {p.dtype}")
        p.copy_(t)
    return model


# ---------------------------------------------------------------------------
# analytic parameter counts (the reference's formula)
# ---------------------------------------------------------------------------
def _mlp_params(d: int, f: int, activation: str) -> int:
    return d * f * (3 if is_glu(activation) else 2)


def analytic_param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """The reference's count; the moe family's real experts, not its
    padding ones, and with ``active_only`` the ``top_k`` a token runs
    through (the roofline's MODEL_FLOPS term)."""
    _family(cfg)  # raises for a family the port does not hold
    d, f, V, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.num_layers
    hd = cfg.resolved_head_dim
    n = V * d * (1 if cfg.tie_embeddings else 2)
    attn = d * hd * cfg.num_heads * 2 + d * hd * cfg.num_kv_heads * 2
    if cfg.family == "ssm":  # rwkv6
        per_layer = 5 * d * d + d * 32 * 5 * 2  # time-mix mats + lora
        per_layer += d * f * 2 + d * d  # channel mix
        return n + L * per_layer
    if cfg.family == "hybrid":
        s = cfg.ssm
        d_inner = s.expand * d
        H = d_inner // s.head_dim
        per_layer = d * (2 * d_inner + 2 * s.state_size + H) + d_inner * d  # in/out proj
        shared = (2 * d) * d + attn + _mlp_params(d, f, cfg.activation) + d * d
        return n + L * per_layer + shared
    if cfg.family == "encdec":
        mlp_n = _mlp_params(d, f, cfg.activation)
        enc = cfg.encdec.encoder_layers * (attn + mlp_n)
        return n + enc + L * (2 * attn + mlp_n) + cfg.max_seq_len * d
    if cfg.family == "vlm":
        n += cfg.vlm.patch_embed_dim * d + d * d  # the projector
    if cfg.moe is not None:
        m = cfg.moe
        experts = m.top_k if active_only else m.num_experts
        ffn = experts * _mlp_params(d, m.expert_d_ff, cfg.activation) + d * m.num_experts
        if m.num_shared_experts:
            ffn += _mlp_params(d, m.num_shared_experts * m.expert_d_ff, cfg.activation) + d
        return n + L * (attn + ffn)
    return n + L * (attn + _mlp_params(d, f, cfg.activation))


def model_flops_per_token(cfg: ModelConfig) -> int:
    """6 * the active parameters per token (the standard training-FLOPs
    approximation: forward 2, backward 4)."""
    return 6 * analytic_param_count(cfg, active_only=True)


# ---------------------------------------------------------------------------
# batches (the reference's shapes; numpy-seeded numbers)
# ---------------------------------------------------------------------------
def batch_shapes(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """name -> (shape, dtype) of a training batch: ``tokens`` and
    ``targets`` (B, S) int32, and the stubbed frontends' inputs in
    bfloat16: encdec's ``frames`` (B, encoder_frames, d_model), vlm's
    ``patches`` (B, num_patches, patch_embed_dim)."""
    shapes = {"tokens": ((batch, seq), torch.int32), "targets": ((batch, seq), torch.int32)}
    if cfg.family == "encdec":
        shapes["frames"] = ((batch, cfg.encdec.encoder_frames, cfg.d_model), torch.bfloat16)
    if cfg.family == "vlm":
        shapes["patches"] = ((batch, cfg.vlm.num_patches, cfg.vlm.patch_embed_dim),
                             torch.bfloat16)
    return shapes


def make_batch(seed: int, cfg: ModelConfig, batch: int, seq: int, device=None) -> dict:
    """A batch of :func:`batch_shapes` from ``numpy.random.default_rng(seed)``
    on ``device`` (default ``cuda``): tokens uniform over the vocabulary,
    targets the tokens shifted left by one (the last wrapping round, as the
    reference's ``jnp.roll``), frames and patches N(0, 1) rounded to
    bfloat16."""
    rng = np.random.default_rng(seed)
    shapes = batch_shapes(cfg, batch, seq)
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    out = {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1)}
    for name, (shape, _) in shapes.items():
        if name not in out:
            out[name] = rng.standard_normal(shape, dtype=np.float32)
    dev = resolve_device(device)
    return {k: torch.from_numpy(v).to(device=dev, dtype=shapes[k][1]) for k, v in out.items()}
