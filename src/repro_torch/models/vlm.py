"""Phi-3-vision: the dense transformer with image tokens prepended (the
reference's ``repro/models/vlm.py``).

As in the reference the CLIP frontend is a stub: a batch carries
precomputed patch embeddings ``patches`` (B, num_patches, patch_embed_dim).
The projector (``projector.w1``, tanh GELU, ``projector.w2``) maps them to
``d_model``, and the image tokens go before the text's embeddings.
Positions run over ``0 .. Np + S - 1``, the causal mask covers the image
prefix too, and the layers are the transformer's (``transformer._trunk``,
each layer body under ``maybe_remat``; under ``attention_impl="flash"``
every layer launches the flash kernel over all ``Np + S`` positions).  The
logits and the loss cover the text positions only; ``last_only`` keeps the
last position.

On the model axis (a model built for a :class:`~.tensor_parallel.Part`)
the layout is the transformer's (heads, ``d_ff``, vocabulary, FSDP), plus
the reference's projector spec: ``w1`` (None, fsdp), whole over the model
axis, and ``w2`` (fsdp, tp), split by output columns.  Every rank projects
the whole patches through ``w1``; the hidden activation enters ``w2``'s
columns through ``copy_to`` (each rank's columns add to its gradient) and
the rank's columns of the image tokens are all-gathered back
(``gather(..., partial=False)``: every rank computes the same downstream).

Decode is the transformer's on a contiguous cache: :func:`prefill_multimodal`
runs the image prefix and the prompt into a fresh cache (a rank's K/V
heads where they split), then ``decode_step`` appends one token.  The
serving engine runs the family statically and text only (``init_cache``,
``decode_step``), as the reference's does.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import transformer
from .attention import attention
from .common import activation_fn, dtype_of
from .tensor_parallel import TensorParallel, copy_to, gather
from .transformer import TransformerLM, cache_specs, init_cache, decode_step  # noqa: F401


class VlmLM(TransformerLM):
    """The transformer's parameters plus ``projector`` (``w1``:
    (patch_embed_dim, d_model), ``w2``: (d_model, d_model)); a rank's block
    of each as :class:`~.transformer.TransformerLM` holds it."""

    FAMILIES = ("vlm",)

    @classmethod
    def blocks(cls, cfg) -> dict:
        pdt, d = dtype_of(cfg.param_dtype), cfg.d_model
        return {**super().blocks(cfg),
                "projector": {"w1": ((cfg.vlm.patch_embed_dim, d), pdt), "w2": ((d, d), pdt)}}


def full_shapes(cfg) -> dict:
    """Leaf name -> the whole leaf's shape."""
    return VlmLM(cfg, "meta").full_shapes


#: the transformer's units (the attention's query and K/V heads); the
#: projector's ``w2`` splits where ``d_model`` divides the axis (its held spec)
split_units = transformer.split_units
segments = transformer.segments
read_partly = transformer.read_partly
ATTENTIONS = transformer.ATTENTIONS
FFNS = transformer.FFNS
#: the image prefix and the text share the residual stream, which stays
#: whole along the sequence (no vlm config asks for sequence parallelism)
SEQUENCE_PARALLEL = False


def spec_lm(cfg, fsdp="data", tp="model") -> dict:
    spec = transformer.spec_lm(cfg, fsdp, tp)
    spec["projector"] = {"w1": (None, fsdp), "w2": (fsdp, tp)}
    return spec


@torch.no_grad()
def init_lm(cfg, seed: int, device, model_rank: int = 0, model_axis: int = 1,
            fsdp_rank: int = 0, fsdp_size: int = 1) -> VlmLM:
    """The transformer's distributions (``transformer.init_weights_``); the
    projector's weights N(0,1)/sqrt(in).  A model holding a block holds
    that block of the whole model's draw."""
    return transformer.init_weights_(VlmLM(cfg, device, model_rank, model_axis, fsdp_rank,
                                           fsdp_size), cfg, seed)


def project_patches(model: VlmLM, patches: torch.Tensor, cfg,
                    par: Optional[TensorParallel] = None) -> torch.Tensor:
    """(B, Np, patch_embed_dim) -> the image tokens (B, Np, d_model), whole
    on every rank."""
    cdt = dtype_of(cfg.compute_dtype)
    p = model.projector.layer()
    if par is not None:
        p = par.params(p, "projector.")
    h = activation_fn("gelu")(patches.to(cdt) @ p["w1"].to(cdt))
    if par is None or not par.splits("projector.w2"):
        return h @ p["w2"].to(cdt)
    return gather(copy_to(h, par.tp_group) @ p["w2"].to(cdt), par.tp_group, -1, partial=False)


def _prefixed(model: VlmLM, tokens: torch.Tensor, patches: torch.Tensor, cfg,
              par: Optional[TensorParallel] = None) -> tuple:
    """The residual (B, Np + S, d): the image tokens, then the text's
    embedding; its positions; Np."""
    img = project_patches(model, patches, cfg, par)
    x = torch.cat([img, transformer._embed(model, tokens, cfg, par)], dim=1)
    B, n = x.shape[:2]
    return x, transformer._positions(0, n, B, x.device), img.shape[1]


def _forward_local(model: VlmLM, batch: dict, cfg, last_only: bool, dist) -> tuple:
    """(the head's logits over the text positions: the whole vocabulary's,
    or this rank's columns where it splits; the summed aux loss; the
    call's layout)."""
    tokens, patches = batch["tokens"], batch["patches"]
    par = TensorParallel.of(model, cfg, dist, patches.shape[1] + tokens.shape[1])
    x, positions, Np = _prefixed(model, tokens, patches, cfg, par)
    x, aux = transformer._trunk(model, x, cfg, lambda p, h, l, **kw: attention(
        p, h, cfg, positions=positions, causal=True, **kw), dist, par)
    return transformer._head(model, x[:, -1:] if last_only else x[:, Np:], cfg, par), aux, par


def forward_aux(model: VlmLM, batch: dict, cfg, last_only: bool = False,
                dist=None) -> tuple:
    """batch: ``tokens`` (B, S), ``patches`` (B, Np, patch_embed_dim) ->
    (logits (B, S, vocab) over the text positions, or (B, 1, vocab) with
    ``last_only``; the summed aux loss, None for the dense FFN)."""
    logits, aux, par = _forward_local(model, batch, cfg, last_only, dist)
    return (logits if par is None else par.full_logits(logits)), aux


def forward(model: VlmLM, batch: dict, cfg, last_only: bool = False,
            dist=None) -> torch.Tensor:
    return forward_aux(model, batch, cfg, last_only, dist)[0]


def loss_fn(model: VlmLM, batch: dict, cfg, dist=None) -> torch.Tensor:
    """Token-mean cross-entropy over the text positions (vocabulary-parallel
    where the vocabulary splits; plus the aux loss with an MoE block)."""
    logits, aux, par = _forward_local(model, batch, cfg, False, dist)
    loss = transformer._lm_loss(logits, batch["targets"], cfg, par)
    return loss if aux is None else loss + aux


def prefill_multimodal(model: VlmLM, tokens: torch.Tensor, patches: torch.Tensor, cfg,
                       dist=None, max_seq=None, dtype=torch.bfloat16) -> tuple:
    """The image prefix and the prompt (B, S) into a fresh contiguous cache
    of ``max_seq`` positions (default the config's; a rank's K/V heads
    where they split) in ``dtype`` (bfloat16, as the reference's); returns
    (the last position's logits (B, vocab), the cache, Np + S: the next
    position)."""
    par = TensorParallel.of(model, cfg, dist)
    x, positions, _ = _prefixed(model, tokens, patches, cfg, par)
    B, n = x.shape[:2]
    cache = init_cache(cfg, B, max_seq or cfg.max_seq_len, dtype, device=x.device,
                       model_axis=model.part.tp_size)
    x = transformer._run_cached(model, x, cache, 0, positions, cfg, dist, par)
    return transformer._logits(model, x[:, -1:], cfg, par)[:, 0, :], cache, n
