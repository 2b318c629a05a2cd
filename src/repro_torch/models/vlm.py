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

Decode is the transformer's on a contiguous cache: :func:`prefill_multimodal`
runs the image prefix and the prompt into a fresh cache, then
``decode_step`` appends one token.  The serving engine runs the family
statically and text only (``init_cache``, ``decode_step``), as the
reference's does.
"""
from __future__ import annotations

import torch

from . import transformer
from .attention import attention
from .common import ParamBlock, activation_fn, dtype_of, softmax_cross_entropy
from .transformer import TransformerLM, init_cache, decode_step  # noqa: F401


class VlmLM(TransformerLM):
    """The transformer's parameters plus ``projector`` (``w1``:
    (patch_embed_dim, d_model), ``w2``: (d_model, d_model))."""

    FAMILIES = ("vlm",)

    def __init__(self, cfg, device) -> None:
        super().__init__(cfg, device)
        pdt, d = dtype_of(cfg.param_dtype), cfg.d_model
        self.projector = ParamBlock({"w1": ((cfg.vlm.patch_embed_dim, d), pdt),
                                     "w2": ((d, d), pdt)}, device)


def spec_lm(cfg, fsdp="data", tp="model") -> dict:
    spec = transformer.spec_lm(cfg, fsdp, tp)
    spec["projector"] = {"w1": (None, fsdp), "w2": (fsdp, tp)}
    return spec


@torch.no_grad()
def init_lm(cfg, seed: int, device) -> VlmLM:
    """The transformer's distributions (``transformer.init_weights_``); the
    projector's weights N(0,1)/sqrt(in)."""
    return transformer.init_weights_(VlmLM(cfg, device), cfg, seed)


def project_patches(model: VlmLM, patches: torch.Tensor, cfg) -> torch.Tensor:
    """(B, Np, patch_embed_dim) -> the image tokens (B, Np, d_model)."""
    cdt = dtype_of(cfg.compute_dtype)
    h = activation_fn("gelu")(patches.to(cdt) @ model.projector.w1.to(cdt))
    return h @ model.projector.w2.to(cdt)


def _prefixed(model: VlmLM, tokens: torch.Tensor, patches: torch.Tensor, cfg) -> tuple:
    """The residual (B, Np + S, d): the image tokens, then the text's
    embedding; its positions; Np."""
    img = project_patches(model, patches, cfg)
    x = torch.cat([img, transformer._embed(model, tokens, cfg)], dim=1)
    B, n = x.shape[:2]
    return x, transformer._positions(0, n, B, x.device), img.shape[1]


def forward_aux(model: VlmLM, batch: dict, cfg, last_only: bool = False,
                dist=None) -> tuple:
    """batch: ``tokens`` (B, S), ``patches`` (B, Np, patch_embed_dim) ->
    (logits (B, S, vocab) over the text positions, or (B, 1, vocab) with
    ``last_only``; the summed aux loss, None for the dense FFN)."""
    x, positions, Np = _prefixed(model, batch["tokens"], batch["patches"], cfg)
    x, aux = transformer._trunk(model, x, cfg, lambda p, h, l: attention(
        p, h, cfg, positions=positions, causal=True), dist)
    return transformer._logits(model, x[:, -1:] if last_only else x[:, Np:], cfg), aux


def forward(model: VlmLM, batch: dict, cfg, last_only: bool = False,
            dist=None) -> torch.Tensor:
    return forward_aux(model, batch, cfg, last_only, dist)[0]


def loss_fn(model: VlmLM, batch: dict, cfg, dist=None) -> torch.Tensor:
    """Token-mean cross-entropy over the text positions (plus the aux loss
    with an MoE block)."""
    logits, aux = forward_aux(model, batch, cfg, dist=dist)
    loss = softmax_cross_entropy(logits, batch["targets"])
    return loss if aux is None else loss + aux


def prefill_multimodal(model: VlmLM, tokens: torch.Tensor, patches: torch.Tensor, cfg,
                       dist=None, max_seq=None) -> tuple:
    """The image prefix and the prompt (B, S) into a fresh contiguous cache
    of ``max_seq`` positions (default the config's); returns (the last
    position's logits (B, vocab), the cache, Np + S: the next position)."""
    x, positions, _ = _prefixed(model, tokens, patches, cfg)
    B, n = x.shape[:2]
    cache = init_cache(cfg, B, max_seq or cfg.max_seq_len, device=x.device)
    x = transformer._run_cached(model, x, cache, 0, positions, cfg, dist)
    return transformer._logits(model, x[:, -1:], cfg)[:, 0, :], cache, n
