"""Shared model building blocks: norms, activations, RoPE, embeddings,
initializers and the loss — the reference's (``repro.models.common``) math,
operation for operation, on tensors.

Numbers that matter for parity with the reference: RMSNorm computes in f32
with ``eps=1e-6`` and its scales stay f32 in a bf16 model; RoPE
frequencies are f32 and the rotation runs in the activation dtype; the
sinusoidal position table is f32; the loss
is a token mean over f32 logits with a ``z_loss=1e-4`` term.
"""
from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16, "float64": torch.float64}[name]


def widened(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, the type of the float32 islands (the norms, the
    loss, rwkv6's adapters and scan) in a bf16 or float32 model; ``x`` as
    it is in a float64 model, which computes them in float64."""
    return x if x.dtype == torch.float64 else x.float()


# ---------------------------------------------------------------------------
# initializers (the reference's distributions; its random bits differ).  The
# numbers come from CPU generators, so one seed gives the same weights on
# every device.
# ---------------------------------------------------------------------------
#: a draw is cut into chunks of this many elements, each from its own CPU
#: generator, so the host's threads draw the chunks together
DRAW_CHUNK = 1 << 20


def normal_draw(shape: tuple, gen: torch.Generator, std: float) -> torch.Tensor:
    """N(0, 1) * std of ``shape`` in f32 on the CPU: one seed taken from
    ``gen``, then chunk ``i`` of :data:`DRAW_CHUNK` elements from a generator
    seeded by (that seed, ``i``), the chunks drawn on the host's threads
    together.  The numbers depend on ``gen``'s state alone, not on the
    number of threads."""
    base = int(torch.randint(0, 1 << 62, (), generator=gen))
    out = torch.empty(shape, dtype=torch.float32)
    flat = out.view(-1)

    def fill(i: int) -> None:
        g = torch.Generator().manual_seed((base + i * 0x9E3779B97F4A7C15) % (1 << 63))
        flat[i * DRAW_CHUNK:(i + 1) * DRAW_CHUNK].normal_(0.0, std, generator=g)

    chunks = -(-flat.numel() // DRAW_CHUNK)
    if chunks <= 1:
        fill(0)
    else:
        with ThreadPoolExecutor(max_workers=min(chunks, os.cpu_count() or 1)) as pool:
            list(pool.map(fill, range(chunks)))
    return out


def normal_init_(w: torch.Tensor, gen: torch.Generator, std: float,
                 part: tuple = (0, 1), full: tuple | None = None, index: tuple = ()) -> None:
    """Fill ``w`` with N(0, 1) * std (:func:`normal_draw`), one slice of its
    leading (layer) axis at a time when it is stacked, so the host holds one
    layer's draw.  ``part=(r, n)``: each slice holds part ``r`` of ``n`` of a
    draw ``n`` times its first axis long (one rank's experts of the whole
    layer's); ``full``/``index``: each slice holds block ``index`` (slices,
    one per dimension) of a draw of shape ``full`` (one rank's heads, FFN
    columns or vocabulary rows), so every split draws the same weights from
    one seed."""
    r, n = part
    for s in (w if w.ndim > 2 else (w,)):
        k = s.shape[0]
        shape = tuple(full) if full is not None else (k * n, *s.shape[1:])
        block = tuple(index) if full is not None else (slice(r * k, (r + 1) * k),)
        s.copy_(normal_draw(shape, gen, std)[block])


def dense_init_(w: torch.Tensor, gen: torch.Generator, scale: float = 1.0,
                part: tuple = (0, 1), full: tuple | None = None, index: tuple = ()) -> None:
    """Fill ``w`` (…, in, out) with N(0, 1) * scale / sqrt(in), ``in`` the
    whole leaf's (:func:`normal_init_`'s ``part``, ``full`` and ``index``)."""
    fan_in = (full if full is not None else w.shape)[-2]
    normal_init_(w, gen, scale / math.sqrt(fan_in), part, full, index)


def embed_init_(w: torch.Tensor, gen: torch.Generator, full: tuple | None = None,
                index: tuple = ()) -> None:
    normal_init_(w, gen, 0.02, full=full, index=index)


# ---------------------------------------------------------------------------
# parameter blocks: the reference's parameter tree as modules
# ---------------------------------------------------------------------------
class ParamBlock(nn.Module):
    """A named set of parameters (one node of the reference's tree); child
    blocks are the nested nodes."""

    def __init__(self, shapes: dict, device) -> None:
        super().__init__()
        for name, (shape, dtype) in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=dtype, device=device)))

    def layer(self, l: int | None = None) -> dict:
        """This node as the reference's nested dict: layer ``l``'s slice of
        every stacked parameter, or with no ``l`` the parameters themselves."""
        out = {name: p if l is None else p[l]
               for name, p in self.named_parameters(recurse=False)}
        for name, child in self.named_children():
            out[name] = child.layer(l)
        return out


def norm_shapes(shape: tuple, kind: str, dtype=torch.float32) -> dict:
    # norm scales stay float32 whatever the model's parameter dtype (float64
    # in a float64 model, which passes it)
    out = {"scale": (shape, dtype)}
    if kind != "rmsnorm":
        out["bias"] = (shape, dtype)
    return out


def spec_norm(kind: str) -> dict:
    """A norm node's parameter specs (the reference's ``spec_norm``)."""
    if kind == "rmsnorm":
        return {"scale": (None,)}
    return {"scale": (None,), "bias": (None,)}


def spec_embedding(tie: bool, tp: str, fsdp, vocab: int = 0, tp_size: int = 0) -> dict:
    """The embedding's specs: vocab over ``tp`` where the model axis
    divides it, ``d_model`` over ``fsdp``."""
    v_tp = tp if not tp_size or (vocab and vocab % tp_size == 0) else None
    p = {"tok": (v_tp, fsdp)}
    if not tie:
        p["unembed"] = (fsdp, v_tp)
    return p


def stack_specs(tree: dict) -> dict:
    """Every spec of ``tree`` with a leading ``None``: the layer axis of
    stacked per-layer parameters."""
    return {k: stack_specs(v) if isinstance(v, dict) else (None, *v) for k, v in tree.items()}


def embed_shapes(cfg, dtype) -> dict:
    out = {"tok": ((cfg.vocab_size, cfg.d_model), dtype)}
    if not cfg.tie_embeddings:
        out["unembed"] = ((cfg.d_model, cfg.vocab_size), dtype)
    return out


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def apply_norm(scale: torch.Tensor, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6, bias: torch.Tensor | None = None,
               reduce=None, width: int = 0) -> torch.Tensor:
    """The reference's norm over ``x``'s last dimension.  With ``reduce``
    (RMSNorm only) ``x`` holds one block of ``width`` features: the block's
    sum of squares goes through ``reduce`` (the all-reduce over the ranks
    holding the other blocks) before it is divided by ``width``."""
    xf = widened(x)
    if kind == "rmsnorm":
        if reduce is None:
            var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        else:
            var = reduce(torch.square(xf).sum(dim=-1, keepdim=True)) / width
        y = xf * torch.rsqrt(var + eps) * widened(scale)
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * widened(scale) + widened(bias)
    return y.to(x.dtype)


def norm(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    """:func:`apply_norm` with a norm node of the tree (``scale``, ``bias``)."""
    return apply_norm(p["scale"], x, kind, bias=p.get("bias"))


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------
def activation_fn(name: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
        "relu2": lambda x: torch.square(F.relu(x)),
    }[name]


GLU_ACTIVATIONS = {"swiglu": "silu", "geglu": "gelu"}


def is_glu(name: str) -> bool:
    return name in GLU_ACTIVATIONS


# ---------------------------------------------------------------------------
# RoPE (full or partial fraction)
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, fraction: float, theta: float, device=None):
    rot_dim = int(head_dim * fraction) // 2 * 2
    inv = 1.0 / (theta ** (torch.arange(0, rot_dim, 2, dtype=torch.float32,
                                        device=device) / rot_dim))
    return inv, rot_dim


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    head_dim = x.shape[-1]
    inv, rot_dim = rope_frequencies(head_dim, fraction, theta, x.device)
    if rot_dim == 0:
        return x
    ang = positions[..., :, None].float() * inv  # (..., seq, rot/2)
    cos = torch.cos(ang)[..., :, None, :].to(x.dtype)  # broadcast over heads
    sin = torch.sin(ang)[..., :, None, :].to(x.dtype)
    xr, xp = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    xr = torch.stack([r1, r2], dim=-1).reshape(xr.shape)
    return torch.cat([xr, xp], dim=-1) if rot_dim < head_dim else xr


def sinusoidal_positions(length: int, dim: int, device=None) -> torch.Tensor:
    """The fixed (length, dim) position table of the encoder-decoder's
    encoder, in f32: ``pos * exp(j * -ln(10000) / dim)`` for ``j = 0, 2,
    ...``, its sine on the even columns and its cosine on the odd ones."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / dim))
    pe = torch.zeros((length, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------
def embed_tokens(tok: torch.Tensor, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    return F.embedding(tokens, tok.to(compute_dtype))


def unembed(embed: dict, x: torch.Tensor, tie: bool) -> torch.Tensor:
    """``x @ tok.T`` when tied, else ``x @ unembed``."""
    w = embed["tok"].t() if tie else embed["unembed"]
    return x @ w.to(x.dtype)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def softmax_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                          ignore_id: int = -1, z_loss: float = 1e-4) -> torch.Tensor:
    """Token-mean CE with z-loss; fp32 reduction."""
    logits = widened(logits)
    mask = (targets != ignore_id).float()
    tclip = targets.clamp_min(0).long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, tclip[..., None])[..., 0]
    nll = (lse - ll) * mask
    zl = z_loss * torch.square(lse) * mask
    denom = torch.clamp_min(mask.sum(), 1.0)
    return (nll.sum() + zl.sum()) / denom


# ---------------------------------------------------------------------------
# rematerialisation
# ---------------------------------------------------------------------------
def maybe_remat(fn, name: str):
    """``fn`` under ``parallelism.remat``: ``"none"`` as it is; ``"full"``
    through ``torch.utils.checkpoint`` (non-reentrant), so its activations
    are recomputed in the backward instead of kept, and only while autograd
    records (an inference forward runs ``fn`` once); ``"dots"`` (the
    reference's save-the-matmuls policy) is not ported.  Remat changes no
    result (``configs/base.py``)."""
    if name == "none":
        return fn
    if name == "full":
        # no layer body draws random numbers, so the RNG state is not saved:
        # saving the card's is a host sync at every checkpoint
        return lambda *a: checkpoint(fn, *a, use_reentrant=False, preserve_rng_state=False) \
            if torch.is_grad_enabled() else fn(*a)
    if name == "dots":
        raise NotImplementedError("remat='dots' (save only the matrix products) is not "
                                  "ported: ROADMAP queue 1")
    raise ValueError(f"remat must be 'none', 'full' or 'dots', got {name!r}")
