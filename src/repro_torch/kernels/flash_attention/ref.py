"""Plain PyTorch version of the flash-attention kernel.

The same function as ``csrc/flash_attention.cu`` and as the reference's
oracle (``repro/kernels/flash_attention/ref.py:attention_ref``), in the
kernel's layout: q (BH, S, D), k/v (BKV, S, D) with BH a multiple of BKV
and query head ``bh`` reading kv row ``bh // (BH // BKV)``.  The math runs
in float32 whatever the input dtype, scores are scaled by 1/sqrt(D), the
causal mask writes ``-1e30`` where a key lies after its query, and the
result comes back in q's dtype.

The CPU tests run this; on the card only ``chip_smoke.py`` calls it, to
hold the CUDA kernel against it.  The model never reaches it with a CUDA
tensor.
"""
from __future__ import annotations

import math

import torch

#: the score written where the causal mask hides a key
NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q: (BH, S, D); k/v: (BKV, S, D).  float32 math, returns q.dtype."""
    BH, S, D = q.shape
    group = BH // k.shape[0]
    kx = k.repeat_interleave(group, dim=0).float()
    vx = v.repeat_interleave(group, dim=0).float()
    s = torch.einsum("bqd,bkd->bqk", q.float(), kx) / math.sqrt(D)
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, vx).to(q.dtype)
