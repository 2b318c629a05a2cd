"""Plain PyTorch versions of the WKV6 scan.

* :func:`wkv6` — the function of ``csrc/wkv6_wgmma.cu`` in its layout: r, k, v
  and wlog (B, T, H, N), u (H, N), from a zero state, returning
  y (B, T, H, N) in their type (float32 on the kernel's path, float64 for
  ``chip_smoke.py``'s full-width comparison).  It is :func:`wkv6_chunked` with the final
  state dropped, and the kernel registry's ``torch`` variant.
* :func:`wkv6_chunked` — the reference's chunked matmul form with a state
  in and out (``repro/models/rwkv.py:wkv6_chunked``), which the port's
  ``models/rwkv.py`` takes from here.
* :func:`wkv6_ref` — the reference's sequential oracle
  (``repro/kernels/rwkv6_scan/ref.py``), in its layout (BH, T, N).

The CPU tests run these; on the card only ``chip_smoke.py`` calls them, to
hold the CUDA kernel against them.
"""
from __future__ import annotations

import torch


def wkv6_chunked(r, k, v, wlog, u, state, chunk: int):
    """r, k, v: (B, T, H, N); wlog: (B, T, H, N) per-step log decay (< 0);
    u: (H, N); state: (B, H, N, N).  Returns (y, final_state), float32."""
    B, T, H, N = r.shape
    if T % chunk:
        raise ValueError(f"wkv6_chunked: T={T} is not a multiple of chunk={chunk}")
    nc = T // chunk

    def chunks(x):  # (B, T, H, N) -> (nc, B, H, c, N)
        return x.reshape(B, nc, chunk, H, N).permute(1, 0, 3, 2, 4)

    rc, kc, vc, wc = (chunks(x) for x in (r, k, v, wlog))
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=r.device).tril(-1)
    ys = []
    for rr, kk, vv, ww in zip(rc, kc, vc, wc):
        la = torch.cumsum(ww, dim=2)            # log A_{t+1} = sum_{s<=t} log w_s
        q_t = rr * torch.exp(la - ww)           # r_t * A_t
        k_t = kk * torch.exp(-la)               # k_s / A_{s+1}
        att = torch.where(tri, torch.einsum("bhtn,bhsn->bhts", q_t, k_t), 0.0)
        diag = torch.einsum("bhtn,bhtn->bht", rr, u[None, :, None, :] * kk)
        y = torch.einsum("bhts,bhsn->bhtn", att, vv) + diag[..., None] * vv
        ys.append(y + torch.einsum("bhtn,bhnm->bhtm", q_t, state))  # inter-chunk
        a_end = torch.exp(la[:, :, -1, :])      # (B, H, N) total decay
        k_scaled = kk * torch.exp(la[:, :, -1:, :] - la)
        state = a_end[..., None] * state + torch.einsum("bhtn,bhtm->bhnm", k_scaled, vv)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, T, H, N)
    return y, state


def wkv6(r, k, v, wlog, u, *, chunk: int):
    """The kernel's function: :func:`wkv6_chunked` from a zero state, y only."""
    B, _, H, N = r.shape
    state = torch.zeros((B, H, N, N), dtype=r.dtype, device=r.device)
    return wkv6_chunked(r, k, v, wlog, u, state, chunk)[0]


def wkv6_ref(r, k, v, wlog, u):
    """r, k, v, wlog: (BH, T, N); u: (BH, N).  Sequential scan (ground truth):

        y_t[j]    = sum_i r_t[i] (S[i,j] + u[i] k_t[i] v_t[j])
        S[i,j]   <- exp(wlog_t[i]) S[i,j] + k_t[i] v_t[j]
    """
    BH, T, N = r.shape
    S = torch.zeros((BH, N, N), dtype=torch.float32, device=r.device)
    ys = []
    for t in range(T):
        kv = k[:, t, :, None] * v[:, t, None, :]          # (BH, N, N)
        ys.append(torch.einsum("bi,bij->bj", r[:, t], S + u[:, :, None] * kv))
        S = torch.exp(wlog[:, t])[:, :, None] * S + kv
    return torch.stack(ys, dim=1)
