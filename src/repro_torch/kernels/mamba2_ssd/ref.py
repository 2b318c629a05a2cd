"""Plain PyTorch versions of the Mamba2 SSD scan.

* :func:`ssd` — the function of ``csrc/ssd_wgmma.cu`` in its layout: x
  (Bb, T, H, P), dt (Bb, T, H), A and D (H,), B and C (Bb, T, N) shared by
  the heads, from a zero state, returning y (Bb, T, H, P) in the inputs'
  type (float32 from the wrapper; ``chip_smoke.py`` also runs it in
  float64 as an oracle).  It is :func:`ssd_chunked` with the final state
  dropped, and the kernel registry's ``torch`` variant.
* :func:`ssd_chunked` — the reference's chunked form with a state in and
  out (``repro/models/mamba.py:ssd_chunked``), which the port's
  ``models/mamba.py`` takes from here.
* :func:`ssd_ref` — the reference's sequential oracle
  (``repro/kernels/mamba2_ssd/ref.py``), in its layout (BH, T, .).
* :func:`ssd_nonfinite_mask` — where :func:`ssd` is not finite, from where
  its inputs are not: the rule of the kernel's non-finite pass.

The CPU tests run these; on the card only ``chip_smoke.py`` calls them, to
hold the CUDA kernel against them.
"""
from __future__ import annotations

import torch


def _segsum(wlog):
    """wlog: (..., c).  (..., c, c) with S[t, s] = sum_{r=s+1..t} wlog_r for
    s < t, 0 on the diagonal, -inf above it."""
    c = wlog.shape[-1]
    cs = torch.cumsum(wlog, dim=-1)
    S = cs[..., :, None] - cs[..., None, :]
    tri = torch.ones((c, c), dtype=torch.bool, device=wlog.device).tril()
    return torch.where(tri, S, -torch.inf)


def ssd_chunked(x, dt, A, B, C, D, state, chunk: int):
    """x: (Bb, T, H, P); dt: (Bb, T, H) (softplus'd); A: (H,) negative;
    B, C: (Bb, T, N); D: (H,); state: (Bb, H, P, N).  Returns
    (y, final_state), float32."""
    Bb, T, H, Pd = x.shape
    N = B.shape[-1]
    if T % chunk:
        raise ValueError(f"ssd_chunked: T={T} is not a multiple of chunk={chunk}")
    nc = T // chunk
    xr = x.reshape(Bb, nc, chunk, H, Pd).transpose(0, 1)     # (nc, Bb, c, H, P)
    dtr = dt.reshape(Bb, nc, chunk, H).transpose(0, 1)       # (nc, Bb, c, H)
    Br = B.reshape(Bb, nc, chunk, N).transpose(0, 1)         # (nc, Bb, c, N)
    Cr = C.reshape(Bb, nc, chunk, N).transpose(0, 1)
    ys = []
    for xc, dtc, Bc, Cc in zip(xr, dtr, Br, Cr):
        wl_h = (dtc * A).transpose(1, 2)                     # (Bb, H, c) per-step log decay
        decay = torch.exp(_segsum(wl_h))                     # (Bb, H, t, s)
        cb = torch.einsum("btn,bsn->bts", Cc, Bc)
        M = cb[:, None] * decay * dtc.transpose(1, 2)[:, :, None, :]
        y_intra = torch.einsum("bhts,bshp->bthp", M, xc)
        # inter-chunk: y_t += C_t . exp(la_t) S_in
        la = torch.cumsum(wl_h, dim=-1)                      # (Bb, H, c), inclusive of step t
        y_inter = torch.einsum("bhtn,bhpn->bthp", Cc[:, None] * torch.exp(la)[..., None], state)
        ys.append(y_intra + y_inter + xc * D[None, None, :, None])
        # S_out = exp(la_end) S_in + sum_s exp(la_end - la_s) dt_s x_s B_s^T
        a_end = torch.exp(la[..., -1])                       # (Bb, H)
        k = (Bc[:, None] * torch.exp(la[..., -1:, None] - la[..., None])
             * dtc.transpose(1, 2)[..., None])
        state = a_end[..., None, None] * state + torch.einsum("bhtn,bthp->bhpn", k, xc)
    y = torch.stack(ys, dim=1).reshape(Bb, T, H, Pd)
    return y, state


def ssd(x, dt, A, B, C, D, *, chunk: int):
    """The kernel's function: :func:`ssd_chunked` from a zero state, y only."""
    Bb, _, H, Pd = x.shape
    state = torch.zeros((Bb, H, Pd, B.shape[-1]), dtype=x.dtype, device=x.device)
    return ssd_chunked(x, dt, A, B, C, D, state, chunk)[0]


def ssd_ref(x, dt, b, c, a, d):
    """x: (BH, T, P); dt: (BH, T); b, c: (BH, T, N); a, d: (BH,).
    Sequential scan (ground truth):

        S[p,n] <- exp(dt_t a) S[p,n] + dt_t x_t[p] b_t[n]
        y_t[p]  = S[p,n] . c_t[n] + d x_t[p]
    """
    BH, T, P = x.shape
    S = torch.zeros((BH, P, b.shape[-1]), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(T):
        xt, dtt = x[:, t], dt[:, t]
        upd = (xt * dtt[:, None])[:, :, None] * b[:, t, None, :]
        S = torch.exp(dtt * a)[:, None, None] * S + upd
        ys.append(torch.einsum("bpn,bn->bp", S, c[:, t]) + xt * d[:, None])
    return torch.stack(ys, dim=1)


def ssd_nonfinite_mask(x, dt, B, C, chunk: int):
    """(Bb, T, H, P) bool: where :func:`ssd` (A and D finite) is not finite,
    from where x, dt, B and C are not.  A non-finite x at (b, s, h, p)
    reaches column p of head h over all of s's chunk (the intra-chunk
    product multiplies it by the zeros above the diagonal too) and every
    later chunk (through the state); dt at (b, s, h), all of head h from
    s's chunk on; B at (b, s), every head from s's chunk on; C at (b, t),
    row t only.  The kernel's pass computes the same flags per (batch row,
    chunk) and ORs them over the chunks so far."""
    Bb, T, H, Pd = x.shape
    nc = T // chunk
    bad = lambda a: ~torch.isfinite(a)  # noqa: E731
    fx = bad(x).reshape(Bb, nc, chunk, H, Pd).any(2)                 # (Bb, nc, H, P)
    fdt = bad(dt).reshape(Bb, nc, chunk, H).any(2)                   # (Bb, nc, H)
    fB = bad(B).reshape(Bb, nc, -1).any(2)                           # (Bb, nc)
    run = fx | fdt[..., None] | fB[:, :, None, None]
    run = run.to(torch.int8).cummax(dim=1).values.bool()             # OR over chunks so far
    return run.repeat_interleave(chunk, dim=1) | bad(C).any(-1)[:, :, None, None]
