"""Shared ``torch.distributed`` lowering of the abstract collectives.

The counterpart of the reference's ``_lax.py``.  There, collectives lower to
XLA ops over mesh axes inside one controller's program; here every process
is one rank and a communicator is a process group, so each primitive issues
one ``torch.distributed`` call on the group and returns a :class:`Pending`:
the asynchronous ``Work``, the output buffer, and the host-side step (if
any) that turns the buffer into the ABI result.  Blocking entry points call
``.result()`` at once; ``i*`` starts and plan starts hand the Pending to a
request, and the ABI's ``wait`` completes it — the MPI overlap idiom with a
real in-flight collective between start and wait.

Conventions kept from the reference:

* results are fresh tensors — no primitive writes into its input;
* a group of one with no process group (``PAX_COMM_SELF``) is the identity;
  a real group of one (a size-1 data-parallel communicator) still issues
  its collective;
* chunk index == communicator rank for scatters and gathers, so
  reduce-scatter followed by all-gather composes to an all-reduce.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from ..emulation import prefix_fold

#: collective names changed across torch releases (the ``*_single``
#: spellings replaced ``reduce_scatter_tensor``/``all_gather_into_tensor``);
#: one of each exists on every supported release, chosen once here
_reduce_scatter = (getattr(dist, "reduce_scatter_single", None)
                   or dist.reduce_scatter_tensor)
_all_gather = (getattr(dist, "all_gather_single", None)
               or dist.all_gather_into_tensor)

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
               "max": dist.ReduceOp.MAX}


class Pending:
    """An in-flight collective: its Work (or Works), the output buffer, the
    post-processing step that turns the buffer into the result, and the
    inputs the transfer reads (kept alive until completion)."""

    __slots__ = ("work", "value", "post", "keep")

    def __init__(self, work, value, post: Optional[Callable] = None,
                 keep=None) -> None:
        self.work = work
        self.value = value
        self.post = post
        self.keep = keep

    def result(self):
        work = self.work
        if work is not None:
            if isinstance(work, list):
                for w in work:
                    w.wait()
            else:
                work.wait()
            self.work = self.keep = None
        if self.post is not None:
            self.value = self.post(self.value)
            self.post = None
        return self.value


def done(value) -> Pending:
    """An already-complete result in Pending form."""
    return Pending(None, value)


def complete(value):
    """Resolve a Pending — or a member list holding Pendings — into values."""
    if value.__class__ is Pending:
        return value.result()
    if value.__class__ is list:
        return [v.result() if v.__class__ is Pending else v for v in value]
    return value


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def allreduce(x: torch.Tensor, op: str, group) -> Pending:
    if group is None:
        return done(x)
    out = x.contiguous().clone()
    return Pending(dist.all_reduce(out, op=_REDUCE_OPS[op], group=group,
                                   async_op=True), out)


def allreduce_generic(x: torch.Tensor, fn: Callable, group) -> Pending:
    """All-reduce for ops the wire has no reduction for (PROD, bitwise,
    logical, MINLOC/MAXLOC, user callbacks): all-gather + local fold in
    rank order, as the reference does."""
    if group is None:
        return done(x)
    S = size(group)

    def fold(g):
        acc = g[0]
        for i in range(1, S):
            acc = fn(acc, g[i])
        return acc

    p = allgather(x.unsqueeze(0), group)
    return Pending(p.work, p.value, lambda v: fold(p.post(v) if p.post else v),
                   p.keep)


def reduce_scatter_sum(x: torch.Tensor, group, axis: int = 0) -> Pending:
    if group is None:
        return done(x)
    S = size(group)
    xt = x.movedim(axis, 0).contiguous() if axis else x.contiguous()
    out = torch.empty((xt.shape[0] // S,) + tuple(xt.shape[1:]),
                      dtype=x.dtype, device=x.device)
    work = _reduce_scatter(out, xt, group=group, async_op=True)
    post = (lambda o: o.movedim(0, axis)) if axis else None
    return Pending(work, out, post, xt)


def reduce_scatter_generic(x: torch.Tensor, fn: Callable, group,
                           axis: int = 0) -> Pending:
    """Generic-op reduce-scatter: all-reduce then slice own chunk."""
    if group is None:
        return done(x)
    S, r = size(group), rank(group)
    full = allreduce_generic(x, fn, group).result()
    chunk = full.shape[axis] // S
    return done(full.narrow(axis, r * chunk, chunk))


def allgather(x: torch.Tensor, group, axis: int = 0) -> Pending:
    if group is None:
        return done(x)
    S = size(group)
    xt = x.movedim(axis, 0).contiguous() if axis else x.contiguous()
    out = torch.empty((S * xt.shape[0],) + tuple(xt.shape[1:]),
                      dtype=x.dtype, device=x.device)
    work = _all_gather(out, xt, group=group, async_op=True)
    post = (lambda o: o.movedim(0, axis)) if axis else None
    return Pending(work, out, post, xt)


def bcast(x: torch.Tensor, root: int, group, ranks: Sequence[int]) -> Pending:
    if group is None:
        return done(x)
    out = x.contiguous().clone()
    return Pending(dist.broadcast(out, src=ranks[root], group=group,
                                  async_op=True), out)


def barrier(group, device) -> Pending:
    if group is None:
        return done(None)
    t = torch.zeros((1,), dtype=torch.float32, device=device)
    return Pending(dist.all_reduce(t, group=group, async_op=True), None,
                   keep=t)


def alltoall(x: torch.Tensor, group, split_axis: int,
             concat_axis: int) -> Pending:
    """Tiled all-to-all: chunk j of ``split_axis`` goes to rank j; received
    chunks concatenate along ``concat_axis`` in source-rank order."""
    if group is None:
        return done(x)
    S = size(group)
    if x.shape[split_axis] % S:
        raise ValueError(
            f"alltoall split axis {split_axis} (length "
            f"{x.shape[split_axis]}) not divisible by comm size {S}")
    xt = x.movedim(split_axis, 0).contiguous()
    out = torch.empty_like(xt)
    work = dist.all_to_all_single(out, xt, group=group, async_op=True)

    def post(o):
        return torch.cat([b.movedim(0, split_axis) for b in o.chunk(S)],
                         dim=concat_axis)

    return Pending(work, out, post, xt)


def alltoallv(x: torch.Tensor, sendcounts: Sequence[int],
              recvcounts: Sequence[int], group) -> Pending:
    """Counted all-to-all over the leading axis.  The reference's SPMD rule
    is kept so both packages accept exactly the same calls: counts must be
    uniform (non-uniform counts raise ``ValueError``)."""
    sendcounts = tuple(int(c) for c in sendcounts)
    recvcounts = tuple(int(c) for c in recvcounts)
    if len(sendcounts) != len(recvcounts):
        raise ValueError("sendcounts and recvcounts must have equal length")
    if len(set(sendcounts) | set(recvcounts)) != 1:
        raise ValueError(
            "SPMD alltoallv requires uniform counts (one static trace cannot "
            f"express per-rank-varying counts); got sendcounts={sendcounts}, "
            f"recvcounts={recvcounts}")
    c = sendcounts[0]
    P = len(sendcounts)
    if x.shape[0] != P * c:
        raise ValueError(f"payload has {x.shape[0]} rows, counts promise {P}x{c}")
    if group is None:
        if P != 1:
            raise ValueError("group-of-one alltoallv takes exactly one count")
        return done(x)
    if c == 0:
        return done(x[:0])
    return alltoall(x, group, 0, 0)


def ppermute(x: torch.Tensor, perm, group, ranks: Sequence[int]) -> Pending:
    """Point-to-point permutation: for each (src, dst) pair, rank dst
    receives src's payload; ranks no pair targets receive zeros."""
    if group is None:
        return done(x)
    # ``perm`` speaks the communicator's rank space (a survivor
    # communicator keeps its parent's), so this rank is its place in ``ranks``
    me = ranks.index(dist.get_rank())
    out = torch.zeros_like(x)
    ops = []
    x = x.contiguous()
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x, ranks[dst], group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, ranks[src], group))
    works = dist.batch_isend_irecv(ops) if ops else None
    return Pending(works, out, keep=x)


def scan_fold(x: torch.Tensor, fn: Callable, group, inclusive: bool) -> Pending:
    """Prefix reduction over communicator rank (MPI_Scan/Exscan) through the
    shared fold (one definition of the exscan rank-0 convention)."""
    if group is None:
        return done(x)
    r = rank(group)
    p = allgather(x.unsqueeze(0), group)
    return Pending(p.work, p.value,
                   lambda g: prefix_fold(g, r, fn, x, inclusive), p.keep)


def scatter_from_root(x: torch.Tensor, root: int, group, ranks: Sequence[int],
                      axis: int = 0) -> Pending:
    """SPMD scatter: broadcast from root, each rank keeps its chunk."""
    if group is None:
        return done(x)
    S, r = size(group), rank(group)
    p = bcast(x, root, group, ranks)

    def take(y):
        chunk = y.shape[axis] // S
        return y.narrow(axis, r * chunk, chunk)

    return Pending(p.work, p.value, take, p.keep)


class Ring(NamedTuple):
    """One ring of an explicit ring schedule: its size, its process group
    (``None`` for a ring of one), the member ranks in ring order and this
    process's position among them."""

    size: int
    group: Any
    ranks: tuple
    index: int


def ring_shift(xs: Sequence[torch.Tensor], ring: Ring) -> list:
    """One hop of a ring schedule — the reference's ``lax.ppermute(x, axis,
    [(s, (s + 1) % S) for s in range(S)])``: every tensor of ``xs`` goes to
    the next rank of the ring and the previous rank's arrives.  All of them
    travel in one ``batch_isend_irecv`` (one tag each) and the hop is
    complete on return (gloo on the CPU, NCCL on the card)."""
    S, me = ring.size, ring.index
    nxt, prv = ring.ranks[(me + 1) % S], ring.ranks[(me - 1) % S]
    ops, outs = [], []
    for tag, x in enumerate(xs):
        x = x.contiguous()
        out = torch.empty_like(x)
        ops.append(dist.P2POp(dist.isend, x, nxt, ring.group, tag))
        ops.append(dist.P2POp(dist.irecv, out, prv, ring.group, tag))
        outs.append(out)
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return outs
