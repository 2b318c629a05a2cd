"""minimal — a deliberately-partial native backend: the emulation stress test.

The port of ``repro.core.backends.minimal``.  It exports only the REQUIRED
handle queries plus the three primitives every recipe chain grounds out in:

* ``sendrecv``       (point-to-point permutation),
* ``reduce_scatter`` (the reduction primitive),
* ``allgather``      (the collection primitive).

Everything else — allreduce, bcast, barrier, reduce, scan, exscan, alltoall,
alltoallv, alltoallw, gather, scatter, the fault tier and every ``i*`` twin —
is synthesized at ``pax_init`` by tiered negotiation from the spec's
emulation recipes, including the deepest chain in the table (``scatter ->
bcast -> allreduce -> reduce_scatter + allgather``).

The exported entries reuse paxi's ``torch.distributed`` lowering (this is a
*native-convention* backend: ABI handles are its handles); the partial
surface is declared with ``ABI_SUBSET``.  Persistent plans and plan groups
compose the same way: the native ``reduce_scatter``/``allgather`` entries
inherit paxi's plan and plan-group hooks (one stacked collective per
stage), and an emulated ``allreduce`` group fuses per stage through the
recipe's group builder — every member's reduce-scatter leg before any
all-gather leg.  ``capabilities()`` reports ``plan_group: recipe-stage``
for the emulated entries and ``backend-hook`` for the native primitives.
"""
from __future__ import annotations

from .paxi import PaxiBackend


class MinimalBackend(PaxiBackend):
    """Native backend exporting only the recipe-ground primitives."""

    name = "minimal"

    ABI_SUBSET = frozenset({
        # REQUIRED tier: handle queries
        "comm_size", "comm_rank", "type_size",
        # the primitives recipes ground out in
        "sendrecv", "reduce_scatter", "allgather",
    })
