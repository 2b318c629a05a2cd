"""PMPI/QMPI-style tool interposition (paper §4.8).

Tools intercept every ABI call *once, against the ABI* — and therefore work
with every backend, which is precisely the ecosystem benefit §4.8 claims a
standard ABI delivers for performance/debugging tools.  Multiple tools stack
(the P^nMPI / QMPI multi-instrumentation model): ``before`` hooks run
outer→inner, ``after`` hooks inner→outer and may transform the result.

Tools may stash state in the status object's reserved fields — the slack the
standard status layout (§5.2) deliberately provides ("the proposed status
object ... has additional space that allows tools to hide state in the
reserved fields").
"""
from __future__ import annotations

import collections
import time
from typing import Any, Optional

from .status import Status


class Tool:
    """Base interposition tool.  Subclass and override hooks."""

    tool_id = 0

    def attach(self, abi) -> None:
        self.abi = abi

    def before(self, fname: str, args: tuple, info: dict) -> None:  # noqa: D401
        pass

    def after(self, fname: str, args: tuple, info: dict, result: Any) -> Any:
        return result

    def annotate_status(self, status: Optional[Status], seq: int) -> None:
        """Hide tool state in the reserved slack (§4.8/§5.2)."""
        if status is not None:
            status.set_reserved(0, self.tool_id)
            status.set_reserved(1, seq & 0x7FFFFFFF)


class CallCounter(Tool):
    """Counts ABI calls by function name."""

    tool_id = 1

    def __init__(self) -> None:
        self.counts: collections.Counter[str] = collections.Counter()

    def before(self, fname, args, info):
        self.counts[fname] += 1

    def reset(self) -> None:
        self.counts.clear()


class ByteCounter(Tool):
    """Tallies collective payload bytes per function — the tool-side ledger
    that EXPERIMENTS.md §Roofline cross-checks against HLO-parsed collective
    bytes."""

    tool_id = 2

    def __init__(self) -> None:
        self.bytes: collections.Counter[str] = collections.Counter()
        self.calls: collections.Counter[str] = collections.Counter()

    def before(self, fname, args, info):
        b = info.get("bytes")
        if b:
            self.bytes[fname] += int(b)
            self.calls[fname] += 1

    def total(self) -> int:
        return sum(self.bytes.values())

    def reset(self) -> None:
        self.bytes.clear()
        self.calls.clear()


class WallClockTracer(Tool):
    """Records (fname, t_ns) pairs of host-side dispatch; the message-rate
    benchmark uses it to attribute per-call overhead.

    Timer state is a per-tool LIFO stack of start times: ``before``/``after``
    pairs nest like the dispatch chain itself, so the stack is exact for
    nested ABI calls, never keys on reusable ``id()`` values, and cannot
    accumulate stale entries (an aborted call's start is popped by the next
    completed ``after`` instead of leaking forever)."""

    tool_id = 3

    def __init__(self, max_events: int = 100000) -> None:
        self.events: list[tuple[str, int]] = []
        self._starts: list[int] = []
        self._max = max_events

    def before(self, fname, args, info):
        self._starts.append(time.perf_counter_ns())

    def after(self, fname, args, info, result):
        if self._starts:
            t0 = self._starts.pop()
            if len(self.events) < self._max:
                self.events.append((fname, time.perf_counter_ns() - t0))
        return result


class SequenceStamper(Tool):
    """Demonstrates tool state hidden in reserved status fields: stamps a
    monotonically increasing sequence number into every status it is handed
    via ``stamp``."""

    tool_id = 4

    def __init__(self) -> None:
        self.seq = 0

    def before(self, fname, args, info):
        self.seq += 1

    def stamp(self, status: Status) -> None:
        self.annotate_status(status, self.seq)
