"""Checkpointing: async save, atomic publish, CRC-verified restore — in the
reference's on-disk format (``repro.checkpoint.checkpointer``), so a step
saved by either package restores in the other.

The format, exactly the reference's:

* one directory per step, ``step_%010d``, written as ``.tmp_step_*`` and
  published by an atomic rename (a torn save is never a checkpoint);
* ``shard_0.npz`` holding ``leaf_{i}``, the state's leaves in JAX's
  flatten order: dict keys sorted, a ``NamedTuple`` field by field, lists
  and tuples in order; the port's parameter module is its parameter tree
  (``param_leaves`` order, which is that sorted order);
* ``manifest.json`` with ``step``, ``n_leaves``, ``names`` (the
  ``jax.tree_util.keystr`` strings, e.g. ``.params['embed']``,
  ``.opt.m``), ``treedef`` (the structure in ``PyTreeDef`` notation),
  ``time`` and ``shard_crc32``;
* bfloat16 leaves as raw 2-byte values (``|V2``), as ``np.savez`` writes
  the reference's bfloat16 arrays.  On restore the skeleton's dtype decides:
  a ``|V2`` leaf restores into a bfloat16 skeleton leaf as bfloat16 bits
  (the reference hands ``|V2`` back unchanged).

The port has no treedef to unflatten: :meth:`Checkpointer.restore` maps the
file's leaves onto the ``names`` of a skeleton built from the port's state
and raises ``ValueError`` naming both lists when they differ, or naming
both shapes when a leaf's shape differs (a ZeRO-1 flat vector padded for
another layout, the int8 ring's wire blocks among them) — it never
reshapes.

**Ranks.**  One process is one rank here; the file holds the *global*
state, as the reference writes it.  With a ``DistContext`` bound
(``Checkpointer(dist=...)``) the ZeRO-1 shards (``FlatAdamState`` ``m``,
``v`` and the per-rank ``ef``) are gathered over the data-parallel group
for a save, only data-parallel rank 0 writes, and a restore takes this
rank's slice.  :meth:`wait` ends in a barrier over the context's ranks, so
no rank reads the directory while another still writes it.

``save_async`` copies device to host synchronously and writes in a thread;
CRC32 runs over every byte on save and on restore.  ``last_save`` and
``last_restore`` keep the bytes and the times of each phase.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as tdist
from torch import nn

from ..core import PAX_COMM_WORLD
from ..optim.adamw import FlatAdamState, nest

#: the ZeRO-1 flat state's per-rank vectors: shards of one global vector
#: (``m``, ``v``) and each rank's own residual (``ef``), in rank order
_SHARDED_FIELDS = ("m", "v", "ef")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, path: str = "", sharded: bool = False) -> tuple[list, str]:
    """(``[(keystr, leaf, sharded)]`` in JAX's flatten order, the structure
    in ``PyTreeDef`` notation).  ``sharded`` marks the ZeRO-1 flat state's
    per-rank vectors (``FlatAdamState`` ``m``, ``v``, ``ef``)."""
    if isinstance(tree, nn.Module):
        tree = nest(list(tree.named_parameters()))
    if isinstance(tree, dict):
        out, parts = [], []
        for k in sorted(tree):
            sub, d = _flatten(tree[k], f"{path}[{k!r}]")
            out += sub
            parts.append(f"{k!r}: {d}")
        return out, "{" + ", ".join(parts) + "}"
    if _is_namedtuple(tree):
        out, parts = [], []
        flat_state = isinstance(tree, FlatAdamState)
        for f in tree._fields:
            sub, d = _flatten(getattr(tree, f), f"{path}.{f}",
                              flat_state and f in _SHARDED_FIELDS)
            out += sub
            parts.append(d)
        return out, f"CustomNode(namedtuple[{type(tree).__name__}], [{', '.join(parts)}])"
    if isinstance(tree, (list, tuple)):
        out, parts = [], []
        for i, v in enumerate(tree):
            sub, d = _flatten(v, f"{path}[{i}]")
            out += sub
            parts.append(d)
        body = ", ".join(parts)
        return out, (f"[{body}]" if isinstance(tree, list) else
                     f"({body}{',' if len(parts) == 1 else ''})")
    if tree is None:
        return [], "None"
    return [(path, tree, sharded)], "*"


def _file_crc32(path: Path) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 24)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def _to_host(x) -> np.ndarray:
    """A leaf as the array the file holds (bfloat16 as ``|V2`` bits)."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.dtype("V2"))
        return t.cpu().numpy()
    return np.asarray(x)


def _from_host(a: np.ndarray, like) -> Any:
    """A file leaf in the skeleton leaf's type: a tensor of its dtype on
    its device (``|V2`` read as bfloat16 bits), else a numpy array."""
    if isinstance(like, torch.Tensor):
        if like.dtype == torch.bfloat16:
            bits = a.view(np.int16) if a.dtype.kind == "V" else a.astype(np.float32)
            t = torch.from_numpy(np.ascontiguousarray(bits))
            t = t.view(torch.bfloat16) if a.dtype.kind == "V" else t.to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a)).to(like.dtype)
        return t.to(like.device)
    return a


class CheckpointCorrupt(RuntimeError):
    """A checkpoint failed content verification (CRC mismatch, torn or
    unreadable shard).  ``restore`` raises it only when NO retained
    checkpoint at or below the requested step verifies."""


class Checkpointer:
    def __init__(self, directory: str | Path, keep: int = 3, dist=None) -> None:
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        #: the DistContext whose data-parallel shards a state holds
        self.dist = dist
        self._pending: Optional[threading.Thread] = None
        #: every integrity fallback restore took: the rejected step, the
        #: reason, and the step restored instead
        self.integrity_events: list[dict] = []
        self.last_save: dict = {}
        self.last_restore: dict = {}

    # -- ranks --------------------------------------------------------------
    def _dp(self) -> tuple[int, int, Any]:
        """(data-parallel size, this rank's index, the dp process group)."""
        d = self.dist
        if d is None or d.dp_size == 1:
            return 1, 0, None
        info = d.abi.comms.info(d.dp_comm, allow_revoked=True)
        return d.dp_size, d.abi.comm_rank(d.dp_comm), info.group

    def _writer(self) -> bool:
        d = self.dist
        return d is None or d.abi.comm_rank(PAX_COMM_WORLD) == 0

    def _global(self, x, split: bool):
        """A per-rank shard as the global vector (gathered in rank order)."""
        dp, _, group = self._dp()
        if not split or dp == 1:
            return x
        t = x.detach().contiguous()
        out = torch.empty((dp * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        tdist.all_gather_into_tensor(out, t, group=group)
        return out

    # -- save --------------------------------------------------------------
    def _snapshot(self, state) -> tuple:
        """Every rank takes part in the gathers; only the writer copies the
        global state to the host."""
        t0 = time.perf_counter()
        leaves, treedef = _flatten(state)
        writer = self._writer()
        host = []
        for name, v, split in leaves:
            g = self._global(v, split)
            host.append((name, _to_host(g) if writer else None))
        ms = (time.perf_counter() - t0) * 1e3
        return host, treedef, ms

    def save(self, step: int, state) -> Optional[Path]:
        self.wait()
        host, treedef, ms = self._snapshot(state)
        out = self._write(step, host, treedef, ms) if self._writer() else None
        self.wait()
        return out

    def save_async(self, step: int, state) -> None:
        """Snapshot to host memory synchronously, write in the background."""
        self.wait()
        host, treedef, ms = self._snapshot(state)
        if self._writer():
            self._pending = threading.Thread(
                target=self._write, args=(step, host, treedef, ms), daemon=True)
            self._pending.start()

    def wait(self) -> None:
        """Join a background write, then meet the other ranks (if any)."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        d = self.dist
        if d is not None and d.abi.comm_size(PAX_COMM_WORLD) > 1:
            tdist.barrier(group=d.abi.comms.info(PAX_COMM_WORLD).group)

    def _write(self, step: int, host: list, treedef: str, copy_ms: float) -> Path:
        t0 = time.perf_counter()
        final = self.dir / f"step_{step:010d}"
        tmp = self.dir / f".tmp_step_{step:010d}_{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "shard_0.npz", **{f"leaf_{i}": v for i, (_, v) in enumerate(host)})
        t1 = time.perf_counter()
        crc = _file_crc32(tmp / "shard_0.npz")
        t2 = time.perf_counter()
        manifest = {
            "step": step,
            "n_leaves": len(host),
            "names": [n for n, _ in host],
            "treedef": f"PyTreeDef({treedef})",
            "time": time.time(),
            "shard_crc32": {"shard_0.npz": crc},
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic publish
        self._gc()
        self.last_save = {"step": step, "bytes": (final / "shard_0.npz").stat().st_size,
                          "host_copy_ms": copy_ms, "write_ms": (t1 - t0) * 1e3,
                          "crc_ms": (t2 - t1) * 1e3}
        return final

    # -- restore -------------------------------------------------------------
    def _retained_steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                      if p.is_dir())

    def latest_step(self) -> Optional[int]:
        steps = self._retained_steps()
        return steps[-1] if steps else None

    def _verify(self, path: Path) -> Optional[str]:
        """``None`` when every shard matches its manifest CRC, else why not."""
        try:
            manifest = json.loads((path / "manifest.json").read_text())
        except (OSError, ValueError) as e:
            return f"unreadable manifest ({e})"
        for shard, want in manifest.get("shard_crc32", {}).items():
            f = path / shard
            if not f.exists():
                return f"missing shard {shard}"
            got = _file_crc32(f)
            if got != want:
                return (f"shard {shard} CRC mismatch "
                        f"(manifest {want:#010x}, file {got:#010x})")
        return None

    def restore(self, like, step: Optional[int] = None):
        """Restore into the structure of ``like`` (the port's state, or any
        tree of tensors and arrays); returns ``(state, step)``.  Tensors come
        back as new tensors of the skeleton's dtype on its device, except a
        parameter module's, which are copied into ``like``'s module in place.

        Every candidate is CRC-verified before it is read; a corrupt or torn
        one is recorded in ``integrity_events`` and the previous retained
        checkpoint is tried.  Only when none verifies does
        :class:`CheckpointCorrupt` propagate."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        candidates = [s for s in self._retained_steps() if s <= step]
        if not candidates:
            raise FileNotFoundError(f"no checkpoint at or below step {step} under {self.dir}")
        rejected: list[dict] = []
        for s in reversed(candidates):
            t0 = time.perf_counter()
            path = self.dir / f"step_{s:010d}"
            reason = self._verify(path)
            t1 = time.perf_counter()
            if reason is None:
                try:
                    manifest = json.loads((path / "manifest.json").read_text())
                    with np.load(path / "shard_0.npz") as data:
                        arrays = [data[f"leaf_{i}"] for i in range(manifest["n_leaves"])]
                except Exception as e:  # a torn write that still matched its CRC
                    reason = f"unreadable shard ({e})"
            if reason is not None:
                event = {"step": s, "reason": reason, "fell_back_to": None}
                rejected.append(event)
                self.integrity_events.append(event)
                continue
            for event in rejected:
                event["fell_back_to"] = s
            t2 = time.perf_counter()
            restored = self._unflatten(like, manifest["names"], arrays)
            t3 = time.perf_counter()
            self.last_restore = {"step": s, "bytes": (path / "shard_0.npz").stat().st_size,
                                 "crc_ms": (t1 - t0) * 1e3, "load_ms": (t2 - t1) * 1e3,
                                 "copy_ms": (t3 - t2) * 1e3}
            return restored, s
        raise CheckpointCorrupt(
            f"every retained checkpoint at or below step {step} failed verification: "
            f"{rejected}")

    def _gc(self) -> None:
        steps = self._retained_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    def _unflatten(self, like, names: list, arrays: list):
        leaves, _ = _flatten(like)
        want = [n for n, _, _ in leaves]
        if want != list(names):
            raise ValueError(f"checkpoint leaves {list(names)} do not match the state's "
                             f"{want}")
        dp, r, _ = self._dp()
        values = []
        for (name, leaf, split), a in zip(leaves, arrays):
            shape = tuple(getattr(leaf, "shape", np.shape(leaf)))
            if split and shape == (1,) and a.shape[0] != dp:
                # the error-feedback placeholder of an uncompressed wire (one
                # element a rank) carries no state across a change of dp
                values.append(leaf)
                continue
            if split and dp > 1:
                n = shape[0]
                if a.shape[0] != dp * n:
                    raise ValueError(f"{name}: checkpoint length {a.shape[0]} is not "
                                     f"dp={dp} x this state's {n}")
                a = a[r * n:(r + 1) * n]
            if tuple(a.shape) != shape:
                raise ValueError(f"{name}: checkpoint shape {tuple(a.shape)} does not "
                                 f"match the state's {shape}")
            values.append(_from_host(a, leaf))
        return _rebuild(like, iter(values))


@torch.no_grad()
def _rebuild(like, values):
    """``like``'s structure over ``values`` (in flatten order); a parameter
    module takes its values in place."""
    if isinstance(like, nn.Module):
        for _, p, _ in _flatten(like)[0]:
            p.copy_(next(values))
        return like
    if isinstance(like, dict):
        out = {}
        for k in sorted(like):
            out[k] = _rebuild(like[k], values)
        return {k: out[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*[_rebuild(getattr(like, f), values) for f in like._fields])
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, values) for v in like)
    if like is None:
        return None
    return next(values)
