"""Sharded data pipeline: per-host token streams with background prefetch.

Production shape: each host reads only its shard of the global batch
(``host_shard``), a background thread keeps a bounded prefetch queue ahead
of the training loop (straggler absorption), and documents are packed into
fixed-length sequences with -1 padding targets (masked in the loss).

Sources: synthetic LM streams (seeded, reproducible) and memory-mapped
token files (.bin of uint16/uint32) read from a path the caller gives.
"""
from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np


class TokenSource:
    """Abstract token-document source."""

    def documents(self, start_doc: int) -> Iterator[np.ndarray]:
        raise NotImplementedError


class SyntheticSource(TokenSource):
    """Reproducible synthetic documents (zipf-ish unigram)."""

    def __init__(self, vocab_size: int, seed: int = 0,
                 mean_len: int = 512) -> None:
        self.vocab = vocab_size
        self.seed = seed
        self.mean_len = mean_len

    def documents(self, start_doc: int) -> Iterator[np.ndarray]:
        i = start_doc
        while True:
            rng = np.random.default_rng((self.seed, i))
            n = int(rng.integers(self.mean_len // 2, self.mean_len * 2))
            ranks = rng.zipf(1.3, size=n).astype(np.int64)
            yield (ranks % self.vocab).astype(np.int32)
            i += 1


class FileSource(TokenSource):
    """Memory-mapped flat token file, split into pseudo-documents of
    ``doc_len`` tokens (the reference's; the stream wraps around the
    file).  Nothing is downloaded: the caller gives the path."""

    def __init__(self, path: str | Path, dtype=np.uint16, doc_len: int = 2048) -> None:
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.doc_len = doc_len

    def documents(self, start_doc: int) -> Iterator[np.ndarray]:
        n_docs = len(self.tokens) // self.doc_len
        i = start_doc
        while True:
            j = i % max(n_docs, 1)
            yield np.asarray(
                self.tokens[j * self.doc_len:(j + 1) * self.doc_len], dtype=np.int32)
            i += 1


def pack_documents(docs: Iterator[np.ndarray], batch: int, seq_len: int,
                   pad_id: int = 0) -> Iterator[dict]:
    """Greedy sequence packing; targets are next-token with -1 on pad."""
    buf = np.full((batch, seq_len + 1), pad_id, np.int32)
    mask = np.zeros((batch, seq_len + 1), bool)
    row, col = 0, 0
    for doc in docs:
        off = 0
        while off < len(doc):
            take = min(seq_len + 1 - col, len(doc) - off)
            buf[row, col:col + take] = doc[off:off + take]
            mask[row, col:col + take] = True
            col += take
            off += take
            if col >= seq_len + 1:
                row += 1
                col = 0
                if row == batch:
                    tokens = buf[:, :-1].copy()
                    targets = np.where(mask[:, 1:], buf[:, 1:], -1).astype(np.int32)
                    yield {"tokens": tokens, "targets": targets}
                    buf[:] = pad_id
                    mask[:] = False
                    row = 0


class DataPipeline:
    """Host-sharded, prefetched batch stream.

    ``host_id``/``num_hosts`` split the GLOBAL batch; each host materializes
    only its rows.  ``prefetch`` bounds the background queue (absorbs input
    stalls — the straggler-mitigation surface at the data layer).
    """

    def __init__(self, source: TokenSource, *, global_batch: int, seq_len: int,
                 host_id: int = 0, num_hosts: int = 1, prefetch: int = 4,
                 start_step: int = 0) -> None:
        assert global_batch % num_hosts == 0
        self.local_batch = global_batch // num_hosts
        self.seq_len = seq_len
        self.host_id = host_id
        self.num_hosts = num_hosts
        # deterministic disjoint document streams per host
        start_doc = start_step * global_batch + host_id * 1_000_000_007
        self._packed = pack_documents(
            source.documents(start_doc), self.local_batch, seq_len)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self) -> None:
        try:
            for batch in self._packed:
                if self._stop.is_set():
                    return
                self._q.put(batch)
        except Exception as e:  # pragma: no cover
            self._q.put(e)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self) -> None:
        self._stop.set()
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass
