"""Serving engine: continuous batching over a paged KV cache, with the
decode step's tensor-parallel sync driven by ONE persistent plan group per
token step (the port of the reference's ``serve/engine.py``).

* **paged KV** — one preallocated block slab
  (:func:`~repro_torch.models.transformer.init_paged_cache`) on the model's
  device, written in place; blocks are owned per request through
  :class:`~.kv_cache.BlockAllocator` handles, and attention reads through
  per-request block tables
  (:func:`~repro_torch.models.transformer.decode_step_paged`).
* **continuous batching** — :class:`~.scheduler.Scheduler` admits and
  evicts at step granularity; each engine step runs at most one B=1
  prefill *chunk* plus one full-width decode step.
* **fixed decode shape** — decode always runs all ``max_batch`` rows;
  inactive rows carry token 0, length 0 and an all-null block table (their
  writes land in the reserved null block).  Each row's arithmetic then does
  not depend on which other requests share the batch, so continuous
  batching is **token-identical to serving one request at a time**.  The
  rows are never compacted: a different batch shape may take a different
  matrix-product algorithm, and with it different roundings.  The moe
  family is the exception, in the reference too: once an expert's capacity
  binds, which assignments drop depends on the other rows of the step
  (the inactive rows' token 0 included), so a stream depends on its batch.
* **per-request random stream** — a sampled token's key is
  ``fold_in(fold_in(PRNGKey(seed), rid), step)``, computed on the host
  (:mod:`.sampling`), equal to the reference's.
* **decode plan group** — the sampled tokens and the active mask are
  broadcast from tensor-parallel rank 0 by two persistent ``bcast_init``
  plans fused into one ``plan_group("decode-tp")`` built at engine init;
  every token step is one ``start()``/``wait()``, so a ``CallCounter``
  attached with ``attach_tool`` counts one ``decode-tp`` call per decode
  step.

The transport tier rides the decode sync as in the reference:
``DecodeSync(wait_timeout_s=...)`` bounds its group and pooled waits (a
dropped broadcast raises ``PAX_ERR_TIMEOUT`` instead of hanging),
:meth:`DecodeSync.step` holds the synced tokens and mask to the integrity
verdict (``verify_clean``), and :meth:`DecodeSync.reset` aborts a
timed-out start; ``serve/supervisor.py`` retries, escalates and recovers.

The dense and moe families are paged; the moe family's steps route
through ``moe_block`` with the engine's ``dist``.  The ssm and hybrid
families keep no KV pages (their decode state is
recurrent), and the reference pages no other family, so
:meth:`ServeEngine.run` serves them and the vlm (text only, on the
transformer's contiguous cache) as the reference does, by static
batching (:meth:`ServeEngine._run_static`): the prompts left-padded with
token 0 to one length, fed one position a step through
``decode_step`` (model step ``"prefill"``), then decoded in rounds (model
step ``"decode"``) until every request is done; ``submit``/``step`` are the
paged path's only.  Left padding runs the pad tokens through the recurrent
state, in the reference too, so a request's tokens depend on the batch it
is served in.  The encdec family has no ``decode_init`` (its cache needs
the frames), and ``run`` refuses it with a ``ValueError``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..models import transformer
from .kv_cache import BlockAllocator
from .sampling import request_key, sample
from .scheduler import DECODE, Scheduler


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0
    top_k: int = 0
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    #: engine steps from submission before the request is abandoned
    #: (None: no deadline); measured against ``stats["steps"]``
    deadline_steps: Optional[int] = None
    submit_step: Optional[int] = None  # stamped by ServeEngine.submit
    retries: int = 0                   # replay count (supervisor recovery)
    expired: bool = False              # deadline passed; done, no more tokens
    failed: bool = False               # dropped after max_retries replays


class DecodeSync:
    """The per-token decode sync as one persistent plan group.

    Sampling happens on the tensor-parallel root; the sampled token vector
    and the active-row mask are broadcast to the other tp ranks so every
    rank feeds the same tokens into the next step (at tp=1 the broadcast
    is the identity, but the group still runs and is counted).  Both
    broadcasts are built ONCE as persistent plans fused into the group
    ``"decode-tp"``; :meth:`step` is one ``start()``/``wait()``.
    :meth:`step_pooled` runs the same two broadcasts as pooled ``ibcast``
    requests and one ``waitall``, the reference the group is held to.

    ``wait_timeout_s`` bounds the group and pooled waits: None blocks for
    good on a dropped broadcast (the faithful hang); a bound turns the drop
    into ``PAX_ERR_TIMEOUT``, which the serving supervisor retries and
    escalates.  It is read per call, so a change applies to the next step.
    """

    NAME = "decode-tp"

    def __init__(self, abi, comm: int, max_batch: int, device=None, *,
                 wait_timeout_s: Optional[float] = None) -> None:
        self.wait_timeout_s = wait_timeout_s
        self.abi = abi
        self.comm = comm
        self.device = torch.device(device) if device is not None else abi.mesh.device
        ex = torch.empty((max_batch,), dtype=torch.int32)
        self._p_tok = abi.bcast_init(ex, 0, comm)
        self._p_act = abi.bcast_init(ex, 0, comm)
        self.group = abi.plan_group([self._p_tok, self._p_act], name=self.NAME)

    def _payloads(self, tokens: np.ndarray, active: np.ndarray) -> list:
        return [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(self.device)
                for a in (tokens, active)]

    def reset(self) -> None:
        """Abort a start whose wait timed out (the post-timeout contract):
        force the group and its member plans inactive."""
        self.group.reset()
        self._p_tok.reset()
        self._p_act.reset()

    def step(self, tokens: np.ndarray, active: np.ndarray) -> tuple:
        """ONE group start/wait for the whole token step; a corruption the
        envelope folded into the payload raises here (integrity on)."""
        tok, act = self.abi.wait(self.group.start(self._payloads(tokens, active)),
                                 timeout_s=self.wait_timeout_s)
        tok, act = tok.cpu().numpy(), act.cpu().numpy()
        self.abi.verify_clean((tok, act), "decode-tp sync")
        return tok, act

    def step_pooled(self, tokens: np.ndarray, active: np.ndarray) -> tuple:
        """The pooled ``ibcast`` reference path (two requests, one waitall)."""
        tok, act = self._payloads(tokens, active)
        tok, act = self.abi.waitall([self.abi.ibcast(tok, 0, self.comm),
                                     self.abi.ibcast(act, 0, self.comm)],
                                    timeout_s=self.wait_timeout_s)
        tok, act = tok.cpu().numpy(), act.cpu().numpy()
        self.abi.verify_clean((tok, act), "decode-tp pooled sync")
        return tok, act

    def free(self) -> None:
        self.group.free()
        self._p_tok.free()
        self._p_act.free()


class ServeEngine:
    """Continuous-batching engine over ``max_batch`` decode slots; ``params``
    is the model module (``api.init(...)``), whose device the engine's
    pages share."""

    def __init__(self, api, params, *, max_batch: int = 4, max_seq: int = 512,
                 dist=None, eos_id: Optional[int] = None,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 prefill_chunk: int = 32, seed: int = 0) -> None:
        self.api = api
        self.cfg = cfg = api.cfg
        self.params = params
        self.dist = dist
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.seed = seed
        self.device = next(params.parameters()).device
        self.stats = {"prefill_tokens": 0, "decode_steps": 0,
                      "prefill_chunks": 0, "requests": 0, "steps": 0,
                      "expired": 0}
        self.last_expired: list = []   # requests expired by the last step()
        self.paged = cfg.family in ("dense", "moe")
        self.decode_sync: Optional[DecodeSync] = None
        #: if set, every model step runs as ``step_hook(kind, fn, *args)``
        #: and must return ``fn(*args)``: the seam where a caller times or
        #: records the steps (see :meth:`model_step`)
        self.step_hook: Optional[Callable] = None
        if not self.paged:
            # one position of every sequence a step, the state written in place
            decode = lambda tok, state, index: api.decode_step(params, tok, state, index)[0]  # noqa: E731
            self._steps = {"prefill": decode, "decode": decode}
            return
        width = -(-max_seq // block_size)
        if num_blocks is None:
            num_blocks = max_batch * width + 1   # +1: reserved null block
        self.block_size = block_size
        self.prefill_chunk = prefill_chunk
        self.alloc = BlockAllocator(num_blocks, block_size)
        self.scheduler = Scheduler(self.alloc, max_batch=max_batch,
                                   prefill_chunk=prefill_chunk, table_width=width)
        self._pages = transformer.init_paged_cache(cfg, num_blocks, block_size,
                                                   device=self.device)
        self._steps = {
            "prefill": lambda toks, table, start: transformer.prefill_chunk_paged(
                params, toks, self._pages, table, start, cfg, dist)[0],
            "decode": lambda tok, tables, lengths: transformer.decode_step_paged(
                params, tok, self._pages, tables, lengths, cfg, dist)[0]}
        if dist is not None:
            self.decode_sync = DecodeSync(dist.abi, dist.tp_comm, max_batch, dist.device)

    def model_step(self, kind: str, *args) -> torch.Tensor:
        """One of the serving loop's two model steps, at fixed shapes, on
        device tensors: ``"prefill"`` (tokens (1, chunk), table (1, W),
        start) -> logits (1, chunk, vocab), or ``"decode"`` (tokens
        (max_batch, 1), tables (max_batch, W), lengths (max_batch,)) ->
        logits (max_batch, vocab).  Both write the pages in place.  On the
        static path (ssm, hybrid, vlm) both are one ``decode_step`` (tokens
        (B, 1), the decode state, the position) -> logits (B, vocab),
        writing the state in place."""
        fn = self._steps[kind]
        return fn(*args) if self.step_hook is None else self.step_hook(kind, fn, *args)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # -- sampling (per request, batch-composition-independent) --------------
    def _sample_one(self, row_logits: np.ndarray, req: Request) -> int:
        """Greedy ``argmax`` at temperature <= 0; otherwise the draw keyed
        by (engine seed, rid, step), in the logits' dtype."""
        key = None if req.temperature <= 0.0 else request_key(
            self.seed, req.rid, len(req.out_tokens))
        return sample(row_logits, key, float(req.temperature), int(req.top_k),
                      self.cfg.compute_dtype)

    def _append(self, req: Request, tok: int) -> None:
        req.out_tokens.append(tok)
        if self.eos_id is not None and tok == self.eos_id:
            req.done = True
        if len(req.out_tokens) >= req.max_new_tokens:
            req.done = True

    # -- public API ---------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Queue a request (admitted by the next :meth:`step` with a free
        slot and enough KV blocks)."""
        if not self.paged:
            raise NotImplementedError(
                f"submit/step serving requires a paged family, not {self.cfg.family}")
        if len(req.prompt) == 0:
            raise ValueError(f"request {req.rid}: empty prompt")
        if req.submit_step is None:
            req.submit_step = self.stats["steps"]  # deadline clock starts now
        self.scheduler.submit(req)
        self.stats["requests"] += 1

    def rebuild_decode_sync(self, abi, comm: int, device=None,
                            wait_timeout_s: Optional[float] = None) -> None:
        """Bind a fresh :class:`DecodeSync` on ``comm`` (after a tp-comm
        rebuild); the old one must already be freed."""
        self.decode_sync = DecodeSync(abi, comm, self.max_batch, device,
                                      wait_timeout_s=wait_timeout_s)

    @property
    def has_work(self) -> bool:
        return self.paged and self.scheduler.has_work

    def generate(self, prompt: np.ndarray, *, max_new_tokens: int = 32,
                 temperature: float = 0.0, top_k: int = 0) -> np.ndarray:
        reqs = [Request(0, prompt, max_new_tokens, temperature, top_k)]
        self.run(reqs)
        return np.asarray(reqs[0].out_tokens, np.int32)

    def run(self, requests: list[Request]) -> None:
        """Serve a closed batch to completion: continuously batched on the
        paged path, statically batched for the ssm, hybrid and vlm families
        (the vlm text only, as in the reference).  The encdec family raises
        ``ValueError``: its cache needs the encoder's frames
        (``encdec.init_cache``), which a request does not carry (the
        reference fails there too, on its ``decode_init=None``)."""
        if self.api.decode_init is None:
            raise ValueError(f"{self.cfg.family} ({self.cfg.name}) has no decode_init: its "
                             f"cache needs the encoder's frames, so build it with "
                             f"encdec.init_cache and decode with decode_step")
        if not self.paged:
            self.stats["requests"] += len(requests)
            with torch.no_grad():
                self._run_static(requests)
            return
        for r in requests:
            self.submit(r)
        self.drain()

    def drain(self) -> None:
        """Step until the queue and every slot are empty."""
        while self.has_work:
            self.step()

    # -- the engine step -----------------------------------------------------
    def step(self) -> None:
        """One serving step: expire, admit waiting requests into free slots,
        run at most one prefill chunk, then one decode step for every
        decoding slot (ending in one ``decode-tp`` group start/wait)."""
        sched = self.scheduler
        self.stats["steps"] += 1
        # deadlines first: an expired request frees its blocks before
        # admission, so its capacity funds the queue head this very step
        self.last_expired = sched.expire(self.stats["steps"])
        self.stats["expired"] += len(self.last_expired)
        sched.admit()
        with torch.no_grad():
            i = sched.prefill_slot()
            if i is not None:
                self._prefill_step(i)
            dslots = sched.decode_slots()
            if dslots:
                self._decode_step(dslots)

    def _prefill_step(self, i: int) -> None:
        """Feed the next B=1 prompt chunk of slot ``i`` into its KV blocks;
        on the final chunk, sample the request's first token."""
        seq = self.scheduler.slots[i]
        req, C = seq.req, self.prefill_chunk
        start = seq.fed
        real = np.asarray(req.prompt[start:start + C], np.int32)
        chunk = np.zeros((1, C), np.int32)
        chunk[0, :len(real)] = real
        logits = self.model_step("prefill", self._to_device(chunk),
                                 self._to_device(seq.table[None]), start)
        seq.fed = start + C
        self.stats["prefill_tokens"] += int(len(real))
        self.stats["prefill_chunks"] += 1
        if seq.prefill_done:
            last = (seq.prompt_len - 1) - start    # last real row of the chunk
            tok = self._sample_one(logits[0, last].cpu().float().numpy(), req)
            self._append(req, tok)
            if req.done:
                self.scheduler.finish(i)
            else:
                seq.state = DECODE

    def _decode_step(self, dslots: list[int]) -> None:
        """One full-width decode step.  Inactive rows run too (fixed shape)
        with length 0 and an all-null table: their writes land in the null
        block and their logits are dropped."""
        sched = self.scheduler
        B = self.max_batch
        toks = np.zeros((B, 1), np.int32)
        lengths = np.zeros((B,), np.int32)
        tables = np.zeros((B, sched.table_width), np.int32)  # NULL_BLOCK rows
        for i in dslots:
            seq = sched.slots[i]
            toks[i, 0] = seq.req.out_tokens[-1]
            lengths[i] = seq.prompt_len + len(seq.req.out_tokens) - 1
            tables[i] = seq.table
        logits = self.model_step("decode", self._to_device(toks), self._to_device(tables),
                                 self._to_device(lengths))
        self.stats["decode_steps"] += 1
        logits_np = logits.cpu().float().numpy()   # the one copy to the host per step
        sampled = np.zeros((B,), np.int32)
        active = np.zeros((B,), np.int32)
        for i in dslots:
            sampled[i] = self._sample_one(logits_np[i], sched.slots[i].req)
            active[i] = 1
        if self.decode_sync is not None:
            sampled, active = self.decode_sync.step(sampled, active)
        for i in dslots:
            seq = sched.slots[i]
            self._append(seq.req, int(sampled[i]))
            if seq.req.done:
                sched.finish(i)

    # -- static batching (ssm, hybrid, vlm: no KV pages) ---------------------
    def _run_static(self, requests: list[Request]) -> None:
        """Left-pad the prompts to one length, feed them one position a step,
        then decode in rounds until every request is done (the reference's
        ``_run_static``: the same stats, the same per-request streams)."""
        B = len(requests)
        S = max(len(r.prompt) for r in requests)
        tokens = np.zeros((B, S), np.int32)
        for i, r in enumerate(requests):
            tokens[i, S - len(r.prompt):] = r.prompt  # left-pad
        tokens = self._to_device(tokens)
        state = self.api.decode_init(B, self.max_seq, device=self.device)
        logits = None
        for t in range(S):
            logits = self.model_step("prefill", tokens[:, t:t + 1], state, t)
        self.stats["prefill_tokens"] += B * S
        cur = self._sample_rows(logits, requests)
        self._append_live(cur, requests)
        index = S
        for _ in range(1, max(r.max_new_tokens for r in requests)):
            if all(r.done for r in requests):
                break
            logits = self.model_step("decode", self._to_device(cur[:, None]), state, index)
            index += 1
            self.stats["decode_steps"] += 1
            cur = self._sample_rows(logits, requests)
            self._append_live(cur, requests)

    def _sample_rows(self, logits: torch.Tensor, requests: list[Request]) -> np.ndarray:
        logits_np = logits.cpu().float().numpy()   # the one copy to the host per step
        return np.asarray([self._sample_one(logits_np[i], r)
                           for i, r in enumerate(requests)], np.int32)

    def _append_live(self, cur: np.ndarray, requests: list[Request]) -> None:
        for i, r in enumerate(requests):
            if not r.done:
                self._append(r, int(cur[i]))
