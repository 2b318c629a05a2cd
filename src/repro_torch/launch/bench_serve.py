"""Serving benchmark — the port of ``benchmarks/bench_serve.py``: Poisson
open-loop load on the continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.bench_serve --arch qwen2-0.5b --smoke \\
        [--device cpu] [--out BENCH_serve_torch.json]

Request inter-arrival gaps are exponential (Poisson) and indexed in
*engine steps*, so the offered load, and with it the queueing and batching,
is the same on every machine; only the latencies are wall-clock.  Requests
arrive on schedule whether or not the engine keeps up, so overload shows
as queueing delay in the latency tail, never as an out-of-memory error
(the scheduler admits only what the pool can fund).

Records: ``serve_tokens_per_s`` (generated tokens over the loaded phase's
wall time), ``serve_p50_ms`` and ``serve_p99_ms`` (per-request latency,
submission to last token) and ``serve_requests``.  The engine is the
reference benchmark's (4 slots, pages and chunks of 8, weights and workload
from seed 0) with room for the longest prompt and its answer; the load's
defaults are the reference's too: 24 requests, mean gap 2 steps, prompts of
4 to 24 tokens, 8 new tokens.  Runs on the card unless ``--device cpu``;
the engine's model steps end in a copy of the logits to the host, so every
step's wall time holds its device time.

The load is a smoke load, not a model of user traffic: uniform prompt
lengths, one answer length, steady Poisson arrivals.  :func:`capacity_gap`
gives the mean gap at which it meets the engine's admission capacity; below
it p50/p99 measure serving, above it mostly a request's place in the queue.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from .. import configs as cfgs
from ..models import build_model
from ..serve.engine import Request, ServeEngine
from .train import _reference_numerics

#: the reference benchmark's engine (``benchmarks/bench_serve.py``)
MAX_BATCH, BLOCK_SIZE, PREFILL_CHUNK = 4, 8, 8


def make_workload(vocab: int, n: int, rng, *, mean_gap_steps: float, prompt_range: tuple,
                  new_tokens: int) -> list:
    """(arrival step, Request) pairs: Poisson gaps, prompt lengths drawn
    from ``[prompt_range[0], prompt_range[1])``."""
    arrivals, t = [], 0.0
    for i in range(n):
        t += rng.exponential(mean_gap_steps)
        prompt = rng.integers(1, vocab, int(rng.integers(*prompt_range))).astype(np.int32)
        arrivals.append((int(t), Request(i, prompt, max_new_tokens=new_tokens)))
    return arrivals


def capacity_gap(eng: ServeEngine, *, prompt_range: tuple, new_tokens: int) -> float:
    """The mean arrival gap, in engine steps, at which this load meets the
    engine's admission capacity.  A step runs at most one prefill chunk, so
    the engine admits at most one request per ``E[ceil(prompt / chunk)]``
    steps; and each of its ``max_batch`` slots is held for about that many
    steps plus ``new_tokens``.  The larger of the two gaps binds."""
    lens = np.arange(*prompt_range)
    chunks = float(np.mean(-(-lens // eng.prefill_chunk)))
    return max(chunks, (chunks + new_tokens) / eng.max_batch)


def run(eng: ServeEngine, *, requests: int, mean_gap_steps: float, prompt_range: tuple,
        new_tokens: int) -> list:
    """Warm the engine with one request, then drive the open-loop load
    (drawn from ``default_rng(0)``); returns (name, value, unit, note)
    records."""
    eng.run([Request(0, np.arange(1, 10, dtype=np.int32), max_new_tokens=4)])
    arrivals = make_workload(eng.cfg.vocab_size, requests, np.random.default_rng(0),
                             mean_gap_steps=mean_gap_steps, prompt_range=prompt_range,
                             new_tokens=new_tokens)
    decode0, chunks0 = eng.stats["decode_steps"], eng.stats["prefill_chunks"]
    pending = list(arrivals)
    submit_wall: dict[int, float] = {}
    latency_ms: list[float] = []
    step = 0
    t0 = time.perf_counter()
    while pending or eng.has_work:
        now = time.perf_counter()
        while pending and pending[0][0] <= step:
            _, req = pending.pop(0)
            submit_wall[req.rid] = now
            eng.submit(req)
        eng.step()
        done_now = time.perf_counter()
        for _, req in arrivals:
            if req.done and req.rid in submit_wall:
                latency_ms.append((done_now - submit_wall.pop(req.rid)) * 1e3)
        step += 1
    wall = time.perf_counter() - t0

    total_tokens = sum(len(r.out_tokens) for _, r in arrivals)
    if not all(r.done for _, r in arrivals) or len(latency_ms) != len(arrivals):
        raise RuntimeError("the open-loop run ended with requests unserved")
    p50, p99 = np.percentile(latency_ms, [50, 99])
    note = (f"{len(arrivals)} reqs, Poisson gaps ~{mean_gap_steps:g} steps, prompts "
            f"{prompt_range[0]}-{prompt_range[1] - 1}, {new_tokens} new tokens, "
            f"{step} engine steps for arrivals over {arrivals[-1][0]}, "
            f"{eng.stats['decode_steps'] - decode0} decode steps, "
            f"{eng.stats['prefill_chunks'] - chunks0} prefill chunks, on {eng.device}")
    return [
        ("serve_tokens_per_s", total_tokens / wall, "tokens_per_s", note),
        ("serve_p50_ms", float(p50), "ms", "request completion latency, open-loop"),
        ("serve_p99_ms", float(p99), "ms", "request completion latency tail, open-loop"),
        ("serve_requests", float(len(arrivals)), "count", note),
    ]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=cfgs.ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--mean-gap", type=float, default=2.0, help="engine steps")
    ap.add_argument("--prompt-min", type=int, default=4)
    ap.add_argument("--prompt-max", type=int, default=24, help="inclusive")
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--out", default=None, help="write the records as JSON here")
    args = ap.parse_args(argv)

    _reference_numerics()
    cfg = cfgs.smoke_config(args.arch) if args.smoke else cfgs.get_config(args.arch)
    api = build_model(cfg)
    eng = ServeEngine(api, api.init(0, device=args.device), max_batch=MAX_BATCH,
                      max_seq=args.prompt_max + args.new_tokens, block_size=BLOCK_SIZE,
                      prefill_chunk=PREFILL_CHUNK, seed=0)
    records = []
    for name, value, unit, note in run(eng, requests=args.requests,
                                       mean_gap_steps=args.mean_gap,
                                       prompt_range=(args.prompt_min, args.prompt_max + 1),
                                       new_tokens=args.new_tokens):
        records.append({"name": name, "value": float(value), "unit": unit, "note": note,
                        "section": "serve_open_loop"})
        print(f"{name},{value:.4f},{unit},{note}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print(f"# wrote {len(records)} records to {args.out}")
    return records


if __name__ == "__main__":
    main()
