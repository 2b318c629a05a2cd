"""The port's serving tier against the reference's, on the CPU at the smoke
size: the paged decode and chunked prefill against the port's contiguous
decode and against the reference's paged functions on the same weights
(``from_jax_params``), the engine's token streams against the JAX engine's,
the continuous-equals-sequential contract, and the twins of the reference's
engine tests (tiny pool, EOS, deadlines, the decode plan-group count)."""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.models import build_model as j_build
from repro.models import transformer as j_tf
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.kv_cache import BlockAllocator as JBlockAllocator
from repro.serve.kv_cache import block_table_view as j_block_table_view
from repro_torch import configs as tcfgs
from repro_torch.core import CallCounter
from repro_torch.core.errors import PaxError
from repro_torch.launch import bench_serve
from repro_torch.launch import serve as serve_launch
from repro_torch.models import build_model, from_jax_params
from repro_torch.models import transformer as tf
from repro_torch.runtime.dist import make_dist
from repro_torch.serve import BlockAllocator, DecodeSync, Request, ServeEngine, block_table_view

ARCH = "qwen2-0.5b"
#: float32 logits: the reference's own paged-vs-contiguous tolerance
F32_TOL = 2e-5
#: bfloat16 logits (port vs reference): XLA and torch round the products' and
#: sums' intermediates in other orders, each to 8 bits, so the logits agree
#: to a few bf16 roundings of their size: four at |logit| < 1 (2^-6, where
#: the smoke model's logits lie), also as a relative bound
BF16_RTOL = BF16_ATOL = 2.0 ** -6


def _cfgs(dtype: str):
    change = dict(param_dtype=dtype, compute_dtype=dtype)
    return (dataclasses.replace(jcfgs.smoke_config(ARCH), **change),
            dataclasses.replace(tcfgs.smoke_config(ARCH), **change))


def _build(dtype: str):
    """(reference cfg, api, params), (port cfg, api, model) on the same weights."""
    jcfg, tcfg = _cfgs(dtype)
    japi = j_build(jcfg)
    params = japi.init(jax.random.PRNGKey(0))
    tapi = build_model(tcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return (jcfg, japi, params), (tcfg, tapi, model)


@pytest.fixture(scope="module")
def f32():
    return _build("float32")


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request, f32):
    return (request.param, *(f32 if request.param == "float32" else _build(request.param)))


def _np(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close(got, want, dtype, what):
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=F32_TOL, atol=F32_TOL, err_msg=what)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_RTOL, atol=BF16_ATOL,
                                   err_msg=what)


# ---------------------------------------------------------------------------
# model level: paged == contiguous (port), port == reference (both forms)
# ---------------------------------------------------------------------------
S_PROMPT, NEW, BS, CHUNK, W = 11, 4, 4, 4, 8


def _prompt(vocab):
    return np.random.default_rng(0).integers(1, vocab, S_PROMPT).astype(np.int32)


def _chunks(prompt):
    spad = -(-len(prompt) // CHUNK) * CHUNK
    for start in range(0, spad, CHUNK):
        chunk = np.zeros((1, CHUNK), np.int32)
        real = prompt[start:start + CHUNK]
        chunk[0, :len(real)] = real
        yield start, chunk


def _port_paged(tcfg, model, prompt, forced=None):
    """Chunked prefill + block-table decode; greedy unless ``forced`` gives
    the tokens to feed.  Returns (chunk logits, decode logits, tokens)."""
    alloc = BlockAllocator(16, BS)
    pages = tf.init_paged_cache(tcfg, 16, BS, device="cpu")
    table = torch.from_numpy(block_table_view(alloc, alloc.alloc_many(W), W)[None])
    chunk_logits = []
    with torch.no_grad():
        for start, chunk in _chunks(prompt):
            lg, pages = tf.prefill_chunk_paged(model, torch.from_numpy(chunk), pages, table,
                                               start, tcfg)
            chunk_logits.append(lg)
        toks = [int(torch.argmax(chunk_logits[-1][0, (len(prompt) - 1) % CHUNK]))]
        lengths = torch.tensor([len(prompt)], dtype=torch.int32)
        rows = []
        for t in range(NEW):
            cur = forced[t] if forced is not None else toks[-1]
            lg, pages = tf.decode_step_paged(model, torch.tensor([[cur]], dtype=torch.int32),
                                             pages, table, lengths, tcfg)
            lengths = lengths + 1
            rows.append(lg[0])
            toks.append(int(torch.argmax(lg[0])))
    return chunk_logits, rows, toks


def _ref_paged(jcfg, params, prompt, forced):
    alloc = JBlockAllocator(16, BS)
    pages = j_tf.init_paged_cache(jcfg, 16, BS)
    table = jnp.asarray(j_block_table_view(alloc, alloc.alloc_many(W), W)[None])
    chunk_logits = []
    for start, chunk in _chunks(prompt):
        lg, pages = j_tf.prefill_chunk_paged(params, jnp.asarray(chunk), pages, table, start,
                                             jcfg)
        chunk_logits.append(np.asarray(lg.astype(jnp.float32)))
    lengths = jnp.asarray([len(prompt)], jnp.int32)
    rows = []
    for t in range(NEW):
        lg, pages = j_tf.decode_step_paged(params, jnp.asarray([[forced[t]]], jnp.int32), pages,
                                           table, lengths, jcfg)
        lengths = lengths + 1
        rows.append(np.asarray(lg[0].astype(jnp.float32)))
    return chunk_logits, rows


def test_paged_matches_contiguous(f32):
    """The port's paged path against its own contiguous prefill/decode
    (max_seq = the table's capacity, so both masks cover the same keys)."""
    _, (tcfg, _, model) = f32
    prompt = _prompt(tcfg.vocab_size)
    with torch.no_grad():
        lg, cache, idx = tf.prefill(model, torch.from_numpy(prompt)[None], tcfg,
                                    max_seq=W * BS)
        toks_c, rows_c = [int(torch.argmax(lg[0]))], []
        for _ in range(NEW):
            lg, cache = tf.decode_step(model, torch.tensor([[toks_c[-1]]], dtype=torch.int32),
                                       cache, idx, tcfg)
            idx += 1
            rows_c.append(lg[0])
            toks_c.append(int(torch.argmax(lg[0])))
    _, rows_p, toks_p = _port_paged(tcfg, model, prompt)
    assert toks_p == toks_c
    for rc, rp in zip(rows_c, rows_p):
        np.testing.assert_allclose(_np(rp), _np(rc), rtol=F32_TOL, atol=F32_TOL)


def test_paged_matches_reference(pair):
    """Every prefill chunk's logits and every decode step's (fed the port's
    greedy tokens on both sides) against the reference's paged functions."""
    dtype, (jcfg, _, params), (tcfg, _, model) = pair
    prompt = _prompt(tcfg.vocab_size)
    chunks_p, rows_p, toks = _port_paged(tcfg, model, prompt)
    chunks_r, rows_r = _ref_paged(jcfg, params, prompt, toks)
    for i, (a, b) in enumerate(zip(chunks_p, chunks_r)):
        _close(a, b, dtype, f"prefill chunk {i}")
    for i, (a, b) in enumerate(zip(rows_p, rows_r)):
        _close(a, b, dtype, f"decode step {i}")


def test_contiguous_matches_reference(pair):
    """``prefill`` and ``decode_step`` (through ``ModelApi``) against the
    reference's on a batch of two prompts."""
    dtype, (jcfg, japi, params), (tcfg, tapi, model) = pair
    tokens = np.random.default_rng(1).integers(1, tcfg.vocab_size, (2, 7)).astype(np.int32)
    lj, cj, idx = j_tf.prefill(params, jnp.asarray(tokens), jcfg, max_seq=16)
    with torch.no_grad():
        lt, ct, idx_t = tf.prefill(model, torch.from_numpy(tokens), tcfg, max_seq=16)
    assert idx_t == int(idx) and ct.k.shape == tuple(cj.k.shape) and ct.k.dtype == torch.bfloat16
    _close(lt, np.asarray(lj.astype(jnp.float32)), dtype, "prefill logits")
    tok = np.argmax(_np(lt), axis=-1).astype(np.int32)[:, None]
    for step in range(3):
        lj, cj = japi.decode_step(params, jnp.asarray(tok), cj, idx)
        with torch.no_grad():
            lt, ct = tapi.decode_step(model, torch.from_numpy(tok), ct, idx_t)
        _close(lt, np.asarray(lj.astype(jnp.float32)), dtype, f"decode step {step}")
        idx, idx_t = idx + 1, idx_t + 1
        tok = np.argmax(_np(lt), axis=-1).astype(np.int32)[:, None]


def test_api_decode_init_matches_init_cache(f32):
    _, (tcfg, tapi, _) = f32
    cache = tapi.decode_init(3, 24, device="cpu")
    assert cache.k.shape == (tcfg.num_layers, 3, 24, tcfg.num_kv_heads, tcfg.resolved_head_dim)
    assert cache.v.dtype == torch.bfloat16 and not cache.k.any()


# ---------------------------------------------------------------------------
# engine level
# ---------------------------------------------------------------------------
_SPECS = [
    # (prompt_len, max_new, temperature, top_k): mixed lengths and params
    (5, 6, 0.0, 0), (13, 4, 0.8, 8), (9, 8, 0.0, 0),
    (3, 5, 1.2, 0), (17, 3, 0.0, 0), (7, 7, 0.5, 4),
]


def _mk_requests(R, vocab, seed=7):
    rng = np.random.default_rng(seed)
    return [R(i, rng.integers(1, vocab, n).astype(np.int32), max_new_tokens=mn,
              temperature=t, top_k=k)
            for i, (n, mn, t, k) in enumerate(_SPECS)]


def _paged_engine(api, model, **kw):
    kw.setdefault("max_batch", 3)
    kw.setdefault("max_seq", 64)
    kw.setdefault("block_size", 4)
    kw.setdefault("prefill_chunk", 4)
    return ServeEngine(api, model, **kw)


def test_engine_streams_equal_reference(f32):
    """float32 weights: the port's greedy and sampled streams equal the JAX
    engine's, token for token, with the same stats."""
    (jcfg, japi, params), (tcfg, tapi, model) = f32
    kw = dict(max_batch=3, max_seq=64, block_size=4, prefill_chunk=4)
    jeng = JServeEngine(japi, params, **kw)
    jreqs = _mk_requests(JRequest, jcfg.vocab_size)
    jeng.run(jreqs)
    teng = _paged_engine(tapi, model)
    treqs = _mk_requests(Request, tcfg.vocab_size)
    teng.run(treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert teng.stats == jeng.stats


def test_continuous_equals_oracle(f32):
    _, (tcfg, tapi, model) = f32
    eng = _paged_engine(tapi, model)
    reqs = _mk_requests(Request, tcfg.vocab_size)
    eng.run(reqs)
    continuous = [list(r.out_tokens) for r in reqs]
    assert eng.alloc.live_blocks == 0
    oracle = []
    for r in _mk_requests(Request, tcfg.vocab_size):
        eng.run([r])
        oracle.append(list(r.out_tokens))
    assert continuous == oracle


def test_sampling_is_batch_composition_independent(f32):
    _, (_, tapi, model) = f32
    prompt = np.arange(1, 9, dtype=np.int32)
    probe = lambda: Request(3, prompt, max_new_tokens=5, temperature=0.9, top_k=8)  # noqa: E731
    r_solo = probe()
    _paged_engine(tapi, model).run([r_solo])
    r_crowded = probe()
    noise = [Request(i, np.arange(1, 5 + i, dtype=np.int32), max_new_tokens=6,
                     temperature=1.5) for i in range(3)]
    _paged_engine(tapi, model).run(noise + [r_crowded])
    assert r_solo.out_tokens == r_crowded.out_tokens
    r_seeded = probe()
    _paged_engine(tapi, model, seed=123).run([r_seeded])
    assert r_seeded.out_tokens != r_solo.out_tokens


def test_tiny_pool_serializes_but_completes(f32):
    _, (_, tapi, model) = f32
    eng = _paged_engine(tapi, model, max_batch=3, num_blocks=5, max_seq=16)
    reqs = [Request(i, np.arange(1 + i, 9 + i, dtype=np.int32), max_new_tokens=4)
            for i in range(3)]
    for r in reqs:
        eng.submit(r)
    peak = 0
    while eng.has_work:
        eng.step()
        peak = max(peak, eng.scheduler.active)
    assert peak == 1
    assert all(len(r.out_tokens) == 4 for r in reqs)
    assert eng.alloc.live_blocks == 0


def test_eos_frees_slot_early(f32):
    _, (_, tapi, model) = f32
    probe = Request(0, np.arange(1, 7, dtype=np.int32), max_new_tokens=30)
    _paged_engine(tapi, model).run([probe])
    eos = probe.out_tokens[2]
    eng2 = _paged_engine(tapi, model, eos_id=eos)
    r = Request(0, np.arange(1, 7, dtype=np.int32), max_new_tokens=30)
    eng2.run([r])
    stop = probe.out_tokens.index(eos) + 1
    assert r.out_tokens == probe.out_tokens[:stop]
    assert r.out_tokens[-1] == eos and len(r.out_tokens) < 30
    assert eng2.alloc.live_blocks == 0


def test_deadline_expiry_engine_level(f32):
    _, (tcfg, tapi, model) = f32
    rng = np.random.default_rng(3)
    keep_prompt = rng.integers(1, tcfg.vocab_size, 5).astype(np.int32)
    eng = _paged_engine(tapi, model)
    keep = Request(0, keep_prompt, max_new_tokens=6)
    doomed = Request(1, rng.integers(1, tcfg.vocab_size, 5).astype(np.int32),
                     max_new_tokens=20, deadline_steps=8)
    stillborn = Request(2, rng.integers(1, tcfg.vocab_size, 5).astype(np.int32),
                        max_new_tokens=20, deadline_steps=0)
    eng.run([keep, doomed, stillborn])
    assert doomed.expired and doomed.done
    assert 0 < len(doomed.out_tokens) < 20
    assert stillborn.expired and stillborn.out_tokens == []
    assert not keep.expired and len(keep.out_tokens) == 6
    assert eng.stats["expired"] == 2
    assert eng.alloc.live_blocks == 0
    solo = Request(0, keep_prompt.copy(), max_new_tokens=6)
    _paged_engine(tapi, model).run([solo])
    assert keep.out_tokens == solo.out_tokens


def test_no_deadline_never_expires(f32):
    _, (_, tapi, model) = f32
    eng = _paged_engine(tapi, model)
    reqs = [Request(i, np.arange(1, 6 + i, dtype=np.int32), max_new_tokens=3)
            for i in range(2)]
    eng.run(reqs)
    assert eng.stats["expired"] == 0 and eng.last_expired == []
    assert all(not r.expired and len(r.out_tokens) == 3 for r in reqs)


def test_decode_plan_group_counts(f32):
    """One ``decode-tp`` group start/wait per decode step, nothing pooled;
    the pooled ``ibcast`` path gives the same payloads."""
    _, (_, tapi, model) = f32
    with make_dist(impl="paxi", device="cpu") as dist:
        cc = CallCounter()
        dist.abi.attach_tool(cc)
        eng = _paged_engine(tapi, model, max_batch=2, dist=dist)
        reqs = [Request(0, np.arange(1, 6, dtype=np.int32), max_new_tokens=4),
                Request(1, np.arange(2, 9, dtype=np.int32), max_new_tokens=3)]
        eng.run(reqs)
        assert cc.counts.get(DecodeSync.NAME) == eng.stats["decode_steps"] > 0
        assert "bcast" not in cc.counts and "ibcast" not in cc.counts
        ds = eng.decode_sync
        tok = np.array([7, 9], np.int32)
        act = np.array([1, 0], np.int32)
        gt, ga = ds.step(tok, act)
        pt, pa = ds.step_pooled(tok, act)
        assert (gt == pt).all() and (ga == pa).all() and (gt == tok).all()
        assert cc.counts["bcast"] == 2
        ds.group.start(ds._payloads(tok, act))   # a start whose wait never came
        with pytest.raises(PaxError):
            ds.step(tok, act)
        ds.reset()                               # the aborted start is cleared
        assert (ds.step(tok, act)[0] == tok).all()
        ds.free()
        assert dist.abi.outstanding_requests == 0


def test_decode_sync_refuses_a_wait_timeout(f32, mesh1):
    """The wait timeout is the reference's: ``DecodeSync(wait_timeout_s=...)``
    is accepted, and a dropped decode broadcast raises ``PAX_ERR_TIMEOUT``
    after at least the deadline in both packages, instead of hanging (the
    name is the earlier slice's, when the parameter was refused)."""
    import time

    import repro.core as R
    from repro.core.backends.faulty import FaultSchedule as RSchedule
    from repro.core.backends.faulty import FaultyBackend as RFaulty
    from repro.serve.engine import DecodeSync as JDecodeSync
    from repro_torch.core import get_backend, pax_init
    from repro_torch.core.backends.faulty import FaultSchedule, FaultyBackend
    from repro_torch.core.errors import PAX_ERR_TIMEOUT

    _, (_, tapi, model) = f32
    tok, act = np.arange(2, dtype=np.int32), np.ones(2, np.int32)
    codes = []
    rs = RSchedule()
    rabi = R.pax_init(mesh1, impl=RFaulty(R.get_backend("paxi", mesh1), rs))
    rsync = JDecodeSync(rabi, rabi.comm_from_axes(("model",), "tp"), 2, mesh1,
                        wait_timeout_s=0.05)
    assert (rsync.step(tok, act)[0] == tok).all()
    rs.arm(0, after=0, mode="drop")
    t0 = time.perf_counter()
    with pytest.raises(Exception) as ei:
        rsync.step(tok, act)
    codes.append((ei.value.code, time.perf_counter() - t0 >= 0.05))
    with make_dist(impl="paxi", device="cpu") as dist:
        ts = FaultSchedule()
        tabi = pax_init(dist.mesh, impl=FaultyBackend(get_backend("paxi", dist.mesh), ts))
        dist.extra_contexts.append(tabi)
        tsync = DecodeSync(tabi, tabi.comm_from_axes(("model",), "tp"), 2, "cpu",
                           wait_timeout_s=0.05)
        assert tsync.wait_timeout_s == 0.05 and (tsync.step(tok, act)[0] == tok).all()
        ts.arm(0, after=0, mode="drop")
        t0 = time.perf_counter()
        with pytest.raises(PaxError) as ei:
            tsync.step(tok, act)
        codes.append((ei.value.code, time.perf_counter() - t0 >= 0.05))
        tsync.reset()
        ts.kill_rank, ts.dropping = -1, False
        assert (tsync.step(tok, act)[0] == tok).all()
        tsync.free()
        assert codes == [(PAX_ERR_TIMEOUT, True)] * 2
        eng = _paged_engine(tapi, model, max_batch=2, dist=dist)
        eng.decode_sync.free()
        eng.rebuild_decode_sync(dist.abi, dist.tp_comm)
        r = Request(0, np.arange(1, 6, dtype=np.int32), max_new_tokens=3)
        eng.run([r])
        assert len(r.out_tokens) == 3


def test_engine_keeps_pages_on_the_model_device(f32):
    _, (tcfg, tapi, model) = f32
    eng = _paged_engine(tapi, model, max_batch=2, max_seq=20)
    assert eng._pages.k.device == eng.device == torch.device("cpu")
    assert eng._pages.k.shape == (tcfg.num_layers, 2 * 5 + 1, 4, tcfg.num_kv_heads,
                                  tcfg.resolved_head_dim)


def test_run_on_a_recurrent_family_raises():
    """The name is the earlier slice's, when ``run`` raised for the ssm and
    hybrid families.  Now ``run`` serves them statically (no pages, no
    scheduler: tests/test_torch_ssm_decode.py holds the streams to the JAX
    engine's), and ``submit`` still raises, as the reference's does."""
    cfg = tcfgs.smoke_config("rwkv6-7b")
    api = build_model(cfg)
    eng = ServeEngine(api, api.init(0, device="cpu"), max_batch=2, max_seq=32)
    assert not eng.paged and not eng.has_work
    reqs = [Request(0, np.arange(1, 6, dtype=np.int32), max_new_tokens=2),
            Request(1, np.arange(1, 3, dtype=np.int32), max_new_tokens=3)]
    eng.run(reqs)
    assert [len(r.out_tokens) for r in reqs] == [2, 3] and all(r.done for r in reqs)
    assert eng.stats["prefill_tokens"] == 2 * 5 and eng.stats["decode_steps"] == 2
    with pytest.raises(NotImplementedError):
        eng.submit(Request(0, np.arange(1, 6, dtype=np.int32)))


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------
def test_launch_serve_smoke_cpu(capsys):
    reqs = serve_launch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "3",
                              "--prompt-len", "9", "--new-tokens", "5"])
    assert len(reqs) == 3 and all(len(r.out_tokens) == 5 and r.done for r in reqs)
    out = capsys.readouterr().out
    assert "tok/s" in out and "kv pool: 0 live" in out and "req1:" in out


def test_bench_serve_smoke_cpu():
    recs = bench_serve.main(["--smoke", "--device", "cpu", "--requests", "6",
                             "--new-tokens", "3"])
    by = {r["name"]: r["value"] for r in recs}
    assert by["serve_requests"] == 6
    assert by["serve_tokens_per_s"] > 0 and 0 < by["serve_p50_ms"] <= by["serve_p99_ms"]


@pytest.mark.parametrize("max_batch, chunk, prompts, new, want", [
    # one prefill chunk a step binds: E[ceil(U{64..512} / 32)] = (2 + 32 * 133) / 449
    (8, 32, (64, 513), 64, (2 + 32 * 133) / 449),
    # two slots held for 2 + 64 steps each bind: one request per 33 steps
    (2, 8, (16, 17), 64, 33.0),
])
def test_bench_serve_capacity_gap(max_batch, chunk, prompts, new, want):
    eng = SimpleNamespace(max_batch=max_batch, prefill_chunk=chunk)
    got = bench_serve.capacity_gap(eng, prompt_range=prompts, new_tokens=new)
    assert got == pytest.approx(want, rel=1e-12)
