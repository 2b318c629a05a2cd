"""The port's moe family (qwen2-moe's smoke config, float32) against the
reference, on the CPU, on the reference's own weights (``from_jax_params``):

* the forward's logits and summed aux loss, the loss (cross-entropy plus
  aux) and its gradient against ``jax.grad``, at the smoke capacity (4.0:
  nothing drops) and at 0.5, where the capacity binds;
* contiguous and paged prefill and decode at 0.5 (the prefill drops);
* the paged engine's token streams against the reference engine's at
  ``max_batch=8`` and capacity 0.5, with three requests (the inactive
  rows' token 0 routes alike and overflows its experts, so the stable
  sort's drop order is part of the function being compared) and with ten
  (active rows drop as well); with ten, the continuous streams differ
  from the one-at-a-time streams in both packages alike (a moe stream
  depends on its batch once the capacity binds);
* a moe train step at ``model_axis=2`` raises (two gloo ranks);
* qwen2-moe-a2.7b and grok-1-314b at full size: the configs, every
  parameter's name, shape and dtype (the port on the ``meta`` device,
  the reference's ``jax.eval_shape``) and ``analytic_param_count``, with
  nothing allocated.

The ZeRO-1 step is ``tests/test_torch_train_slice.py``'s ``moe_b1_micro2``
case.  Tolerances: logits and loss 2e-5 (the dense family's), gradients
1e-4 (the block's; XLA and torch sum in other orders).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as R_cfgs
from repro.models import build_model as r_build
from repro.models import transformer as j_tf
from repro.models.model import analytic_param_count as r_param_count
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.kv_cache import BlockAllocator as JBlockAllocator
from repro.serve.kv_cache import block_table_view as j_block_table_view
from repro_torch import configs as T_cfgs
from repro_torch.models import build_model as t_build
from repro_torch.models import from_jax_params, param_leaves
from repro_torch.models import transformer as tf
from repro_torch.models.model import _family
from repro_torch.models.model import analytic_param_count as t_param_count
from repro_torch.serve import BlockAllocator, Request, ServeEngine, block_table_view

ARCH = "qwen2-moe-a2.7b"
TOL = 2e-5
GRAD_TOL = 1e-4
BIND = 0.5   # a capacity factor at which the smoke model drops assignments


def _cfgs(factor=None):
    out = []
    for mod in (R_cfgs, T_cfgs):
        cfg = mod.smoke_config(ARCH)
        if factor is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                                   capacity_factor=factor))
        out.append(cfg)
    return out


@functools.lru_cache(maxsize=None)
def _reference_params():
    params = jax.jit(r_build(R_cfgs.smoke_config(ARCH)).init)(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _model(tcfg):
    return from_jax_params(_reference_params(), tcfg, device="cpu")


def _batch():
    tok = np.random.default_rng(3).integers(0, 512, size=(2, 32)).astype(np.int32)
    return {"tokens": tok, "targets": np.roll(tok, -1, axis=1)}


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("factor", [None, BIND])
def test_forward_aux_loss_and_gradient_match_the_reference(factor):
    rcfg, tcfg = _cfgs(factor)
    params = jax.tree.map(jnp.asarray, _reference_params())
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, aux = jax.jit(lambda p, b: r_build(rcfg).forward(p, b))(params, jb)
    loss, grads = jax.jit(jax.value_and_grad(lambda p, b: r_build(rcfg).loss_fn(p, b)))(
        params, jb)
    model = _model(tcfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        tlogits, taux = tf.forward_aux(model, tb["tokens"], tcfg)
        api_logits = t_build(tcfg).forward(model, tb)
    np.testing.assert_allclose(_np(tlogits), np.asarray(logits), atol=TOL, rtol=TOL)
    assert torch.equal(api_logits, tlogits)
    np.testing.assert_allclose(taux.item(), float(aux), atol=1e-6, rtol=1e-6)
    assert float(aux) > 0
    tloss = t_build(tcfg).loss_fn(model, tb)
    np.testing.assert_allclose(tloss.item(), float(loss), atol=TOL, rtol=TOL)
    leaves = param_leaves(model)
    tgrads = torch.autograd.grad(tloss, [p for _, p in leaves])
    flat = {".".join(k.key for k in path): g
            for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]}
    for (name, _), g in zip(leaves, tgrads):
        np.testing.assert_allclose(_np(g), np.asarray(flat[name]), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)


def test_contiguous_prefill_and_decode_match_the_reference():
    rcfg, tcfg = _cfgs(BIND)
    params = jax.tree.map(jnp.asarray, _reference_params())
    model = _model(tcfg)
    tokens = np.random.default_rng(1).integers(1, 512, (2, 11)).astype(np.int32)
    lj, cj, idx = j_tf.prefill(params, jnp.asarray(tokens), rcfg, max_seq=16)
    with torch.no_grad():
        lt, ct, idx_t = tf.prefill(model, torch.from_numpy(tokens), tcfg, max_seq=16)
    np.testing.assert_allclose(_np(lt), np.asarray(lj), atol=TOL, rtol=TOL)
    tok = np.argmax(_np(lt), axis=-1).astype(np.int32)[:, None]
    api = t_build(tcfg)
    for step in range(3):
        lj, cj = j_tf.decode_step(params, jnp.asarray(tok), cj, idx, rcfg)
        with torch.no_grad():
            lt, ct = api.decode_step(model, torch.from_numpy(tok), ct, idx_t)
        np.testing.assert_allclose(_np(lt), np.asarray(lj), atol=TOL, rtol=TOL,
                                   err_msg=f"decode step {step}")
        idx, idx_t = idx + 1, idx_t + 1
        tok = np.argmax(_np(lt), axis=-1).astype(np.int32)[:, None]


BS, CHUNK, W, NEW = 4, 8, 8, 4


def test_paged_prefill_and_decode_match_the_reference():
    """Chunks of 8 positions (16 assignments over 4 experts at capacity 4:
    the chunks drop) and decode steps fed the port's greedy tokens."""
    rcfg, tcfg = _cfgs(BIND)
    params = jax.tree.map(jnp.asarray, _reference_params())
    model = _model(tcfg)
    prompt = np.random.default_rng(0).integers(1, 512, 21).astype(np.int32)
    alloc, jalloc = BlockAllocator(16, BS), JBlockAllocator(16, BS)
    table = torch.from_numpy(block_table_view(alloc, alloc.alloc_many(W), W)[None])
    jtable = jnp.asarray(j_block_table_view(jalloc, jalloc.alloc_many(W), W)[None])
    pages = tf.init_paged_cache(tcfg, 16, BS, dtype=torch.float32, device="cpu")
    jpages = j_tf.init_paged_cache(rcfg, 16, BS, dtype=jnp.float32)
    with torch.no_grad():
        for start in range(0, len(prompt), CHUNK):
            chunk = np.zeros((1, CHUNK), np.int32)
            real = prompt[start:start + CHUNK]
            chunk[0, :len(real)] = real
            lt, pages = tf.prefill_chunk_paged(model, torch.from_numpy(chunk), pages, table,
                                               start, tcfg)
            lj, jpages = j_tf.prefill_chunk_paged(params, jnp.asarray(chunk), jpages, jtable,
                                                  start, rcfg)
            np.testing.assert_allclose(_np(lt), np.asarray(lj), atol=TOL, rtol=TOL,
                                       err_msg=f"prefill chunk at {start}")
        tok = int(np.argmax(_np(lt)[0, len(real) - 1]))
        lengths = torch.tensor([len(prompt)], dtype=torch.int32)
        for step in range(NEW):
            lt, pages = tf.decode_step_paged(model, torch.tensor([[tok]], dtype=torch.int32),
                                             pages, table, lengths, tcfg)
            lj, jpages = j_tf.decode_step_paged(params, jnp.asarray([[tok]], jnp.int32),
                                                jpages, jtable, jnp.asarray(lengths.numpy()),
                                                rcfg)
            np.testing.assert_allclose(_np(lt), np.asarray(lj), atol=TOL, rtol=TOL,
                                       err_msg=f"decode step {step}")
            lengths += 1
            tok = int(np.argmax(_np(lt)[0]))


def _requests(R, n):
    """``n`` requests, prompts of 3-19 tokens, 3-8 new tokens; every third
    one sampled."""
    rng = np.random.default_rng(7)
    specs = [(int(rng.integers(3, 20)), int(rng.integers(3, 9))) for _ in range(n)]
    return [R(i, rng.integers(1, 512, k).astype(np.int32), max_new_tokens=mn,
              temperature=0.8 if i % 3 == 1 else 0.0, top_k=8 if i % 3 == 1 else 0)
            for i, (k, mn) in enumerate(specs)]


ENGINE = dict(max_batch=8, max_seq=40, block_size=BS, prefill_chunk=CHUNK)


@functools.lru_cache(maxsize=None)
def _streams(package: str, n: int, one_at_a_time: bool = False):
    """(token streams, stats) of ``n`` requests served continuously, or
    each alone on the same engine, at capacity 0.5."""
    rcfg, tcfg = _cfgs(BIND)
    if package == "reference":
        eng = JServeEngine(r_build(rcfg), jax.tree.map(jnp.asarray, _reference_params()),
                           **ENGINE)
        reqs = _requests(JRequest, n)
    else:
        eng = ServeEngine(t_build(tcfg), _model(tcfg), **ENGINE)
        assert eng.paged
        reqs = _requests(Request, n)
    for batch in ([[r] for r in reqs] if one_at_a_time else [reqs]):
        eng.run(batch)
    if package == "port":
        assert eng.alloc.live_blocks == 0
    return [list(r.out_tokens) for r in reqs], dict(eng.stats)


@pytest.mark.parametrize("n", [3, 10])
def test_engine_streams_equal_the_reference_where_the_capacity_binds(n):
    """Three requests (five inactive rows of token 0 overflow their
    experts) and ten over eight slots (active rows drop too)."""
    assert _streams("port", n) == _streams("reference", n)


def test_moe_streams_depend_on_the_batch_in_both_packages():
    """Under capacity drops which assignments drop depends on the step's
    other rows, so the continuous stream is not the one-at-a-time stream
    (in the reference too); the port's one-at-a-time streams equal the
    reference's."""
    cont = _streams("reference", 10)[0]
    alone = _streams("reference", 10, one_at_a_time=True)[0]
    assert sum(a != b for a, b in zip(cont, alone)) > 0
    assert _streams("port", 10, one_at_a_time=True)[0] == alone


@pytest.mark.parametrize("arch", [ARCH, "grok-1-314b"])
def test_full_size_config_shapes_and_count_match_the_reference(arch):
    rcfg, tcfg = R_cfgs.get_config(arch), T_cfgs.get_config(arch)
    want_cfg = dataclasses.asdict(rcfg)
    for key, value in dataclasses.asdict(tcfg).items():
        assert value == want_cfg[key], key
    assert t_param_count(tcfg) == r_param_count(rcfg)
    want = jax.eval_shape(r_build(rcfg).init, jax.random.PRNGKey(0))
    flat = {".".join(k.key for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}
    model = _family(tcfg)[1](tcfg, "meta")
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(flat)
    for name, p in got.items():
        assert p.is_meta
        assert tuple(p.shape) == flat[name].shape, name
        assert str(p.dtype).removeprefix("torch.") == str(flat[name].dtype), name
    assert got["layers.moe.router"].dtype == torch.float32
