"""The port's ssm (rwkv6) and hybrid (zamba2) training, decode and static
serving against the reference, on the CPU at the smoke size.

Same weights (the reference's, perturbed as in ``test_torch_ssm_models``,
through ``from_jax_params``), same tokens (numpy, seeded):

* remat: ``"full"`` (non-reentrant checkpoint per layer body) and
  ``"none"`` give bitwise equal losses and gradients;
* decode: ``decode_step``'s logits and every state field after each of 8
  tokens against the reference's jitted ``decode_step`` (float32 at
  ``F32_TOL``; bfloat16 at ``BF16_TOL``); token-by-token logits against the
  port's own full-sequence forward;
* serving: ``ServeEngine.run`` on ragged prompts, greedy and sampled,
  token for token the JAX engine's static path (``_run_static``), with
  the same ``stats``.

Tolerances: ``F32_TOL`` 2e-5 as in ``test_torch_ssm_models`` (float32
products and norms summed in another order).  Decode against the forward:
rwkv6 at ``F32_TOL``; the hybrid at ``KV_TOL`` = 2e-2, because its decode
keeps the shared block's K and V in a bfloat16 cache (as the reference's
does) while the forward attends in float32, and one bfloat16 rounding of K
and V (2^-9 relative) moves the smoke model's logits (|logit| < 4) by up to
about 1e-2 (measured 8.2e-3).  bfloat16 decode against the reference:
``BF16_TOL`` = 2^-4 relative to the largest entry of each field — XLA and
torch round the intermediates (the conv window's sum among them) in other
orders, each to 8 bits, and a state accumulates those roundings over the
steps (measured at most 1.8e-2 for rwkv6's fields, 3.0e-2 for the
hybrid's SSM state).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as R_cfgs
from repro.models import build_model as r_build
from repro.serve.engine import Request as RRequest
from repro.serve.engine import ServeEngine as RServeEngine

import repro_torch.configs as T_cfgs
from repro_torch.models import build_model as t_build
from repro_torch.models import from_jax_params, param_leaves
from repro_torch.serve import Request, ServeEngine

from test_torch_ssm_models import ARCHS, _perturbed, _reference_init

F32_TOL = 2e-5
KV_TOL = 2e-2
BF16_TOL = 2.0 ** -4
STEPS = 8


def _pair(arch, dtype="float32", **par):
    """(reference cfg, its params), (port cfg, port model) on the same
    smoke weights (perturbed in float32)."""
    change = dict(param_dtype=dtype, compute_dtype=dtype)
    rcfg = dataclasses.replace(R_cfgs.smoke_config(arch), **change)
    tcfg = dataclasses.replace(T_cfgs.smoke_config(arch), **change)
    if par:
        tcfg = dataclasses.replace(tcfg, parallelism=dataclasses.replace(tcfg.parallelism, **par))
    if dtype == "float32":
        params = _perturbed(_reference_init(arch))
    else:  # the reference's own bfloat16 weights (norms and adapters stay f32)
        params = jax.tree.map(np.asarray, jax.jit(r_build(rcfg).init)(jax.random.PRNGKey(0)))
    return (rcfg, params), (tcfg, from_jax_params(params, tcfg, device="cpu"))


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 512, size=shape).astype(np.int32)


def _batch(seed=6):
    tok = _tokens((2, 16), seed)
    return {"tokens": torch.from_numpy(tok), "targets": torch.from_numpy(np.roll(tok, -1, 1))}


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_full_and_none_are_bitwise_equal(arch):
    """The loss and every parameter's gradient, bitwise, under
    ``remat="full"`` (each layer body checkpointed, recomputed in the
    backward) and ``"none"``; ``"dots"`` is refused naming the roadmap."""
    out = {}
    for remat in ("none", "full"):
        _, (tcfg, model) = _pair(arch, remat=remat)
        params = [p for _, p in param_leaves(model)]
        loss = t_build(tcfg).loss_fn(model, _batch())
        grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
        out[remat] = (loss.detach(), grads)
    assert torch.equal(out["none"][0], out["full"][0])
    for a, b in zip(out["none"][1], out["full"][1]):
        assert torch.equal(a, b)
    _, (tcfg, model) = _pair(arch, remat="dots")
    with pytest.raises(NotImplementedError, match="queue 1"):
        t_build(tcfg).loss_fn(model, _batch())


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def _field_arrays(state) -> list:
    """Every leaf of a port decode state as float32 numpy (the reference's
    ``jax.tree.leaves`` order: NamedTuple fields in order)."""
    out = []
    for f in state:
        out += _field_arrays(f) if isinstance(f, tuple) else [f.float().numpy().copy()]
    return out


def _decode_both(arch, dtype):
    (rcfg, params), (tcfg, model) = _pair(arch, dtype)
    rapi, tapi = r_build(rcfg), t_build(tcfg)
    toks = _tokens((2, STEPS), 3)
    rstate, tstate = rapi.decode_init(2, 16), tapi.decode_init(2, 16, device="cpu")
    rstep = jax.jit(rapi.decode_step)
    rows = []
    for t in range(STEPS):
        rl, rstate = rstep(params, jnp.asarray(toks[:, t:t + 1]), rstate, jnp.int32(t))
        with torch.no_grad():
            tl, tstate = tapi.decode_step(model, torch.from_numpy(toks[:, t:t + 1]), tstate, t)
        want = [np.asarray(rl, np.float32)] + [np.asarray(a, np.float32)
                                               for a in jax.tree.leaves(rstate)]
        rows.append((want, [tl.float().numpy()] + _field_arrays(tstate)))
    return rows, (tcfg, tapi, model, toks)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_the_reference_after_every_token(arch):
    """float32: logits and every state field (rwkv6: shift_tm, shift_cm,
    wkv; hybrid: conv, ssm, the per-firing K and V caches) after each of 8
    tokens."""
    rows, _ = _decode_both(arch, "float32")
    for t, (want, got) in enumerate(rows):
        assert len(got) == len(want) == (4 if arch == "rwkv6-7b" else 5)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape, (t, i)
            np.testing.assert_allclose(g, w, atol=F32_TOL, rtol=F32_TOL, err_msg=f"t={t} #{i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_decode_step_matches_the_reference(arch):
    """bfloat16 weights and stream: logits and state fields within
    ``BF16_TOL`` of each field's largest entry, after each of 8 tokens; the
    greedy tokens agree."""
    rows, _ = _decode_both(arch, "bfloat16")
    for t, (want, got) in enumerate(rows):
        for i, (g, w) in enumerate(zip(got, want)):
            scale = max(float(np.abs(w).max()), 1e-6)
            np.testing.assert_allclose(g, w, atol=BF16_TOL * scale, rtol=0,
                                       err_msg=f"t={t} #{i}")
        np.testing.assert_array_equal(got[0].argmax(-1), want[0].argmax(-1))


@pytest.mark.parametrize("arch", ARCHS)
def test_token_by_token_decode_matches_the_full_forward(arch):
    rows, (tcfg, tapi, model, toks) = _decode_both(arch, "float32")
    with torch.no_grad():
        full = tapi.forward(model, {"tokens": torch.from_numpy(toks)}).numpy()
    tol = F32_TOL if arch == "rwkv6-7b" else KV_TOL
    for t, (_, got) in enumerate(rows):
        np.testing.assert_allclose(got[0], full[:, t], atol=tol, rtol=tol, err_msg=f"t={t}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_shapes_and_dtypes(arch):
    """rwkv6: (L, B, d) f32 shifts and (L, B, H, N, N) f32 WKV; hybrid:
    (L, B, K-1, d_inner + 2N) conv window in the compute dtype, (L, B, H,
    P, N) f32 SSM state and a bf16 (F, B, max_seq, Hkv, hd) cache."""
    cfg = dataclasses.replace(T_cfgs.smoke_config(arch), compute_dtype="bfloat16")
    st = t_build(cfg).decode_init(3, 24, device="cpu")
    L, d = cfg.num_layers, cfg.d_model
    if arch == "rwkv6-7b":
        N = cfg.ssm.head_dim
        want = [((L, 3, d), torch.float32)] * 2 + [((L, 3, d // N, N, N), torch.float32)]
        got = [(tuple(t.shape), t.dtype) for t in st]
    else:
        s = cfg.ssm
        di, F = s.expand * d, L // cfg.hybrid.shared_attn_every
        kv = ((F, 3, 24, cfg.num_kv_heads, cfg.resolved_head_dim), torch.bfloat16)
        want = [((L, 3, s.conv_kernel - 1, di + 2 * s.state_size), torch.bfloat16),
                ((L, 3, di // s.head_dim, s.head_dim, s.state_size), torch.float32), kv, kv]
        got = [(tuple(t.shape), t.dtype) for t in (*st.mamba, *st.attn_kv)]
    assert got == want


# ---------------------------------------------------------------------------
# static serving
# ---------------------------------------------------------------------------
PROMPTS = (5, 11, 8)      # ragged
SAMPLED = dict(temperature=0.8, top_k=20)


def _requests(cls, sampled: bool):
    rng = np.random.default_rng(4)
    return [cls(i, rng.integers(1, 512, n).astype(np.int32), max_new_tokens=4 + i,
                **(SAMPLED if sampled and i != 1 else {}))
            for i, n in enumerate(PROMPTS)]


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("arch", ARCHS)
def test_static_serving_streams_equal_the_jax_engine(arch, sampled):
    """``run()`` on ragged prompts: left-padded, prefilled one position a
    step, decoded in rounds; every request's tokens and the engine's stats
    equal the JAX engine's ``_run_static``, and ``submit`` stays the paged
    path's."""
    (rcfg, params), (tcfg, model) = _pair(arch)
    want = _requests(RRequest, sampled)
    reng = RServeEngine(r_build(rcfg), jax.tree.map(jnp.asarray, params), max_batch=4,
                        max_seq=32, seed=3)
    reng.run(want)
    got = _requests(Request, sampled)
    eng = ServeEngine(t_build(tcfg), model, max_batch=4, max_seq=32, seed=3)
    eng.run(got)
    for g, w in zip(got, want):
        assert g.done and len(g.out_tokens) == g.max_new_tokens
        assert g.out_tokens == [int(t) for t in w.out_tokens], g.rid
    assert eng.stats == reng.stats
    with pytest.raises(NotImplementedError, match="paged family"):
        eng.submit(Request(9, np.arange(1, 4, dtype=np.int32)))


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_runs_the_zero1_step(arch):
    """``launch.train --arch <ssm or hybrid>`` trains the default ZeRO-1 ABI
    step with no further flag: three steps, finite losses and grad norms."""
    from repro_torch.launch import train

    rep = train.main(["--arch", arch, "--smoke", "--steps", "3", "--global-batch", "4",
                      "--seq-len", "16", "--device", "cpu", "--warmup", "1"])
    assert rep.steps_completed == 3 and rep.wire_kernel == "torch"
    assert len(rep.losses) == 3 and all(np.isfinite(rep.losses + rep.grad_norms))


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_serves_statically(arch, capsys):
    from repro_torch.launch import serve

    reqs = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "3",
                       "--prompt-len", "6", "--new-tokens", "4"])
    assert all(r.done and len(r.out_tokens) == 4 for r in reqs)
    out = capsys.readouterr().out
    assert "tok/s" in out and "kv pool" not in out and "'decode_steps': 3" in out
