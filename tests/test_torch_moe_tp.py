"""The moe family on the model axis against the reference on the same mesh,
on the CPU at the smoke size in float32: tensor parallelism of the
attention, the shared experts and the vocabulary beside expert
parallelism (qwen2-moe-a2.7b, ``ep``), each expert's ``d_ff`` split with
sequence parallelism (grok-1-314b, ``tp``), and FSDP under ``gspmd``.

Both packages' smoke configs get the same ``dataclasses.replace``:
``tp_size`` set to the test mesh's model axis (2), remat ``"full"``, two
microbatches, and grok-1-314b's ``sequence_parallel``.  The reference runs
once a mesh in a subprocess with ``--xla_force_host_platform_device_count``
set to its size: at (data, model) = (1, 2) its forward (EP's ``shard_map``
for qwen2-moe), ``prefill`` and ``decode_step``, and two ABI ZeRO-1 steps;
at (2, 2) two ``gspmd`` steps.  The port runs on gloo ranks
(``_torch_moe_tp_ranks.py``) meeting through ``file://`` in ``tmp_path``,
each rank holding its block (``from_jax_params`` with
``train_loop.model_part``):

1. the forward at (1, 2): logits and ``last_only`` within 2e-5; the
   prefill's bfloat16 cache (the rank's K/V heads) within one bfloat16
   rounding plus 1e-4 (``test_torch_tp``'s bounds); the split decode step
   on the rank's K/V heads of the reference's cache against the
   reference's ``decode_step`` on the same weights within 2e-5 (qwen2-moe's
   experts dispatched alike on both ranks, each running its own slots);
2. two ABI ZeRO-1 steps at (1, 2) and two ``gspmd`` steps with FSDP at
   (2, 2): losses and grad norms within 1e-5 relative, each leaf block
   within 5e-5 of the whole leaf's largest magnitude (``test_torch_tp``'s
   bound), the key bias (exact gradient zero) within Adam's step bound;
3. qwen2-moe's ABI steps at a sequence of 15, which the model axis does
   not divide: no alltoall, every rank runs its experts' slots of the same
   dispatch, and the gradient is the reference's (its ``_moe_local`` on
   the split experts);
4. both archs' ``gspmd`` steps at a capacity factor of 0.5, where tokens
   drop: a data-parallel rank takes its tokens' places in the global
   batch's dispatch (``moe._global_slots``), so the same tokens drop as in
   the reference's global batch.

The ``gspmd`` leg runs one microbatch a step: the reference's GSPMD step
cuts its microbatches from the global batch's rows, a data-parallel rank
of the port from its own rows, and the aux loss and the capacity of a moe
microbatch depend on which rows it holds (the dense family's loss does
not).  With one microbatch both route the same rows: the port averages
the aux loss's load over the data axis and dispatches into the global
batch's capacity (``TensorParallel.batch_group``).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro_torch.configs as T_cfgs
from repro_torch.models.transformer import TransformerLM
from repro_torch.optim.adamw import AdamWConfig as T_Adam

from _torch_moe_tp_ranks import moe_tp_rank
from _torch_ranks import run_ranks

ARCHS = ("qwen2-moe-a2.7b", "grok-1-314b")
SRC = Path(__file__).resolve().parent.parent / "src"
R = 2
STEPS = 2
TOL = 2e-5
STEP_RTOL = 1e-5
LEAF_TOL = 5e-5
NOISE_LEAVES = ("layers.attn.bk",)
#: a leaf's gradient against the reference's, of its largest element
GRAD_TOL = 1e-5
CACHE_TOL = 1e-4
#: the legs' parallelism beyond the configs' own
LEGS = {"abi": dict(grad_sync="abi", microbatch=2),
        "gspmd": dict(grad_sync="gspmd", microbatch=1)}
#: a capacity factor at which tokens drop (the smoke configs' C is 4 to 16)
DROP = 0.5
#: each leg's cases: (name, arch, the moe config's changes, sequence,
#: forward); the steps run in every case
CASES = {
    "abi": (("qwen2-moe-a2.7b", "qwen2-moe-a2.7b", {}, 16, True),
            ("grok-1-314b", "grok-1-314b", {}, 16, True),
            ("qwen2-moe-a2.7b@odd", "qwen2-moe-a2.7b", {}, 15, False)),
    "gspmd": (("qwen2-moe-a2.7b", "qwen2-moe-a2.7b", {}, 16, False),
              ("grok-1-314b", "grok-1-314b", {}, 16, False),
              ("qwen2-moe-a2.7b@drop", "qwen2-moe-a2.7b", {"capacity_factor": DROP}, 16,
               False),
              ("grok-1-314b@drop", "grok-1-314b", {"capacity_factor": DROP}, 16, False)),
}

_SCRIPT = """
import dataclasses, json, sys
import numpy as np
import jax
import jax.numpy as jnp
import repro.configs as R
from repro.core.compat import make_mesh
from repro.models import build_model, transformer
from repro.optim.adamw import AdamWConfig
from repro.runtime.dist import make_dist
from repro.runtime.sharding import use_rules
from repro.train import train_loop

d, dp, tp, steps = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
par = json.loads(sys.argv[5])
dist = make_dist(make_mesh((dp, tp), ("data", "model")))
names = lambda tree: [".".join(k.key for k in p) for p, _ in
                      jax.tree_util.tree_flatten_with_path(tree)[0]]
out = {}
for i, (case, arch, moe, forward) in enumerate(json.loads(sys.argv[6])):
    with np.load(f"{d}/in{i}.npz") as f:
        batch = {k: jnp.asarray(f[k]) for k in f.files}
    cfg = R.smoke_config(arch)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe),
                              parallelism=dataclasses.replace(
        cfg.parallelism, tp_size=tp, remat="full",
        sequence_parallel=arch == "grok-1-314b", **par))
    api = build_model(cfg)
    params = jax.jit(api.init)(jax.random.PRNGKey(0))
    for n, leaf in zip(names(params), jax.tree.leaves(params)):
        out[f"{case}:init:{n}"] = np.asarray(leaf)
    if forward:
        def fwd(p):
            with use_rules(dist.rules):
                return api.forward(p, batch, dist)[0]
        out[f"{case}:logits"] = np.asarray(jax.jit(fwd)(params))
        S = batch["tokens"].shape[1]
        _, cache, _ = jax.jit(lambda p, t: transformer.prefill(p, t, cfg, max_seq=S))(
            params, batch["tokens"][:, :S - 1])
        dec, _ = jax.jit(lambda p, t, c: transformer.decode_step(
            p, t, c, jnp.int32(S - 1), cfg))(params, batch["tokens"][:, S - 1:], cache)
        out[f"{case}:decode"] = np.asarray(dec)
        out[f"{case}:cache_k"] = np.asarray(cache.k, np.float32)
        out[f"{case}:cache_v"] = np.asarray(cache.v, np.float32)
    if case.endswith("@odd"):
        def loss(p):
            with use_rules(dist.rules):
                return api.loss_fn(p, batch, dist)
        for n, leaf in zip(names(params), jax.tree.leaves(jax.jit(jax.grad(loss))(params))):
            out[f"{case}:grad:{n}"] = np.asarray(leaf)
    state = train_loop.init_state(api, jax.random.PRNGKey(0), dist=dist)
    step = jax.jit(train_loop.make_train_step(api, dist, AdamWConfig()))
    losses, norms = [], []
    for _ in range(steps):
        state, met = step(state, batch)
        losses.append(float(met.loss))
        norms.append(float(met.grad_norm))
    out[f"{case}:losses"], out[f"{case}:grad_norms"] = np.array(losses), np.array(norms)
    for n, leaf in zip(names(state.params), jax.tree.leaves(state.params)):
        out[f"{case}:final:{n}"] = np.asarray(leaf)
np.savez(d + "/out.npz", **out)
"""


def _cfg(arch: str, leg: str, **moe):
    """The port's config of one leg (the reference script makes its twin)."""
    cfg = T_cfgs.smoke_config(arch)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe),
                               parallelism=dataclasses.replace(
        cfg.parallelism, tp_size=R, remat="full", sequence_parallel=arch == "grok-1-314b",
        **LEGS[leg]))


def _batch(seq: int = 16) -> dict:
    tok = np.random.default_rng(3).integers(0, 512, size=(4, seq)).astype(np.int32)
    return {"tokens": tok, "targets": np.roll(tok, -1, axis=1)}


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


def _read(d: Path, leg: str) -> dict:
    """The reference's records of one mesh, per case."""
    with np.load(d / "out.npz") as f:
        flat = {k: f[k] for k in f.files}
    out = {}
    for case, *_ in CASES[leg]:
        mine = {k.split(":", 1)[1]: v for k, v in flat.items() if k.startswith(case + ":")}
        rec = {k: v for k, v in mine.items() if ":" not in k}
        rec["params"] = _nest({k[5:]: v for k, v in mine.items() if k.startswith("init:")})
        rec["final"] = {k[6:]: v for k, v in mine.items() if k.startswith("final:")}
        rec["grad"] = {k[5:]: v for k, v in mine.items() if k.startswith("grad:")}
        out[case] = rec
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference on both meshes, its two subprocesses run together:
    leg -> case -> records."""
    procs = {}
    for leg, dp in (("abi", 1), ("gspmd", 2)):
        d = tmp_path_factory.mktemp(f"moe_tp_ref_{leg}")
        for i, (_, _, _, seq, _) in enumerate(CASES[leg]):
            np.savez(d / f"in{i}.npz", **_batch(seq))
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC),
                   XLA_FLAGS=f"--xla_force_host_platform_device_count={dp * R}")
        cases = [(case, arch, moe, fwd) for case, arch, moe, _, fwd in CASES[leg]]
        procs[leg] = (d, subprocess.Popen(
            [sys.executable, "-c", _SCRIPT, str(d), str(dp), str(R), str(STEPS),
             json.dumps(LEGS[leg]), json.dumps(cases)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    out = {}
    for leg, (d, proc) in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-4000:]
        out[leg] = _read(d, leg)
    return out


def _leg(tmp_path_factory, ref: dict, leg: str, dp: int):
    cases = []
    for case, arch, moe, seq, forward in CASES[leg]:
        batch = _batch(seq)
        if forward:
            batch.update(cache_k=ref[case]["cache_k"], cache_v=ref[case]["cache_v"])
        cases.append((case, _cfg(arch, leg, **moe), ref[case]["params"], batch, forward))
    ranks = run_ranks(moe_tp_rank, dp * R, tmp_path_factory.mktemp(f"moe_tp_{leg}"), R,
                      cases, STEPS, timeout=240)
    return ref, ranks


@pytest.fixture(scope="module")
def abi_leg(tmp_path_factory, reference):
    """(1, 2): the forward, the prefill and the split decode, then the ABI
    ZeRO-1 steps (also at a sequence the model axis does not divide)."""
    return _leg(tmp_path_factory, reference["abi"], "abi", 1)


@pytest.fixture(scope="module")
def fsdp_leg(tmp_path_factory, reference):
    """(2, 2): the ``gspmd`` steps with FSDP (also where the capacity
    binds)."""
    return _leg(tmp_path_factory, reference["gspmd"], "gspmd", 2)


# ---------------------------------------------------------------------------
# what a rank holds
# ---------------------------------------------------------------------------
def test_each_rank_holds_its_block_of_the_moe_layer(abi_leg, fsdp_leg):
    """qwen2-moe: its experts, attention heads, shared experts and
    vocabulary split; grok-1: every expert's ``d_ff``, its query and K/V
    heads and vocabulary; the router, the shared gate and the norms whole;
    under ``gspmd`` each rank's fsdp block too."""
    moe = {"layers.moe.experts.wi", "layers.moe.experts.wg", "layers.moe.experts.wo"}
    shared = {"layers.moe.shared.wi", "layers.moe.shared.wg", "layers.moe.shared.wo"}
    attn = {"layers.attn.wq", "layers.attn.wk", "layers.attn.wv", "layers.attn.wo"}
    want = {"qwen2-moe-a2.7b": moe | shared | attn | {"layers.attn.bq", "layers.attn.bk",
                                                      "layers.attn.bv", "embed.tok",
                                                      "embed.unembed"},
            "grok-1-314b": moe | attn | {"embed.tok", "embed.unembed"}}
    for legs in (abi_leg[1], fsdp_leg[1]):
        for r, out in enumerate(legs):
            for arch in ARCHS:
                assert set(out[f"{arch}:split"]) == want[arch], arch
                assert list(out[f"{arch}:part"])[:2] == [r % R, R]
    for r, out in enumerate(fsdp_leg[1]):
        for arch in ARCHS:
            assert list(out[f"{arch}:part"]) == [r % R, R, r // R, 2]
            fs = set(out[f"{arch}:fsdp"])
            assert {"layers.moe.experts.wi", "layers.moe.experts.wo", "layers.attn.wq",
                    "embed.tok"} <= fs, arch
            assert "layers.moe.router" not in fs and "layers.ln1.scale" not in fs


def test_the_experts_are_held_by_expert_under_ep_and_by_d_ff_under_tp(abi_leg):
    """A rank's experts leaf: qwen2-moe's 2 of 4 experts whole, grok-1's 4
    experts at half their ``d_ff``."""
    ref, ranks = abi_leg
    for r, out in enumerate(ranks):
        q = out["qwen2-moe-a2.7b:param:layers.moe.experts.wi"]
        g = out["grok-1-314b:param:layers.moe.experts.wi"]
        full_q = ref["qwen2-moe-a2.7b"]["final"]["layers.moe.experts.wi"]
        full_g = ref["grok-1-314b"]["final"]["layers.moe.experts.wi"]
        assert q.shape == (full_q.shape[0], full_q.shape[1] // R, *full_q.shape[2:])
        assert g.shape == (*full_g.shape[:3], full_g.shape[3] // R)


# ---------------------------------------------------------------------------
# the legs against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_split_forward_prefill_and_decode_match_the_reference(arch, abi_leg):
    ref, ranks = abi_leg
    want, decode = ref[arch]["logits"], ref[arch]["decode"]
    tcfg = _cfg(arch, "abi")
    kv_heads = tcfg.num_kv_heads // R
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out[f"{arch}:logits"], want, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(out[f"{arch}:last"][:, 0], want[:, -1], atol=TOL, rtol=TOL)
        assert int(out[f"{arch}:cache_heads"]) == kv_heads
        heads = slice(r * kv_heads, (r + 1) * kv_heads)
        for k in ("cache_k", "cache_v"):
            np.testing.assert_allclose(out[f"{arch}:{k}"], ref[arch][k][..., heads, :],
                                       rtol=2.0 ** -7, atol=CACHE_TOL, err_msg=k)
        np.testing.assert_allclose(out[f"{arch}:decode"], decode, atol=TOL, rtol=TOL)
        # EP's two alltoalls a layer in the forward; none under tp
        layers = tcfg.num_layers
        assert int(out[f"{arch}:alltoalls"]) == (2 * layers if arch == "qwen2-moe-a2.7b"
                                                 else 0)


def _check_steps(arch, leg, cfg_leg, case=None, leaves=True):
    case = case or arch
    ref, ranks = leg
    ref = ref[case]
    cfg = _cfg(arch, cfg_leg)
    for out in ranks:
        np.testing.assert_allclose(out[f"{case}:losses"], ref["losses"], rtol=STEP_RTOL)
        np.testing.assert_allclose(out[f"{case}:grad_norms"], ref["grad_norms"],
                                   rtol=STEP_RTOL)
        if not leaves:
            continue
        t, tn, f, fn = (int(v) for v in out[f"{case}:part"])
        m = TransformerLM(cfg, "meta", t, tn, f, fn)
        assert sorted(ref["final"]) == sorted(m.full_shapes)
        for name, full in ref["final"].items():
            got = out[f"{case}:param:{name}"]
            want = full[m.part.index(full.shape, m.held.get(name, ()))]
            assert got.shape == want.shape, name
            atol = (2 * T_Adam().lr * STEPS if name in NOISE_LEAVES
                    else LEAF_TOL * float(np.abs(full).max()))
            np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)
    assert ranks[0][f"{case}:losses"][-1] < ranks[0][f"{case}:losses"][0]


@pytest.mark.parametrize("arch", ARCHS)
def test_abi_step_at_one_by_two_matches_the_reference(arch, abi_leg):
    _check_steps(arch, abi_leg, "abi")


@pytest.mark.parametrize("arch", ARCHS)
def test_gspmd_step_with_fsdp_at_two_by_two_matches_the_reference(arch, fsdp_leg):
    _check_steps(arch, fsdp_leg, "gspmd")


def test_abi_step_at_a_sequence_the_model_axis_does_not_divide_matches_the_reference(
        abi_leg):
    """qwen2-moe at S=15 on two ranks: no alltoall (at S=16 two a layer
    and microbatch each way, forward and remat's recompute), each rank
    runs its experts' slots of the same dispatch, and its gradient is the
    reference's (its ``_moe_local`` on the split experts): each leaf block
    at the initial weights within ``GRAD_TOL`` of the leaf's largest
    element, then two steps' losses and grad norms.  The parameters after
    the steps are not held here: AdamW normalises each element's step, so
    the float32 noise of the smallest gradient element reaches the
    zero-initialised bias's scale (``layers.attn.bq`` has one at 8e-5 of
    the leaf's largest, 1e-3 of itself from the reference's: float32
    summed in another order), as ROADMAP's settled gemma-7b question
    found."""
    arch = "qwen2-moe-a2.7b"
    case = arch + "@odd"
    ref, ranks = abi_leg
    cfg = _cfg(arch, "abi")
    for out in ranks:
        m = TransformerLM(cfg, "meta", int(out[f"{case}:part"][0]), R)
        assert sorted(ref[case]["grad"]) == sorted(m.full_shapes)
        for name, full in ref[case]["grad"].items():
            want = full[m.part.index(full.shape, m.held.get(name, ()))]
            np.testing.assert_allclose(out[f"{case}:grad:{name}"], want, rtol=0,
                                       atol=GRAD_TOL * float(np.abs(full).max()),
                                       err_msg=name)
        assert int(out[f"{case}:step_alltoalls"]) == 0
        assert int(out[f"{arch}:step_alltoalls"]) > 0
    _check_steps(arch, abi_leg, "abi", case=case, leaves=False)


@pytest.mark.parametrize("arch", ARCHS)
def test_gspmd_step_where_the_capacity_binds_matches_the_reference(arch, fsdp_leg):
    """At a capacity factor of 0.5 tokens drop on every rank; a data rank's
    tokens take their places in the global batch's dispatch, so the steps
    are the reference's, which routes the global batch."""
    _check_steps(arch, fsdp_leg, "gspmd", case=arch + "@drop")
    for out in fsdp_leg[1]:
        assert float(out[f"{arch}@drop:kept"]) < 1.0
        assert float(out[f"{arch}:kept"]) == 1.0


def test_a_split_moe_model_without_its_dist_raises():
    """No fallback: a model holding a block of the model axis refuses to
    run without the dist its layers compute on."""
    import torch

    from repro_torch.models import build_model

    cfg = _cfg("qwen2-moe-a2.7b", "abi")
    model = build_model(cfg).init(0, "cpu", model_rank=0, model_axis=R)
    with pytest.raises(ValueError, match="pass the dist"):
        build_model(cfg).forward(model, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})


def test_ep_under_sequence_parallelism_raises_on_the_split_layout():
    """EP beside sequence parallelism (no config asks for it) raises rather
    than computing another function than the reference's."""
    import torch

    from repro_torch.models.moe import _moe_split
    from repro_torch.models.tensor_parallel import Part

    cfg = _cfg("qwen2-moe-a2.7b", "abi")

    class _Par:  # the layout TensorParallel.of gives EP at sequence parallelism
        part, experts, sp = Part(0, R), "ep", True

    with pytest.raises(NotImplementedError, match="sequence parallelism"):
        _moe_split({}, torch.zeros((1, 4, cfg.d_model)), cfg, None, _Par())
