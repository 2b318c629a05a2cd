"""The port's host-side sampling against ``jax.random`` and the reference's
``sample``, and the twins of ``tests/test_serve_sampling.py`` (per-request
sampling parameters) on the port's engine."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

from repro.serve.engine import sample as j_sample
from repro_torch import configs as tcfgs
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve import sampling as S

GRID = [(0, 0, 0), (0, 3, 5), (7, 1, 63), (123, 12345, 2), (2**31 - 1, 2**31 + 5, 1000)]
V = 151936                      # qwen2-0.5b's vocabulary
#: float32 Gumbel draws: numpy's logarithm against XLA's CPU one, one last
#: place at the draws' size (below 16) in each of the two logarithms
GUMBEL_F32_ATOL = 2e-6


def _jkey(seed, rid, step):
    return jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), rid), step)


@pytest.mark.parametrize("seed,rid,step", GRID)
def test_keys_bits_and_uniform_are_bitwise(seed, rid, step):
    jk = _jkey(seed, rid, step)
    key = S.request_key(seed, rid, step)
    assert (np.asarray(jax.random.key_data(jk)) == key).all()
    assert (np.asarray(jax.random.bits(jk, (1001,))) == S.random_bits(key, 1001)).all()
    tiny = float(np.finfo(np.float32).tiny)
    ju = np.asarray(jax.random.uniform(jk, (V,), jnp.float32, minval=tiny, maxval=1.0))
    assert (ju.view(np.uint32) == S.uniform(key, V, minval=tiny).view(np.uint32)).all()
    ub = np.asarray(jax.random.uniform(jk, (4099,), jnp.bfloat16, minval=-2.0, maxval=3.0))
    assert (ub.astype(np.float32) == S.uniform(key, 4099, "bfloat16", -2.0, 3.0)).all()


@pytest.mark.parametrize("seed,rid,step", GRID)
def test_gumbel_matches_jax(seed, rid, step):
    jk, key = _jkey(seed, rid, step), S.request_key(seed, rid, step)
    jg = np.asarray(jax.random.gumbel(jk, (V,), jnp.float32))
    np.testing.assert_allclose(S.gumbel(key, V), jg, rtol=0, atol=GUMBEL_F32_ATOL)
    jb = np.asarray(jax.random.gumbel(jk, (V,), jnp.bfloat16)).astype(np.float32)
    assert (S.gumbel(key, V, "bfloat16") == jb).all()


def test_prng_key_and_fold_in_equal_jax():
    for seed in (0, 1, 42, 2**31 - 1, -1, -7):
        assert (np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
                == S.prng_key(seed)).all()
    k = S.prng_key(5)
    for d in (0, 1, 2**32 - 1, 2**40 + 3):
        want = jax.random.fold_in(jax.random.PRNGKey(5), d & 0xFFFFFFFF)
        assert (np.asarray(jax.random.key_data(want)) == S.fold_in(k, d)).all()
    with pytest.raises(ValueError):
        S.prng_key(2**40)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("temperature,top_k", [(0.8, 50), (1.2, 0), (0.5, 4), (2.0, 1)])
def test_sample_equals_reference(dtype, temperature, top_k):
    """The drawn token equals ``repro.serve.engine.sample`` on the same
    logits and key, over a grid of keys (and one row at the full vocabulary)."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    for n, (seed, rid, step) in enumerate(GRID):
        vocab = V if n == 0 else 512
        logits = np.random.default_rng(n).standard_normal(vocab).astype(np.float32) * 4
        if dtype == "bfloat16":
            logits = logits.astype(ml_dtypes.bfloat16).astype(np.float32)
        want = int(j_sample(jnp.asarray(logits, jdt), _jkey(seed, rid, step), temperature,
                            top_k))
        got = S.sample(logits, S.request_key(seed, rid, step), temperature, top_k, dtype)
        assert got == want, (seed, rid, step)


def test_greedy_takes_the_first_of_tied_maxima():
    logits = np.array([0.5, 2.0, -1.0, 2.0, 2.0], np.float32)
    assert S.sample(logits, None, 0.0, 0) == 1
    assert S.sample(logits, None, -1.0, 3, "bfloat16") == 1
    assert int(j_sample(jnp.asarray(logits), None, 0.0, 0)) == 1


def test_round_bf16_equals_ml_dtypes():
    x = np.random.default_rng(0).standard_normal(100000).astype(np.float32) * 1e3
    x = np.concatenate([x, np.float32([0.0, -0.0, 1e-40, np.inf, -np.inf, 3.3895e38])])
    want = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    assert (S.round_bf16(x).view(np.uint32) == want.view(np.uint32)).all()
    assert np.isnan(S.round_bf16(np.float32([np.nan]))).all()


def test_sample_refuses_an_unknown_dtype():
    with pytest.raises(ValueError):
        S.sample(np.zeros(4, np.float32), S.prng_key(0), 1.0, 0, "float16")


# ---------------------------------------------------------------------------
# twins of tests/test_serve_sampling.py: per-request sampling parameters
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def model():
    cfg = tcfgs.smoke_config("qwen2-0.5b")
    api = build_model(cfg)
    return api, api.init(0, device="cpu")


def _engine(model, max_batch=2):
    api, m = model
    return ServeEngine(api, m, max_batch=max_batch, max_seq=64)


def test_mixed_batch_honors_each_requests_params(model):
    prompt = np.arange(1, 9, dtype=np.int32)
    ref = _engine(model).generate(prompt, max_new_tokens=8)
    eng = _engine(model)
    hot = Request(0, prompt, max_new_tokens=8, temperature=5.0)
    greedy = Request(1, prompt, max_new_tokens=8, temperature=0.0)
    eng.run([hot, greedy])
    assert greedy.out_tokens == list(ref)
    assert len(hot.out_tokens) == 8


def test_per_request_max_new_tokens(model):
    prompt = np.arange(1, 9, dtype=np.int32)
    eng = _engine(model)
    one = Request(0, prompt, max_new_tokens=1)
    short = Request(1, prompt, max_new_tokens=3)
    eng.run([one, short])
    assert len(one.out_tokens) == 1
    assert len(short.out_tokens) == 3
    long = Request(0, prompt, max_new_tokens=8)
    _engine(model).run([long])
    assert len(long.out_tokens) == 8


def test_homogeneous_batch_single_group(model):
    prompt = np.arange(1, 9, dtype=np.int32)
    eng = _engine(model)
    reqs = [Request(i, prompt, max_new_tokens=4, temperature=0.0) for i in range(2)]
    eng.run(reqs)
    assert reqs[0].out_tokens == reqs[1].out_tokens
