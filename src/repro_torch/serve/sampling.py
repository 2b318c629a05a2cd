"""Token sampling on the host, with the reference's random stream.

The reference samples with ``jax.random`` under its default threefry2x32
generator (``jax_threefry_partitionable=True``), and keys each sampled
token by ``fold_in(fold_in(PRNGKey(seed), rid), step)``, so a request's
draws depend on (engine seed, request id, step) alone.  This module
computes the same stream in numpy:

* :func:`threefry2x32` is the 20-round Threefry-2x32 hash;
* :func:`prng_key` packs a seed as the key ``(seed >> 32, seed & 0xffffffff)``
  and :func:`fold_in` hashes ``(0, data)`` under a key;
* :func:`random_bits` hashes the counters ``(i >> 32, i & 0xffffffff)`` of
  the flat index ``i`` and XORs the two output words (the partitionable
  layout), keeping the low byte for a 16-bit float's 8 random bits;
* :func:`uniform` puts the top mantissa bits under the exponent of 1.0,
  subtracts 1 and scales into ``[minval, maxval)``;
* :func:`gumbel` is ``-log(-log(uniform(tiny, 1)))`` (the reference's
  default "low" mode) and :func:`categorical` is ``argmax(gumbel + logits)``.

Keys, bits and uniforms equal ``jax.random``'s bit for bit.  A bfloat16
stream rounds after every operation as the reference's bfloat16 arithmetic
does (:func:`round_bf16`), and its Gumbel draws are equal too.  In float32
the logarithm is numpy's, which differs from XLA's CPU logarithm in the
last place for about a third of the draws (at most 1e-6 absolute); the
sampled token is the reference's unless two candidates of
``gumbel + logits`` lie within that distance.
"""
from __future__ import annotations

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_MASK32 = 0xFFFFFFFF
#: the logits dtypes :func:`sample` draws in (the model's compute dtype)
DTYPES = ("float32", "bfloat16")


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(key, x1, x2) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the word pairs ``(x1, x2)``
    under the two-word ``key``."""
    k1, k2 = _U32(key[0]), _U32(key[1])
    ks = (k1, k2, _U32(k1 ^ k2 ^ _U32(_PARITY)))
    x1 = np.asarray(x1, _U32) + ks[0]
    x2 = np.asarray(x2, _U32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = x1 + x2
            x2 = _rotl(x2, r) ^ x1
        x1 = x1 + ks[(i + 1) % 3]
        x2 = x2 + ks[(i + 2) % 3] + _U32(i + 1)
    return x1, x2


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s two words for a 32-bit seed."""
    seed = int(seed)
    if not -2**31 <= seed < 2**32:
        raise ValueError(f"seed {seed} does not fit 32 bits")
    return np.array([0, seed & _MASK32], _U32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``."""
    y1, y2 = threefry2x32(key, np.zeros(1, _U32), np.array([int(data) & _MASK32], _U32))
    return np.array([y1[0], y2[0]], _U32)


def request_key(seed: int, rid: int, step: int) -> np.ndarray:
    """The key of request ``rid``'s ``step``-th sampled token."""
    return fold_in(fold_in(prng_key(seed), rid), step)


def random_bits(key, n: int, bit_width: int = 32) -> np.ndarray:
    """``n`` random words of ``bit_width`` (32 or 8) bits, as uint32."""
    idx = np.arange(n, dtype=np.uint64)
    b1, b2 = threefry2x32(key, (idx >> np.uint64(32)).astype(_U32),
                          (idx & np.uint64(_MASK32)).astype(_U32))
    bits = b1 ^ b2
    if bit_width == 8:
        return bits & _U32(0xFF)
    if bit_width != 32:
        raise ValueError(f"bit_width must be 32 or 8, got {bit_width}")
    return bits


def round_bf16(x) -> np.ndarray:
    """Round float32 values to the nearest bfloat16 (ties to even), kept
    as float32; NaN stays NaN."""
    x = np.asarray(x, np.float32)
    b = x.view(_U32)
    r = ((b + ((b >> _U32(16)) & _U32(1)) + _U32(0x7FFF)) & _U32(0xFFFF0000)).view(np.float32)
    nan = np.isnan(x)
    return np.where(nan, x, r) if nan.any() else r


def _check_dtype(dtype: str) -> None:
    if dtype not in DTYPES:
        raise ValueError(f"sampling dtype must be one of {DTYPES}, got {dtype!r}")


def uniform(key, n: int, dtype: str = "float32", minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, (n,), dtype, minval, maxval)`` as float32
    values (bfloat16-representable for ``"bfloat16"``)."""
    _check_dtype(dtype)
    if dtype == "float32":
        fbits = (random_bits(key, n) >> _U32(32 - 23)) | _U32(0x3F800000)
        floats = fbits.view(np.float32) - np.float32(1.0)
        lo, hi = np.float32(minval), np.float32(maxval)
        return np.maximum(lo, floats * (hi - lo) + lo)
    rnd = round_bf16
    fbits = ((random_bits(key, n, 8) >> _U32(8 - 7)) | _U32(0x3F80)) << _U32(16)
    floats = rnd(fbits.view(np.float32) - np.float32(1.0))
    lo, hi = rnd(np.float32(minval)), rnd(np.float32(maxval))
    return np.maximum(lo, rnd(rnd(floats * rnd(hi - lo)) + lo))


def gumbel(key, n: int, dtype: str = "float32") -> np.ndarray:
    """``jax.random.gumbel(key, (n,), dtype)`` in the "low" mode."""
    tiny = float(np.finfo(np.float32).tiny)  # bfloat16 shares float32's exponent range
    u = uniform(key, n, dtype, minval=tiny, maxval=1.0)
    if dtype == "float32":
        return -np.log(-np.log(u))
    rnd = round_bf16
    return -rnd(np.log(-rnd(np.log(u))))


def categorical(key, logits: np.ndarray, dtype: str = "float32") -> int:
    """``jax.random.categorical(key, logits)`` for one row of logits (the
    Gumbel-max draw; the first index wins a tie)."""
    z = gumbel(key, logits.shape[-1], dtype) + logits
    if dtype == "bfloat16":
        z = round_bf16(z)
    return int(np.argmax(z))


def sample(logits: np.ndarray, key, temperature: float, top_k: int,
           dtype: str = "float32") -> int:
    """One token from one row of logits (float32 values of a ``dtype``
    tensor): ``argmax`` at ``temperature <= 0`` (first index on a tie),
    else the reference's tempered, top-k-masked categorical draw under
    ``key``."""
    _check_dtype(dtype)
    logits = np.asarray(logits, np.float32)
    if temperature <= 0.0:
        return int(np.argmax(logits))
    rnd = round_bf16 if dtype == "bfloat16" else np.asarray
    logits = rnd(logits / rnd(np.float32(temperature)))
    if top_k > 0:
        kth = np.partition(logits, -top_k)[-top_k]
        logits = np.where(logits < kth, rnd(np.float32(-1e30)), logits)
    return categorical(key, logits, dtype)
