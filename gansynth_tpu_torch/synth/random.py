"""JAX's threefry2x32 generator, its key operations and its uniform and
normal transforms, in numpy.

The serving contract makes a note a pure function of (params, seed,
pitch): the reference draws each note's latent as
``jax.random.normal(jax.random.key(seed), (latent_dim,), float32)``
(``gansynth_tpu/synth/sampler.py:_seeded_body``). This module gives the
same latents from the same seeds, so the two packages render the same
note for the same request.

The bit layout is JAX's ``jax_threefry_partitionable=True`` one (the
default since JAX 0.5): element ``i`` of the output draws from the
counter pair ``(i >> 32, i & 0xFFFFFFFF)`` and keeps ``y0 ^ y1``. The
uniform bits match JAX bitwise; the normal values match to the last ulp
or so, since ``log1p``/``sqrt`` of two libraries may round differently.

The training step's noise follows the reference's key schedule
(``gansynth_tpu/train/step.py:76-77``): ``fold_in`` the step into the
state's key, ``split`` it three ways, and draw. ``fold_in``, ``split`` and
``uniform`` equal ``jax.random``'s bit for bit.

The cached data stream's batch indices (``train/step.py:
cached_batch_indices``) come from :func:`permutation` and :func:`randint`,
which equal ``jax.random``'s bit for bit, so the port reads the
reference's batches from the same key and step.

Latents are small (256 floats a note), so they are drawn on the host in
numpy and handed to the device afterwards.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)

# Giles' single-precision erfinv polynomial, as XLA lowers erf_inv for f32.
_ERFINV_W_LT_5 = (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
)
_ERFINV_W_GE_5 = (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: Tuple[int, int], x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 with 20 rounds on counter words ``(x0, x1)`` (uint32
    arrays) under ``key = (k0, k1)``; returns the two output words. Key
    words may be arrays that broadcast against the counters (one key per
    row)."""
    k0 = np.asarray(key[0], np.uint32)
    k1 = np.asarray(key[1], np.uint32)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0.astype(np.uint32) + ks[0]
    x1 = x1.astype(np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r)
            x1 = x0 ^ x1
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def seed_to_key(seed: int) -> Tuple[int, int]:
    """``jax.random.key(seed)``'s raw data for a 32-bit seed (JAX without
    x64): the high word is 0 and the low word is the seed modulo 2^32."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 32):
        raise ValueError(f"seed {seed} is not a 32-bit integer")
    return 0, seed & 0xFFFFFFFF


Key = Tuple[int, int]


def _counters(n: int):
    """The (high, low) uint32 words of the 64-bit counters 0..n-1."""
    counts = np.arange(n, dtype=np.uint64)
    return ((counts >> np.uint64(32)).astype(np.uint32),
            (counts & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``: threefry of the counter pair
    ``(0, uint32(data))`` under ``key``."""
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return int(y0[0]), int(y1[0])


def split(key: Key, num: int = 2) -> List[Key]:
    """``jax.random.split(key, num)`` (partitionable layout): key ``i`` is
    threefry of the 64-bit counter ``i`` under ``key``."""
    y0, y1 = threefry2x32(key, *_counters(num))
    return [(int(a), int(b)) for a, b in zip(y0, y1)]


def _bits(key, n: int) -> np.ndarray:
    """Uint32 bits [..., n] of counters 0..n-1 under ``key`` (whose words
    may carry leading batch dimensions)."""
    y0, y1 = threefry2x32(key, *_counters(n))
    return y0 ^ y1


def random_bits(key: Tuple[int, int], shape: Sequence[int]) -> np.ndarray:
    """``jax.random.bits(key, shape, uint32)`` (partitionable layout)."""
    return _bits(key, math.prod(shape)).reshape(tuple(shape))


def _erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 erfinv: a degree-8 polynomial in ``w = -log1p(-x^2)``."""
    x = x.astype(np.float32)
    w = -np.log1p(x * -x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    coef = lambda i: np.where(lt, np.float32(_ERFINV_W_LT_5[i]),
                              np.float32(_ERFINV_W_GE_5[i]))
    p = coef(0)
    for i in range(1, len(_ERFINV_W_LT_5)):
        p = (coef(i) + p * w).astype(np.float32)
    out = (p * x).astype(np.float32)
    return np.where(np.abs(x) == 1, x * np.float32(np.inf), out)


def uniform_from_bits(bits: np.ndarray, minval: np.float32,
                      maxval: np.float32) -> np.ndarray:
    """JAX's float32 uniform: 23 random mantissa bits under exponent 0,
    minus 1, scaled onto ``[minval, maxval)``."""
    float_bits = (bits >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = float_bits.view(np.float32) - np.float32(1.0)
    scaled = floats * (maxval - minval) + minval
    return np.maximum(minval, scaled).astype(np.float32)


def uniform(key: Key, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32)`` on [0, 1)."""
    return uniform_from_bits(random_bits(key, shape), np.float32(0.0),
                             np.float32(1.0))


def _normal_from_bits(bits: np.ndarray) -> np.ndarray:
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform_from_bits(bits, lo, np.float32(1.0))
    return (np.float32(np.sqrt(2)) * _erfinv_f32(u)).astype(np.float32)


def normal(key: Tuple[int, int], shape: Sequence[int]) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)``: ``sqrt(2) *
    erfinv(u)`` for ``u`` uniform on ``(-1, 1)``."""
    return _normal_from_bits(random_bits(key, shape))


def seeded_latents(seeds: Sequence[int], latent_dim: int) -> np.ndarray:
    """One latent per seed, each from its own key: ``[len(seeds),
    latent_dim]`` float32, row i equal to
    ``jax.random.normal(jax.random.key(seeds[i]), (latent_dim,))``. All
    rows are drawn in one vectorized pass."""
    keys = np.array([seed_to_key(s) for s in seeds],
                    np.uint32).reshape(-1, 2)
    return _normal_from_bits(_bits((keys[:, :1], keys[:, 1:]), latent_dim))


def permutation(key: Key, n: int) -> np.ndarray:
    """``jax.random.permutation(key, n)`` (JAX's ``_shuffle``): int32
    ``[n]``. ``ceil(3 ln n / ln(2^32 - 1))`` rounds (2 for n = 256 or
    2048, none for n = 1); each round splits the key, draws 32-bit sort
    keys from the second half and sorts by them, stably, as
    ``lax.sort_key_val`` does."""
    x = np.arange(n, dtype=np.int32)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(0xFFFFFFFF)))
    for _ in range(rounds):
        key, sub = split(key)
        x = x[np.argsort(random_bits(sub, (n,)), kind="stable")]
    return x


def randint(key: Key, shape: Sequence[int], minval: int,
            maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` for int32 (JAX's
    ``_randint``): two 32-bit words per value from ``split(key)``, reduced
    onto the span with the multiplier ``2^32 mod span``, in wrapping
    uint32 arithmetic."""
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = np.uint32(1 if maxval <= minval else maxval - minval)
    multiplier = np.uint32(2 ** 16) % span
    multiplier = (multiplier * multiplier) % span
    offset = (higher % span) * multiplier + (lower % span)
    return (np.int32(minval) + (offset % span).astype(np.int32)).astype(
        np.int32)
