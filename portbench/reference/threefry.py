"""JAX's threefry2x32 and the key, uniform, normal and permutation
transforms the program's noise is drawn with, in numpy.

Copied from ``gansynth_tpu_torch/synth/random.py`` at commit 267e540
(``threefry2x32``, ``seed_to_key``, ``fold_in``, ``split``, ``random_bits``,
``_erfinv_f32``, ``uniform_from_bits``, ``uniform``, ``normal``,
``seeded_latents``, ``permutation``), so that the reference draws the
served latents, the step's noise and the cached stream's indices from
the seeds and keys alone. The layout is JAX's partitionable one:
element ``i`` draws from the 64-bit counter ``i`` and keeps ``y0 ^ y1``.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

Key = Tuple[int, int]
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
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


def threefry2x32(key, x0: np.ndarray, x1: np.ndarray):
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


def seed_to_key(seed: int) -> Key:
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 32):
        raise ValueError(f"seed {seed} is not a 32-bit integer")
    return 0, seed & 0xFFFFFFFF


def _counters(n: int):
    counts = np.arange(n, dtype=np.uint64)
    return ((counts >> np.uint64(32)).astype(np.uint32),
            (counts & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def fold_in(key: Key, data: int) -> Key:
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return int(y0[0]), int(y1[0])


def split(key: Key, num: int = 2) -> List[Key]:
    y0, y1 = threefry2x32(key, *_counters(num))
    return [(int(a), int(b)) for a, b in zip(y0, y1)]


def _bits(key, n: int) -> np.ndarray:
    y0, y1 = threefry2x32(key, *_counters(n))
    return y0 ^ y1


def random_bits(key: Key, shape: Sequence[int]) -> np.ndarray:
    return _bits(key, math.prod(shape)).reshape(tuple(shape))


def _erfinv_f32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float32)
    w = -np.log1p((x * -x).astype(np.float64)).astype(np.float32)
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


def uniform_from_bits(bits: np.ndarray, minval, maxval) -> np.ndarray:
    float_bits = (bits >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = float_bits.view(np.float32) - np.float32(1.0)
    scaled = floats * (maxval - minval) + minval
    return np.maximum(minval, scaled).astype(np.float32)


def uniform(key: Key, shape: Sequence[int]) -> np.ndarray:
    return uniform_from_bits(random_bits(key, shape), np.float32(0.0),
                             np.float32(1.0))


def _normal_from_bits(bits: np.ndarray) -> np.ndarray:
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform_from_bits(bits, lo, np.float32(1.0))
    return (np.float32(np.sqrt(2)) * _erfinv_f32(u)).astype(np.float32)


def normal(key: Key, shape: Sequence[int]) -> np.ndarray:
    return _normal_from_bits(random_bits(key, shape))


def seeded_latents(seeds: Sequence[int], latent_dim: int) -> np.ndarray:
    """Row i: ``jax.random.normal(jax.random.key(seeds[i]),
    (latent_dim,))``."""
    keys = np.array([seed_to_key(s) for s in seeds],
                    np.uint32).reshape(-1, 2)
    return _normal_from_bits(_bits((keys[:, :1], keys[:, 1:]), latent_dim))


def permutation(key: Key, n: int) -> np.ndarray:
    x = np.arange(n, dtype=np.int32)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(0xFFFFFFFF)))
    for _ in range(rounds):
        key, sub = split(key)
        x = x[np.argsort(random_bits(sub, (n,)), kind="stable")]
    return x
