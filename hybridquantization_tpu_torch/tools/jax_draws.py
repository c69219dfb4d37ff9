"""JAX's threefry2x32 draws in NumPy, and the JAX engine's draw stream.

`jax.random`'s default generator (threefry2x32) is a counter-based hash, so
its output is a function of the key and the counts alone. This module
computes it with NumPy's uint32 arithmetic (no jax): `prng_key`, `split`,
`random_bits` and `uniform` equal `jax.random.PRNGKey`, `split`,
`bits` and `uniform` bit for bit, in the count layout of
`jax_threefry_partitionable=True` (JAX 0.9.0's default, and the layout the
TPU banks in `docs/evidence/` were drawn with).

On top of it, `engine_draws(seed, pop, K)` yields what the JAX engine's
random-init `find_palette(img, key=PRNGKey(seed))` draws, in its order:
the start palettes (`swasa/loop.py` init_state: `split(key)`, then
`split(sub, pop)`, one uniform (K, 3) palette a key), then each
iteration's `split(state.key, 4)` -> `uniform(k_prop, (pop, K, 3), -1, 1)`,
`uniform(k_acc, (pop,))`, `uniform(k_conv, (pop,))`, as the port's
`loop.make_step` takes them ({"prop", "acc", "conv"}). Fed to the port's
anneal, they replay a JAX run's stream seed by seed.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
_ONE_F32_BITS = np.uint32(0x3F800000)
#: iterations whose draws are made in one vectorised pass
CHUNK = 256


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(k1, k2, x1, x2) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the count pairs (x1, x2) under
    the key (k1, k2); every argument a uint32 array, broadcast together."""
    k1, k2, x1, x2 = (np.asarray(a, np.uint32) for a in (k1, k2, x1, x2))
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a, b = x1 + ks[0], x2 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = a + b
            b = _rotl(b, r) ^ a
        a = a + ks[(i + 1) % 3]
        b = b + ks[(i + 2) % 3] + np.uint32(i + 1)
    return a, b


def prng_key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)`: the (2,) uint32 key [seed >> 32, seed & 0xFFFFFFFF]."""
    seed = int(seed)
    if not 0 <= seed < 2**31:
        raise ValueError(f"seed must be in [0, 2**31), got {seed}")
    return np.array([0, seed], np.uint32)


def _pair(key: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """The two output words of hashing the count pairs (0, i), i < n, under
    `key` (..., 2); each (..., n)."""
    lo = np.arange(n, dtype=np.uint32)
    return threefry2x32(key[..., 0:1], key[..., 1:2], np.zeros_like(lo), lo)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """`jax.random.split(key, num)`: (num, 2) uint32 keys; `key` may carry
    leading axes, which the result keeps ((..., num, 2))."""
    return np.stack(_pair(np.asarray(key, np.uint32), num), axis=-1)


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """`jax.random.bits(key, shape)` (uint32); leading axes of `key` lead the result."""
    key = np.asarray(key, np.uint32)
    shape = tuple(shape)
    a, b = _pair(key, int(np.prod(shape, dtype=np.int64)))
    return (a ^ b).reshape(*key.shape[:-1], *shape)


def uniform(key: np.ndarray, shape, minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """`jax.random.uniform(key, shape, float32, minval, maxval)`: the top 23
    bits as the mantissa of a float in [1, 2), less 1, scaled in float32."""
    bits = random_bits(key, shape)
    floats = ((bits >> np.uint32(9)) | _ONE_F32_BITS).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


def start_palettes(seed: int, pop: int, K: int):
    """(the engine's key after init, (pop, K, 3) float32 start palettes)."""
    key, sub = split(prng_key(seed))
    return key, uniform(split(sub, pop), (K, 3))


def iteration_draws(key: np.ndarray, pop: int, K: int, n: int):
    """n iterations of `loop.make_step`'s draws from the engine key `key`:
    (the key after them, {"prop": (n, pop, K, 3), "acc": (n, pop), "conv":
    (n, pop)} float32). The key chain is sequential; the draws are made in
    one pass over the n iterations' keys."""
    keys = np.empty((n, 3, 2), np.uint32)
    for i in range(n):
        four = split(key, 4)
        key, keys[i] = four[0], four[1:]
    return key, {
        "prop": uniform(keys[:, 0], (pop, K, 3), -1.0, 1.0),
        "acc": uniform(keys[:, 1], (pop,)),
        "conv": uniform(keys[:, 2], (pop,)),
    }


def engine_draws(seed: int, pop: int, K: int, *, chunk: int = CHUNK) -> Iterator:
    """The JAX engine's draws for `find_palette(img, key=PRNGKey(seed))` with
    random init, in its order: first the (pop, K, 3) start palettes, then
    each iteration's draws dict {"prop": (pop, K, 3) U(-1, 1), "acc": (pop,),
    "conv": (pop,)} (float32 NumPy arrays), without end."""
    key, palettes = start_palettes(seed, pop, K)
    yield palettes
    while True:
        key, draws = iteration_draws(key, pop, K, chunk)
        for i in range(chunk):
            yield {k: v[i] for k, v in draws.items()}
