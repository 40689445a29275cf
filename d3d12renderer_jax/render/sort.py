"""Bitonic key-value sort + built-in self-test.

Reference: src/rendering/bitonic_sort.h:6-30 — indirect multi-pass GPU bitonic
sort over uint/float keys with a correctness self-test
(bitonic_sort.cpp:215-281), used for particle depth sorting.  Here:
the classic bitonic network as a fixed jit program over a padded
power-of-two array; the self-test pattern (device kernel vs host reference)
is kept as `self_test()` and is the template for every kernel test in
tests/ (SURVEY.md §4.1).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@partial(jax.jit, static_argnames=("descending",))
def bitonic_sort_kv(keys, values, descending=False):
    """Sort (keys, values) by keys.  Arbitrary length: pads to a power of two
    with +inf sentinels (like the reference's non-power-of-two handling,
    bitonic_sort.cpp padding)."""
    n = keys.shape[0]
    p = _next_pow2(n)
    pad = p - n
    big = jnp.asarray(jnp.inf, keys.dtype) if not descending else jnp.asarray(
        -jnp.inf, keys.dtype)
    k = jnp.concatenate([keys, jnp.full((pad,), big, keys.dtype)])
    v = jnp.concatenate([values, jnp.zeros((pad,), values.dtype)])

    idx = jnp.arange(p)
    size = 2
    while size <= p:
        stride = size // 2
        while stride > 0:
            partner = idx ^ stride
            ascend = (idx & size) == 0
            if descending:
                ascend = ~ascend
            k_p = k[partner]
            v_p = v[partner]
            is_low = idx < partner
            keep = jnp.where(
                is_low,
                jnp.where(ascend, k <= k_p, k >= k_p),
                jnp.where(ascend, k >= k_p, k <= k_p),
            )
            k = jnp.where(keep, k, k_p)
            v = jnp.where(keep, v, v_p)
            stride //= 2
        size *= 2
    return k[:n], v[:n]


def sort_particles_by_depth(positions, camera_position, alive):
    """Back-to-front particle order (reference: particle depth sort via
    bitonic; dead particles sort last)."""
    d = jnp.linalg.norm(positions - camera_position, axis=-1)
    key = jnp.where(alive, -d, jnp.inf)  # farthest first; dead last
    _, order = bitonic_sort_kv(key, jnp.arange(positions.shape[0], dtype=jnp.int32))
    return order


def self_test(num_elements: int = 1000, descending: bool = False,
              seed: int = 0) -> bool:
    """Device-vs-host check (reference: testBitonicSortFloat,
    bitonic_sort.cpp:215-281)."""
    rng = np.random.default_rng(seed)
    keys = rng.normal(size=num_elements).astype(np.float32)
    vals = np.arange(num_elements, dtype=np.int32)
    k, v = bitonic_sort_kv(jnp.asarray(keys), jnp.asarray(vals),
                           descending=descending)
    k, v = np.asarray(k), np.asarray(v)
    ref = np.sort(keys)[::-1] if descending else np.sort(keys)
    if not np.allclose(k, ref):
        return False
    # Index integrity: values must be the permutation that sorts the keys.
    return bool(np.allclose(keys[v], k))
