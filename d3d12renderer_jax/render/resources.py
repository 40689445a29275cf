"""Shared render resources: defaults built once and reused.

Reference: src/rendering/render_resources.h:21 — global default textures
(white/black/normal), the BRDF LUT, the shadow atlas, and an aliased
temp-resource pool.  Form: lazily-built module-level arrays (XLA owns
transient buffers, so the temp pool maps to donated jit temporaries).
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

_cache = {}


def default_white(size: int = 4):
    key = ("white", size)
    if key not in _cache:
        _cache[key] = jnp.ones((size, size, 3))
    return _cache[key]


def default_black(size: int = 4):
    key = ("black", size)
    if key not in _cache:
        _cache[key] = jnp.zeros((size, size, 3))
    return _cache[key]


def default_normal_map(size: int = 4):
    """Flat tangent-space normal (0.5, 0.5, 1)."""
    key = ("normal", size)
    if key not in _cache:
        _cache[key] = jnp.broadcast_to(jnp.array([0.5, 0.5, 1.0]),
                                       (size, size, 3))
    return _cache[key]


def brdf_lookup(resolution: int = 64):
    """The split-sum BRDF LUT, built once (reference: render_resources.cpp
    bakes it at startup via integrate_brdf_cs)."""
    key = ("brdf", resolution)
    if key not in _cache:
        from .ibl import brdf_lut

        _cache[key] = brdf_lut(resolution=resolution)
    return _cache[key]


def checker_texture(size: int = 64, squares: int = 8):
    key = ("checker", size, squares)
    if key not in _cache:
        i = jnp.arange(size) * squares // size
        pattern = (i[:, None] + i[None, :]) % 2
        _cache[key] = jnp.where(pattern[..., None] > 0, 0.8, 0.3) * jnp.ones(3)
    return _cache[key]


def clear_cache():
    _cache.clear()
