"""Particle system core: fixed-capacity pool with masked emit/sim.

Reference: src/particles/particles.h:31-90 + particles.cpp:107 — a GPU
freelist with alive/dead index lists, emit/sim compute passes, indirect draws,
optional bitonic depth sort.  Design: the pool is a fixed-shape pytree;
"dead list" = ~alive mask; emission claims the first K dead slots via a
masked argsort (fixed shapes, no indirect dispatch needed — XLA sees one
static program).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import jax
import jax.numpy as jnp
from ..core import struct


@struct.dataclass
class ParticlePool:
    position: jnp.ndarray    # (N, 3)
    velocity: jnp.ndarray    # (N, 3)
    age: jnp.ndarray         # (N,)
    lifetime: jnp.ndarray    # (N,)  <= 0 on dead slots
    alive: jnp.ndarray       # (N,) bool
    data: Dict[str, jnp.ndarray]  # per-system extra channels
    rng: jnp.ndarray         # PRNG key
    emit_carry: jnp.ndarray  # () float32 fractional-emission accumulator

    @property
    def capacity(self):
        return self.position.shape[0]

    @property
    def num_alive(self):
        return jnp.sum(self.alive)


def create_pool(capacity: int, key, extra: Optional[Dict[str, tuple]] = None
                ) -> ParticlePool:
    """extra: {name: trailing_shape} additional per-particle channels."""
    z3 = jnp.zeros((capacity, 3))
    data = {
        name: jnp.zeros((capacity,) + tuple(shape))
        for name, shape in (extra or {}).items()
    }
    return ParticlePool(
        position=z3, velocity=z3,
        age=jnp.zeros(capacity), lifetime=jnp.zeros(capacity),
        alive=jnp.zeros(capacity, bool), data=data, rng=key,
        emit_carry=jnp.zeros(()),
    )


def step_pool(
    pool: ParticlePool,
    dt: float,
    emit_rate: float,
    emit_fn: Callable,       # emit_fn(key, count_mask_slots, pool) -> field dict
    sim_fn: Callable,        # sim_fn(pool, dt) -> field dict (updates)
    max_emit_per_step: int = 64,
) -> ParticlePool:
    """One emit+sim tick (reference: particle_system emit/sim passes).

    `emit_fn(key, n_slots)` returns dict with (K, ...) arrays for 'position',
    'velocity', 'lifetime' and any extra channels, where K =
    max_emit_per_step; only the first `num_to_emit` slots actually spawn.
    `sim_fn(pool, dt)` returns updated full-size field dict."""
    # --- age + kill ------------------------------------------------------
    age = pool.age + dt
    alive = pool.alive & (age < pool.lifetime)

    # --- emission: claim dead slots (reference: freelist pop) -------------
    rng, k_emit = jax.random.split(pool.rng)
    want = emit_rate * dt + pool.emit_carry
    n_emit = jnp.minimum(jnp.floor(want), max_emit_per_step)
    emit_carry = want - n_emit

    dead_first = jnp.argsort(alive, stable=True)      # dead slots first
    slots = dead_first[:max_emit_per_step]            # (K,)
    slot_ok = (jnp.arange(max_emit_per_step) < n_emit) & ~alive[slots]

    fields = emit_fn(k_emit, max_emit_per_step)
    position = pool.position.at[slots].set(
        jnp.where(slot_ok[:, None], fields["position"], pool.position[slots]))
    velocity = pool.velocity.at[slots].set(
        jnp.where(slot_ok[:, None], fields["velocity"], pool.velocity[slots]))
    lifetime = pool.lifetime.at[slots].set(
        jnp.where(slot_ok, fields["lifetime"], pool.lifetime[slots]))
    age = age.at[slots].set(jnp.where(slot_ok, 0.0, age[slots]))
    alive = alive.at[slots].set(slot_ok | alive[slots])
    data = dict(pool.data)
    for name in data:
        if name in fields:
            data[name] = data[name].at[slots].set(
                jnp.where(
                    slot_ok.reshape((-1,) + (1,) * (data[name].ndim - 1)),
                    fields[name], data[name][slots],
                )
            )

    pool = pool.replace(position=position, velocity=velocity, age=age,
                        lifetime=lifetime, alive=alive, data=data, rng=rng,
                        emit_carry=emit_carry)

    # --- simulate ----------------------------------------------------------
    updates = sim_fn(pool, dt)
    mask = pool.alive
    new = {}
    for name in ("position", "velocity"):
        if name in updates:
            cur = getattr(pool, name)
            new[name] = jnp.where(mask[:, None], updates[name], cur)
    data = dict(pool.data)
    for name, v in updates.items():
        if name in data:
            mm = mask.reshape((-1,) + (1,) * (v.ndim - 1))
            data[name] = jnp.where(mm, v, data[name])
    return pool.replace(data=data, **new)
