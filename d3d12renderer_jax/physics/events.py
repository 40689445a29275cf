"""Non-collision interactions and event tensors.

Reference: src/physics/physics.cpp:952 (force fields + triggers evaluated in
the step), :1037 (collision begin/end callbacks carrying contact velocity —
used e.g. for impact sounds, application.cpp:231-240), :555
testPhysicsInteraction (ray-poke impulse).

Design: callbacks become EVENT TENSORS — fixed-shape masks over the
static candidate tables, with previous-frame masks carried in user state.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..core import maths as m
from .narrow import ContactTable
from .types import BodyState, SceneArchetype


def apply_force_fields(arch: SceneArchetype, state: BodyState):
    """Per-body force contribution from spherical force fields.

    Returns (N, 3) forces; add into BodyState.force before stepping."""
    if arch.ff_center.shape[0] == 0:
        return jnp.zeros_like(state.pos)
    d = state.pos[:, None, :] - arch.ff_center[None, :, :]
    inside = jnp.linalg.norm(d + 1e-9, axis=-1) < arch.ff_radius[None, :]
    return jnp.sum(jnp.where(inside[..., None], arch.ff_force[None], 0.0), 1)


def evaluate_triggers(arch: SceneArchetype, state: BodyState,
                      prev_inside: Optional[jnp.ndarray] = None):
    """Trigger overlap + enter/leave events.

    Returns (inside (N, TR) bool, enter, leave).  Carry `inside` across steps
    (the tensor form of trigger callbacks, physics.cpp:1037)."""
    tr = arch.trigger_center.shape[0]
    n = state.pos.shape[0]
    if tr == 0:
        z = jnp.zeros((n, 0), bool)
        return z, z, z
    d = jnp.linalg.norm(
        state.pos[:, None, :] - arch.trigger_center[None] + 1e-9, axis=-1)
    inside = d < arch.trigger_radius[None]
    if prev_inside is None:
        prev_inside = jnp.zeros_like(inside)
    return inside, inside & ~prev_inside, prev_inside & ~inside


class CollisionEvents(NamedTuple):
    begin: jnp.ndarray             # (P,) rows newly in contact
    end: jnp.ndarray               # (P,) rows leaving contact
    active: jnp.ndarray            # (P,) carry to next step
    approach_speed: jnp.ndarray    # (P,) normal closing speed at begin


def collision_events(contacts: ContactTable, vel, omega,
                     prev_active: Optional[jnp.ndarray] = None,
                     pos=None) -> CollisionEvents:
    """Begin/end contact events with impact speed (reference:
    collision begin/end callbacks w/ contact velocity, physics.cpp:1037).

    `pos` (body centers, same indexing as vel/omega) gives the angular
    term its correct lever arm (contact point - center).  Without it the
    angular contribution is omitted — a world-space point is NOT a lever
    arm."""
    active = contacts.active
    if prev_active is None:
        prev_active = jnp.zeros_like(active)
    ia, ib = contacts.body_a, contacts.body_b
    p = contacts.point[:, 0]
    if pos is None:
        va = vel[ia]
        vb = vel[ib]
    else:
        va = vel[ia] + jnp.cross(omega[ia], p - pos[ia])
        vb = vel[ib] + jnp.cross(omega[ib], p - pos[ib])
    approach = -jnp.sum((vb - va) * contacts.normal, -1)
    return CollisionEvents(
        begin=active & ~prev_active,
        end=prev_active & ~active,
        active=active,
        approach_speed=jnp.where(active, jnp.maximum(approach, 0.0), 0.0),
    )


def ray_poke(arch: SceneArchetype, state: BodyState, origin, direction,
             strength: float = 1000.0, exact: bool = False):
    """Apply an impulse force along a ray to the nearest body hit
    (reference: physics.cpp:555 testPhysicsInteraction).

    Default path: sphere-approximate intersection against collider bounds —
    cheap enough for in-env pokes under vmap.  ``exact=True`` routes through
    :func:`d3d12renderer_jax.physics.raycast.ray_cast` (the exact
    per-primitive tests, reference bounding_volumes.cpp) so the force is
    applied at the true surface point — the editor-picking behavior."""
    origin = jnp.asarray(origin)
    direction = m.noz(jnp.asarray(direction))

    if exact:
        from .raycast import ray_cast

        h = ray_cast(arch, state, origin, direction)
        body_hit = h.hit & (h.body >= 0)
        body = jnp.clip(h.body, 0, state.pos.shape[-2] - 1)
        force = direction * strength * body_hit
        torque = jnp.cross(h.point - state.pos[body], force)
        return state.replace(
            force=state.force.at[body].add(force),
            torque=state.torque.at[body].add(torque),
        )

    from .collide import collider_world_poses

    wpos, _ = collider_world_poses(arch, state)
    r = arch.col_bound_radius

    oc = wpos - origin
    t_close = jnp.sum(oc * direction, -1)
    perp = oc - direction * t_close[:, None]
    miss_sq = jnp.sum(perp * perp, -1)
    hit = (miss_sq < r * r) & (t_close > 0)
    t_hit = jnp.where(hit, t_close, jnp.inf)
    best = jnp.argmin(t_hit)
    any_hit = jnp.isfinite(t_hit[best])

    body = arch.col_body[best]
    point = origin + direction * t_close[best]
    force = direction * strength * any_hit
    torque = jnp.cross(point - state.pos[body], force)
    return state.replace(
        force=state.force.at[body].add(force),
        torque=state.torque.at[body].add(torque),
    )
