"""Force fields, triggers, collision events, ray poke."""

import pytest
import jax
import jax.numpy as jnp
import numpy as np

from d3d12renderer_jax.physics import events as ev
from d3d12renderer_jax.physics.builder import SceneBuilder
from d3d12renderer_jax.physics.collide import generate_contacts
from d3d12renderer_jax.physics.step import physics_step
from d3d12renderer_jax.physics.types import PhysicsSettings

DT = 1 / 60


def test_force_field_pushes_body():
    b = SceneBuilder()
    body = b.add_body(position=(0.0, 5.0, 0.0), gravity_factor=0.0,
                      linear_damping=0.0)
    b.add_sphere_collider(body, radius=0.3, density=100.0)
    b.add_force_field(center=(0.0, 5.0, 0.0), radius=2.0,
                      force=(50.0, 0.0, 0.0))
    arch, state = b.finalize()
    step = jax.jit(lambda s: physics_step(arch, s, PhysicsSettings(), DT)[0])
    for _ in range(60):
        state = step(state)
    final = jax.device_get(state)
    assert final.vel[0][0] > 0.1       # pushed +x while inside
    assert final.pos[0][0] > 0.01


def test_trigger_enter_leave():
    b = SceneBuilder()
    body = b.add_body(position=(0.0, 3.0, 0.0))
    b.add_sphere_collider(body, radius=0.2)
    b.add_trigger(center=(0.0, 1.0, 0.0), radius=0.8)
    arch, state = b.finalize()
    step = jax.jit(lambda s: physics_step(arch, s, PhysicsSettings(), DT)[0])

    inside = None
    entered = exited = False
    for _ in range(120):  # falls through the trigger volume
        state = step(state)
        inside, enter, leave = ev.evaluate_triggers(arch, state, inside)
        entered = entered or bool(enter.any())
        exited = exited or bool(leave.any())
    assert entered and exited


@pytest.mark.slow
def test_collision_begin_event_with_impact_speed():
    b = SceneBuilder()
    b.add_static_plane((0, 1, 0), 0.0)
    body = b.add_body(position=(0.0, 1.0, 0.0))
    b.add_sphere_collider(body, radius=0.5)
    arch, state = b.finalize()
    step = jax.jit(lambda s: physics_step(arch, s, PhysicsSettings(), DT)[0])

    step_with_contacts = jax.jit(
        lambda s: physics_step(arch, s, PhysicsSettings(), DT))

    prev = None
    impact = 0.0
    began = False
    for _ in range(60):
        # Contacts returned by physics_step are the in-substep detections
        # (pre-solve); paired with pre-step velocities they carry the true
        # impact speed, like the reference's collision-begin callbacks.
        pre_vel = jnp.concatenate([state.vel, jnp.zeros((1, 3))])
        pre_omega = jnp.concatenate([state.omega, jnp.zeros((1, 3))])
        state, contacts = step_with_contacts(state)
        e = ev.collision_events(contacts, pre_vel, pre_omega, prev)
        if bool(e.begin.any()) and not began:
            began = True
            impact = float(e.approach_speed.max())
        prev = e.active
    assert began
    assert impact > 1.0  # fell ~0.5 m -> ~3 m/s


def test_ray_poke_applies_impulse():
    b = SceneBuilder()
    body = b.add_body(position=(0.0, 2.0, 0.0), gravity_factor=0.0)
    b.add_box_collider(body, half_extents=(0.5, 0.5, 0.5))
    arch, state = b.finalize()
    poked = ev.ray_poke(arch, state, origin=(-5.0, 2.2, 0.0),
                        direction=(1.0, 0.0, 0.0))
    f = np.asarray(poked.force[0])
    t = np.asarray(poked.torque[0])
    assert f[0] > 900.0
    assert np.abs(t).max() > 0.1  # off-center hit produces torque
