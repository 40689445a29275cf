"""Physics MVP: integration, ground contacts, restitution, friction, stacking."""

import pytest
import jax
import jax.numpy as jnp
import numpy as np

from d3d12renderer_jax.physics import builder, step
from d3d12renderer_jax.physics.types import PhysicsSettings


def jit_stepper(arch, settings, h=None):
    h = h if h is not None else 1.0 / settings.frame_rate
    return jax.jit(
        lambda s: step.physics_step(arch, s, settings, h, num_substeps=1)[0]
    )


def run(stepper, state, n):
    for _ in range(n):
        state = stepper(state)
    return state


def test_free_fall_matches_closed_form():
    b = builder.SceneBuilder()
    body = b.add_body(position=(0, 10, 0), linear_damping=0.0, angular_damping=0.0)
    b.add_sphere_collider(body, radius=0.5)
    arch, state = b.finalize()

    settings = PhysicsSettings()
    h = 1.0 / settings.frame_rate
    n_steps = 60
    state = run(jit_stepper(arch, settings), state, n_steps)

    # semi-implicit Euler: y_n = y0 + g*h^2 * n(n+1)/2
    g = -9.81
    expected = 10.0 + g * h * h * n_steps * (n_steps + 1) / 2
    assert np.allclose(float(state.pos[0, 1]), expected, atol=1e-4)


def test_sphere_rests_on_plane():
    b = builder.SceneBuilder()
    b.add_static_plane((0, 1, 0), 0.0)
    body = b.add_body(position=(0, 2.0, 0))
    b.add_sphere_collider(body, radius=0.5, restitution=0.0)
    arch, state = b.finalize()

    settings = PhysicsSettings()
    state = run(jit_stepper(arch, settings), state, 400)

    y = float(state.pos[0, 1])
    assert abs(y - 0.5) < 0.01, f"resting height {y}, expected 0.5"
    assert abs(float(state.vel[0, 1])) < 0.05


def test_restitution_bounce():
    b = builder.SceneBuilder()
    b.add_static_plane((0, 1, 0), 0.0, restitution=0.0)
    body = b.add_body(position=(0, 2.0, 0), linear_damping=0.0)
    b.add_sphere_collider(body, radius=0.5, restitution=0.8)
    arch, state = b.finalize()

    settings = PhysicsSettings()
    stepper = jit_stepper(arch, settings)
    max_y_after_bounce = 0.0
    bounced = False
    for _ in range(600):
        state = stepper(state)
        vy = float(state.vel[0, 1])
        if vy > 0.1:
            bounced = True
        if bounced:
            max_y_after_bounce = max(max_y_after_bounce, float(state.pos[0, 1]))
    assert bounced, "sphere never bounced"
    # dropped from 1.5m above rest; e=0.8 -> rebound ≈ 0.64 * 1.5 = 0.96m
    rebound = max_y_after_bounce - 0.5
    assert 0.5 < rebound < 1.4, f"rebound height {rebound}"


def test_friction_stops_sliding_box():
    b = builder.SceneBuilder()
    b.add_static_plane((0, 1, 0), 0.0, friction=0.8)
    body = b.add_body(position=(0, 0.5, 0), linear_damping=0.0, angular_damping=0.0)
    b.add_box_collider(body, (0.5, 0.5, 0.5), friction=0.8)
    arch, state = b.finalize()
    state = state.replace(vel=state.vel.at[0, 0].set(2.0))

    settings = PhysicsSettings()
    state = run(jit_stepper(arch, settings), state, 300)
    speed = float(jnp.linalg.norm(state.vel[0]))
    assert speed < 0.05, f"box still sliding at {speed} m/s"


@pytest.mark.slow
def test_two_sphere_stack():
    b = builder.SceneBuilder()
    b.add_static_plane((0, 1, 0), 0.0)
    b0 = b.add_body(position=(0, 0.55, 0))
    b.add_sphere_collider(b0, radius=0.5)
    b1 = b.add_body(position=(0.01, 1.6, 0))
    b.add_sphere_collider(b1, radius=0.5)
    arch, state = b.finalize()

    settings = PhysicsSettings()
    state = run(jit_stepper(arch, settings), state, 500)

    y0, y1 = float(state.pos[0, 1]), float(state.pos[1, 1])
    assert abs(y0 - 0.5) < 0.05
    # top sphere either stacked (~1.5) or rolled off to the ground (~0.5)
    assert y1 < 1.7


@pytest.mark.slow
def test_batched_step_vmap():
    b = builder.SceneBuilder()
    b.add_static_plane((0, 1, 0), 0.0)
    body = b.add_body(position=(0, 2.0, 0))
    b.add_sphere_collider(body, radius=0.5)
    arch, state = b.finalize()

    batch = 16
    bstate = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (batch,) + x.shape), state
    )
    heights = 1.0 + jnp.arange(batch, dtype=jnp.float32) * 0.25
    bstate = bstate.replace(pos=bstate.pos.at[:, 0, 1].set(heights))

    settings = PhysicsSettings()
    stepper = step.make_batched_step(arch, settings, 1.0 / 60.0)
    for _ in range(180):
        bstate = stepper(bstate)
    ys = np.asarray(bstate.pos[:, 0, 1])
    assert np.all(np.abs(ys - 0.5) < 0.05), ys


@pytest.mark.slow
def test_box_stack_split_jacobi():
    b = builder.SceneBuilder()
    b.add_static_plane((0, 1, 0), 0.0)
    for i in range(3):
        body = b.add_body(position=(0, 0.5 + 1.01 * i, 0))
        b.add_box_collider(body, (0.5, 0.5, 0.5))
    arch, state = b.finalize()

    settings = PhysicsSettings(contact_mode="split_jacobi")
    state = run(jit_stepper(arch, settings), state, 400)
    ys = np.asarray(state.pos[:, 1])
    expected = np.array([0.5, 1.5, 2.5])
    assert np.all(np.abs(ys - expected) < 0.1), ys


@pytest.mark.slow
def test_box_stack_colored():
    b = builder.SceneBuilder()
    b.add_static_plane((0, 1, 0), 0.0)
    for i in range(3):
        body = b.add_body(position=(0, 0.5 + 1.01 * i, 0))
        b.add_box_collider(body, (0.5, 0.5, 0.5))
    arch, state = b.finalize()

    settings = PhysicsSettings(contact_mode="colored")
    state = run(jit_stepper(arch, settings), state, 400)
    ys = np.asarray(state.pos[:, 1])
    expected = np.array([0.5, 1.5, 2.5])
    assert np.all(np.abs(ys - expected) < 0.1), ys
