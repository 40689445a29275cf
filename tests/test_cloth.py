"""Cloth tests: hanging under gravity, constraint satisfaction, wind,
collision projection, batching."""

import pytest
import jax
import jax.numpy as jnp
import numpy as np
from functools import partial

from d3d12renderer_jax.physics import cloth as cl

DT = 1.0 / 120.0


def settle(params, state, steps, **kw):
    sim = jax.jit(lambda s: cl.simulate(params, s, DT, **kw))
    for _ in range(steps):
        state = sim(state)
    return jax.device_get(state)


def test_hanging_cloth_reaches_equilibrium():
    params, state = cl.create_cloth(1.0, 1.0, 9, 9, total_mass=1.0, damping=3.0)
    final = settle(params, state, 1800)
    # Top row pinned.
    np.testing.assert_allclose(final.positions[0], np.asarray(state.positions)[0],
                               atol=1e-5)
    # Bottom row hangs below the top row.
    assert final.positions[-1, :, 1].mean() < -0.7
    # Velocities damped to near zero.
    assert np.abs(final.velocities).max() < 0.2
    assert np.isfinite(final.positions).all()


def test_stretch_constraints_hold():
    params, state = cl.create_cloth(1.0, 1.0, 9, 9, total_mass=1.0,
                                    stiffness=0.9, damping=3.0)
    final = settle(params, state, 1200, position_iterations=4)
    # Neighbor distances stay near rest length (some sag stretch allowed).
    rest = 1.0 / 8
    p = final.positions
    d_down = np.linalg.norm(p[1:] - p[:-1], axis=-1)
    assert d_down.max() < rest * 1.3


def test_wind_pushes_cloth():
    params, state = cl.create_cloth(1.0, 1.0, 9, 9, total_mass=1.0)

    @jax.jit
    def sim(s):
        s = cl.apply_wind(s, jnp.array([0.0, 0.0, 30.0]))
        return cl.simulate(params, s, DT)

    for _ in range(300):
        state = sim(state)
    final = jax.device_get(state)
    # Cloth blown in +z: free rows displaced from the initial plane.
    assert final.positions[-1, :, 2].mean() > -0.9


def test_sphere_collision_projection():
    params, state = cl.create_cloth(1.0, 1.0, 17, 17, total_mass=1.0)
    centers = jnp.array([[0.0, -0.5, -0.5]])
    radii = jnp.array([0.3])
    collide = partial(cl.collide_spheres, centers=centers, radii=radii)
    final = settle(params, state, 400, position_iterations=2, collide_fn=collide)
    # No particle inside the sphere.
    d = np.linalg.norm(final.positions.reshape(-1, 3) - np.array([0, -0.5, -0.5]),
                       axis=-1)
    assert d.min() > 0.3 - 0.02


def test_batched_cloth_vmap():
    params, state = cl.create_cloth(1.0, 1.0, 9, 9, total_mass=1.0)
    batch = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (4,) + x.shape), state
    )
    sim = jax.jit(jax.vmap(lambda s: cl.simulate(params, s, DT)))
    for _ in range(60):
        batch = sim(batch)
    out = jax.device_get(batch)
    assert np.isfinite(out.positions).all()
    # All batch elements identical (same initial state, deterministic sim).
    np.testing.assert_allclose(out.positions[0], out.positions[3], atol=1e-6)


@pytest.mark.slow
def test_cloth_drapes_over_moving_rigid_sphere():
    """Coupled step: a rigid sphere rolls under a hanging cloth and the cloth
    stays outside it throughout (BASELINE config 3)."""
    import jax

    from d3d12renderer_jax.physics.builder import SceneBuilder
    from d3d12renderer_jax.physics.cloth_coupling import step_cloth_with_bodies
    from d3d12renderer_jax.physics.step import physics_step
    from d3d12renderer_jax.physics.types import PhysicsSettings

    b = SceneBuilder()
    b.add_static_plane((0, 1, 0), -3.0)
    ball = b.add_body(position=(-2.0, -0.8, -0.5), gravity_factor=0.0,
                      linear_damping=0.0)
    b.add_sphere_collider(ball, radius=0.4)
    arch, body_state = b.finalize()
    body_state = body_state.replace(
        vel=body_state.vel.at[0].set(jnp.array([1.5, 0.0, 0.0])))

    params, cloth_state = cl.create_cloth(2.0, 2.0, 17, 17, total_mass=1.0,
                                          damping=1.0)
    settings = PhysicsSettings()

    @jax.jit
    def step(cs, bs):
        bs, _ = physics_step(arch, bs, settings, DT)
        cs = step_cloth_with_bodies(params, cs, arch, bs, DT)
        return cs, bs

    min_clearance = 1e9
    for i in range(240):
        cloth_state, body_state = step(cloth_state, body_state)
        if i % 20 == 0:
            d = np.linalg.norm(
                np.asarray(cloth_state.positions).reshape(-1, 3)
                - np.asarray(body_state.pos[0]), axis=-1).min()
            min_clearance = min(min_clearance, d)
    # Ball passed under the cloth footprint.
    assert float(body_state.pos[0, 0]) > 0.5
    # Cloth never penetrates deeply (margin 1cm, slack for projection order).
    assert min_clearance > 0.4 - 0.08
    assert np.isfinite(np.asarray(cloth_state.positions)).all()
