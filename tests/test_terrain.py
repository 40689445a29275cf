"""Terrain tests: heightmap generation, sampling, heightfield physics."""

import pytest
import jax
import jax.numpy as jnp
import numpy as np

from d3d12renderer_jax.physics.builder import SceneBuilder
from d3d12renderer_jax.physics.step import physics_step
from d3d12renderer_jax.physics.types import PhysicsSettings
from d3d12renderer_jax.terrain.heightmap import (
    generate_heightmap, heightmap_mesh, sample_height_bilinear,
)

DT = 1.0 / 60.0
SETTINGS = PhysicsSettings()


def test_heightmap_generation_statistics():
    h = np.asarray(generate_heightmap(resolution=64, amplitude=8.0, seed=3))
    assert h.shape == (64, 64)
    assert np.isfinite(h).all()
    assert 0.0 <= h.min() and h.max() <= 8.0
    assert h.std() > 0.3  # actually varied


def test_bilinear_sampling_matches_grid():
    h = jnp.asarray(np.arange(16, dtype=np.float32).reshape(4, 4))
    origin = jnp.array([0.0, 0.0, 0.0])
    # Exactly on grid point (2, 1): height = 2*4+1 = 9.
    hv, n = sample_height_bilinear(h, origin, 1.0, jnp.array(2.0), jnp.array(1.0))
    assert abs(float(hv) - 9.0) < 1e-5
    # Midpoint between (0,0) and (1,0): (0 + 4)/2 = 2.
    hv2, _ = sample_height_bilinear(h, origin, 1.0, jnp.array(0.5), jnp.array(0.0))
    assert abs(float(hv2) - 2.0) < 1e-5


def test_sphere_rests_on_flat_terrain():
    h = np.zeros((32, 32), np.float32) + 2.0  # flat at y=2
    b = SceneBuilder()
    b.add_terrain(h, origin=(-16.0, 0.0, -16.0), cell_size=1.0)
    ball = b.add_body(position=(0.0, 5.0, 0.0))
    b.add_sphere_collider(ball, radius=0.5)
    arch, state = b.finalize()

    step = jax.jit(lambda s: physics_step(arch, s, SETTINGS, DT)[0])
    for _ in range(240):
        state = step(state)
    final = jax.device_get(state)
    assert abs(final.pos[0][1] - 2.5) < 0.02


@pytest.mark.slow
def test_ball_rolls_downhill():
    # Inclined plane as heightfield: h = 0.3 * x.
    xs = np.arange(64, dtype=np.float32)
    h = np.broadcast_to(0.3 * xs[:, None], (64, 64)).copy()
    b = SceneBuilder()
    b.add_terrain(h, origin=(-32.0, 0.0, -32.0), cell_size=1.0, friction=0.3)
    ball = b.add_body(position=(0.0, 10.6, 0.0), linear_damping=0.0,
                      angular_damping=0.0)
    b.add_sphere_collider(ball, radius=0.5, friction=0.3)
    arch, state = b.finalize()

    step = jax.jit(lambda s: physics_step(arch, s, SETTINGS, DT)[0])
    for _ in range(240):
        state = step(state)
    final = jax.device_get(state)
    # Slope rises toward +x, so the ball rolls toward -x.
    assert final.pos[0][0] < -1.0
    assert np.isfinite(final.pos).all()


@pytest.mark.slow
def test_box_rests_on_bumpy_terrain():
    h = np.asarray(generate_heightmap(resolution=64, world_size=32.0,
                                      amplitude=1.5, seed=7))
    b = SceneBuilder()
    b.add_terrain(h, origin=(-16.0, 0.0, -16.0), cell_size=32.0 / 63)
    box = b.add_body(position=(0.0, 5.0, 0.0))
    b.add_box_collider(box, half_extents=(0.4, 0.4, 0.4))
    arch, state = b.finalize()

    step = jax.jit(lambda s: physics_step(arch, s, SETTINGS, DT)[0])
    for _ in range(300):
        state = step(state)
    final = jax.device_get(state)
    x, z = final.pos[0][0], final.pos[0][2]
    hv, _ = sample_height_bilinear(
        jnp.asarray(h), jnp.array([-16.0, 0.0, -16.0]), 32.0 / 63,
        jnp.array(x), jnp.array(z),
    )
    # Box rests near the surface (within a diagonal's reach).
    assert -0.05 < final.pos[0][1] - float(hv) < 0.8
    assert np.abs(final.vel[0]).max() < 0.5


def test_heightmap_mesh_valid():
    h = np.asarray(generate_heightmap(resolution=32, seed=5))
    mesh = heightmap_mesh(h, (-16, 0, -16), 1.0)
    assert mesh.indices.max() < len(mesh.positions)
    assert np.isfinite(mesh.positions).all()
    n = np.linalg.norm(mesh.normals, axis=-1)
    np.testing.assert_allclose(n, 1.0, atol=1e-3)
