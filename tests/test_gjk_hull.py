"""GJK/EPA narrowphase and convex-hull collider tests."""

import pytest
import jax
import jax.numpy as jnp
import numpy as np

from d3d12renderer_jax.physics.builder import SceneBuilder
from d3d12renderer_jax.physics.gjk import gjk, gjk_epa_contact, make_shape_ref
from d3d12renderer_jax.physics.step import physics_step
from d3d12renderer_jax.physics.types import (
    SHAPE_BOX, SHAPE_CAPSULE, SHAPE_CYLINDER, SHAPE_HULL, SHAPE_SPHERE,
    PhysicsSettings,
)

DT = 1.0 / 60.0
SETTINGS = PhysicsSettings()


def _ref(types, sizes, poss, rots=None, hv=None, hm=None):
    n = len(types)
    rots = rots if rots is not None else [[0, 0, 0, 1]] * n
    return make_shape_ref(
        jnp.array(types, jnp.int32), jnp.array(sizes, jnp.float32),
        jnp.array(poss, jnp.float32), jnp.array(rots, jnp.float32), hv, hm,
    )


@pytest.mark.slow
def test_gjk_sphere_pair_exact():
    a = _ref([SHAPE_SPHERE] * 2, [[1, 0, 0]] * 2, [[0, 0, 0]] * 2)
    b = _ref([SHAPE_SPHERE] * 2, [[1, 0, 0]] * 2, [[1.5, 0, 0], [3.0, 0, 0]])
    n, pt, d, hit = jax.jit(gjk_epa_contact)(a, b)
    assert bool(hit[0, 0]) and not bool(hit[1, 0])
    np.testing.assert_allclose(np.asarray(n[0]), [1, 0, 0], atol=1e-3)
    assert abs(float(d[0, 0]) - 0.5) < 1e-3
    res = jax.jit(gjk)(a, b)
    # Sphere cores are points: core distance = center distance; surface
    # distance = core distance - margins = 1.
    assert abs(float(res["distance"][1]) - 3.0) < 1e-3
    msum = float(a.margin[1] + b.margin[1])
    assert abs(float(res["distance"][1]) - msum - 1.0) < 1e-3


@pytest.mark.slow
def test_gjk_deep_box_overlap():
    a = _ref([SHAPE_BOX], [[1, 1, 1]], [[0, 0, 0]])
    b = _ref([SHAPE_BOX], [[1, 1, 1]], [[1.5, 0.2, 0.1]])
    n, pt, d, hit = jax.jit(gjk_epa_contact)(a, b)
    assert bool(hit[0, 0])
    assert abs(float(d[0, 0]) - 0.5) < 0.02
    np.testing.assert_allclose(np.asarray(n[0]), [1, 0, 0], atol=0.05)


def test_cylinder_box_contact_exact():
    a = _ref([SHAPE_BOX], [[1, 0.5, 1]], [[0, 0, 0]])
    b = _ref([SHAPE_CYLINDER], [[0.3, 0.4, 0]], [[0.0, 0.85, 0.0]])
    n, pt, d, hit = jax.jit(gjk_epa_contact)(a, b)
    assert bool(hit[0, 0])
    assert abs(float(d[0, 0]) - 0.05) < 5e-3
    np.testing.assert_allclose(np.asarray(n[0]), [0, 1, 0], atol=0.05)


@pytest.mark.slow
def test_hull_box_drop_rests_like_box():
    """A cube-shaped hull must rest at the same height as a box collider."""
    pts = [[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5) for z in (-0.5, 0.5)]
    b = SceneBuilder()
    b.add_static_plane((0, 1, 0), 0.0)
    body = b.add_body(position=(0.0, 1.2, 0.0))
    b.add_hull_collider(body, pts, density=500.0)
    arch, state = b.finalize()
    # Hull mass properties match a solid cube.
    assert abs(1.0 / float(arch.inv_mass[0]) - 500.0 * 1.0) < 1.0

    step = jax.jit(lambda s: physics_step(arch, s, SETTINGS, DT)[0])
    for _ in range(180):
        state = step(state)
    final = jax.device_get(state)
    assert abs(final.pos[0][1] - 0.5) < 0.02
    assert np.abs(final.vel).max() < 0.05


@pytest.mark.slow
def test_hull_vs_hull_stack():
    pts = [[x, y, z] for x in (-0.4, 0.4) for y in (-0.4, 0.4) for z in (-0.4, 0.4)]
    b = SceneBuilder()
    b.add_static_plane((0, 1, 0), 0.0)
    b1 = b.add_body(position=(0.0, 0.5, 0.0))
    b.add_hull_collider(b1, pts)
    b2 = b.add_body(position=(0.05, 1.4, 0.0))
    b.add_hull_collider(b2, pts)
    arch, state = b.finalize()

    step = jax.jit(lambda s: physics_step(arch, s, SETTINGS, DT)[0])
    for _ in range(240):
        state = step(state)
    final = jax.device_get(state)
    assert abs(final.pos[0][1] - 0.4) < 0.05
    assert abs(final.pos[1][1] - 1.2) < 0.1
    assert np.isfinite(final.pos).all()


def test_tetrahedron_hull_mass_properties():
    """Irregular hull: sanity-check COG inside, positive definite inertia."""
    pts = [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [0.3, 0.3, 0.3]]
    b = SceneBuilder()
    body = b.add_body(position=(0, 5, 0))
    b.add_hull_collider(body, pts, density=1000.0)
    arch, state = b.finalize()
    mass = 1.0 / float(arch.inv_mass[0])
    # Tetra volume = 1/6.
    assert abs(mass - 1000.0 / 6.0) < 2.0
    evals = np.linalg.eigvalsh(np.linalg.inv(np.asarray(arch.inv_inertia[0])))
    assert (evals > 0).all()
