"""Exact ray-vs-primitive tests (reference: bounding_volumes.cpp ray tests
used by editor picking + physics.cpp:555 testPhysicsInteraction).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from d3d12renderer_jax.core import maths as m
from d3d12renderer_jax.physics.builder import SceneBuilder
from d3d12renderer_jax.physics.raycast import (
    ray_cast,
    ray_vs_box,
    ray_vs_capsule,
    ray_vs_cylinder,
    ray_vs_hull,
    ray_vs_plane,
    ray_vs_sphere,
)

O = jnp.asarray
V3 = lambda *a: jnp.asarray(a, jnp.float32)


def test_ray_vs_sphere_hit_and_inside():
    t, n = ray_vs_sphere(V3(0, 0, -5), V3(0, 0, 1), V3(0, 0, 0)[None], O([1.0]))
    assert np.isclose(float(t[0]), 4.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(n[0]), [0, 0, -1], atol=1e-5)
    # Ray starting inside reports the exit point.
    t, n = ray_vs_sphere(V3(0, 0, 0), V3(0, 0, 1), V3(0, 0, 0)[None], O([1.0]))
    assert np.isclose(float(t[0]), 1.0, atol=1e-5)
    # Miss.
    t, _ = ray_vs_sphere(V3(0, 3, -5), V3(0, 0, 1), V3(0, 0, 0)[None], O([1.0]))
    assert float(t[0]) > 1e29


def test_ray_vs_capsule_side_and_cap():
    p0, p1 = V3(0, -1, 0)[None], V3(0, 1, 0)[None]
    t, n = ray_vs_capsule(V3(-5, 0.5, 0), V3(1, 0, 0), p0, p1, O([0.5]))
    assert np.isclose(float(t[0]), 4.5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(n[0]), [-1, 0, 0], atol=1e-5)
    # Straight down onto the top cap: hits the p1 hemisphere at y = 1.5.
    t, n = ray_vs_capsule(V3(0, 5, 0), V3(0, -1, 0), p0, p1, O([0.5]))
    assert np.isclose(float(t[0]), 3.5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(n[0]), [0, 1, 0], atol=1e-5)
    # Parallel to the axis but offset beyond the radius: miss.
    t, _ = ray_vs_capsule(V3(2, -5, 0), V3(0, 1, 0), p0, p1, O([0.5]))
    assert float(t[0]) > 1e29


def test_ray_vs_box_rotated():
    pos = V3(0, 0, 0)[None]
    ident = jnp.broadcast_to(m.QUAT_IDENTITY, (1, 4))
    half = O([[1.0, 2.0, 3.0]])
    t, n = ray_vs_box(V3(-5, 0, 0), V3(1, 0, 0), pos, ident, half)
    assert np.isclose(float(t[0]), 4.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(n[0]), [-1, 0, 0], atol=1e-5)
    # 90 deg about Y maps the local z half-extent (3) onto world x.
    rot = m.quat_from_axis_angle(V3(0, 1, 0), jnp.float32(math.pi / 2))[None]
    t, n = ray_vs_box(V3(-5, 0, 0), V3(1, 0, 0), pos, rot, half)
    assert np.isclose(float(t[0]), 2.0, atol=1e-4)
    np.testing.assert_allclose(np.asarray(n[0]), [-1, 0, 0], atol=1e-4)
    # From inside: exit through +x face with inward normal.
    t, n = ray_vs_box(V3(0, 0, 0), V3(1, 0, 0), pos, ident, half)
    assert np.isclose(float(t[0]), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(n[0]), [-1, 0, 0], atol=1e-4)


def test_ray_vs_cylinder_side_cap_miss():
    pos = V3(0, 0, 0)[None]
    ident = jnp.broadcast_to(m.QUAT_IDENTITY, (1, 4))
    r, h = O([1.0]), O([2.0])
    t, n = ray_vs_cylinder(V3(-5, 1, 0), V3(1, 0, 0), pos, ident, r, h)
    assert np.isclose(float(t[0]), 4.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(n[0]), [-1, 0, 0], atol=1e-5)
    t, n = ray_vs_cylinder(V3(0.5, 5, 0), V3(0, -1, 0), pos, ident, r, h)
    assert np.isclose(float(t[0]), 3.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(n[0]), [0, 1, 0], atol=1e-5)
    t, _ = ray_vs_cylinder(V3(-5, 3, 0), V3(1, 0, 0), pos, ident, r, h)
    assert float(t[0]) > 1e29


def test_ray_vs_hull_matches_box():
    """A cube's corner cloud must agree with the analytic OBB test."""
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)], np.float32)
    verts = jnp.asarray(corners)[None]
    mask = jnp.ones((1, 8), bool)
    rot = m.quat_from_axis_angle(V3(0, 1, 0), jnp.float32(0.4))[None]
    pos = V3(0.3, -0.2, 0.1)[None]
    o, d = V3(-6, 0, 0), V3(1, 0, 0)
    t_h, n_h = ray_vs_hull(o, d, pos, rot, verts, mask)
    t_b, n_b = ray_vs_box(o, d, pos, rot, O([[1.0, 1.0, 1.0]]))
    assert np.isclose(float(t_h[0]), float(t_b[0]), atol=5e-3)
    assert float(np.dot(np.asarray(n_h[0]), np.asarray(n_b[0]))) > 0.95
    # Miss: aimed well above.
    t_m, _ = ray_vs_hull(V3(-6, 5, 0), d, pos, rot, verts, mask)
    assert float(t_m[0]) > 1e29


def test_ray_vs_plane():
    t, n = ray_vs_plane(V3(0, 3, 0), V3(0, -1, 0), V3(0, 1, 0)[None], O([0.0]))
    assert np.isclose(float(t[0]), 3.0, atol=1e-6)
    # Back face: ray travelling with the normal never hits.
    t, _ = ray_vs_plane(V3(0, -3, 0), V3(0, -1, 0), V3(0, 1, 0)[None], O([0.0]))
    assert float(t[0]) > 1e29


def test_scene_ray_cast_nearest_and_statics():
    b = SceneBuilder()
    s = b.add_body(position=(0.0, 1.0, 0.0))
    b.add_sphere_collider(s, radius=1.0)
    box = b.add_body(position=(0.0, 1.0, 6.0))
    b.add_box_collider(box, half_extents=(1.0, 1.0, 1.0))
    b.add_static_plane((0.0, 1.0, 0.0), 0.0)
    arch, state = b.finalize()

    # Straight down the z axis: the sphere (t=4) occludes the box (t=9).
    hit = ray_cast(arch, state, (0.0, 1.0, -5.0), (0.0, 0.0, 1.0))
    assert bool(hit.hit) and int(hit.kind) == 0
    assert np.isclose(float(hit.t), 4.0, atol=1e-4)
    assert int(hit.body) == s
    np.testing.assert_allclose(np.asarray(hit.normal), [0, 0, -1], atol=1e-4)

    # Past the sphere: the box face at z = 5.
    hit = ray_cast(arch, state, (3.0, 1.0, -5.0), (0.0, 0.0, 1.0))
    assert not bool(hit.hit)
    hit = ray_cast(arch, state, (0.5, 1.0, 3.0), (0.0, 0.0, 1.0))
    assert bool(hit.hit) and int(hit.body) == box
    assert np.isclose(float(hit.t), 2.0, atol=1e-4)

    # Downward: the ground plane, tagged as static.
    hit = ray_cast(arch, state, (9.0, 2.0, 0.0), (0.0, -1.0, 0.0))
    assert bool(hit.hit) and int(hit.kind) == 1 and int(hit.body) == -1
    assert np.isclose(float(hit.t), 2.0, atol=1e-4)


def test_exact_ray_poke_hits_surface_body():
    """exact=True poke applies force/torque to the body whose SURFACE the ray
    hits — here the ray grazes past a big sphere's bounding radius but only
    actually strikes the box behind it."""
    from d3d12renderer_jax.physics.events import ray_poke

    b = SceneBuilder()
    pole = b.add_body(position=(0.0, 1.0, 0.0))
    # Thin tall box: bounding radius ~2.0 but only 0.1 wide in x.
    b.add_box_collider(pole, half_extents=(0.1, 2.0, 0.1))
    ball = b.add_body(position=(1.0, 1.0, 6.0))
    b.add_sphere_collider(ball, radius=1.0)
    arch, state = b.finalize()

    # Ray at x=1: inside the pole's BOUNDING sphere (perp distance 1 < ~2,
    # the approximate path would poke the pole) but misses the actual box
    # (|x| > 0.1); the exact path must poke the ball behind it.
    out = ray_poke(arch, state, (1.0, 1.0, -5.0), (0.0, 0.0, 1.0),
                   strength=100.0, exact=True)
    f = np.asarray(out.force)
    assert np.linalg.norm(f[ball]) > 99.0
    assert np.linalg.norm(f[pole]) < 1e-6


@pytest.mark.slow
def test_scene_ray_cast_terrain():
    h = np.full((9, 9), 1.25, np.float32)
    b = SceneBuilder()
    b.add_terrain(h, origin=(-4.0, 0.0, -4.0), cell_size=1.0)
    s = b.add_body(position=(0.0, 3.0, 0.0))
    b.add_sphere_collider(s, radius=0.25)
    arch, state = b.finalize()

    hit = ray_cast(arch, state, (1.5, 6.0, 0.5), (0.0, -1.0, 0.0))
    assert bool(hit.hit) and int(hit.kind) == 2
    assert np.isclose(float(hit.t), 4.75, atol=0.02)
    np.testing.assert_allclose(np.asarray(hit.normal), [0, 1, 0], atol=1e-3)
