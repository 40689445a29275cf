"""Min-max mip descent + triangle-exact heightfield collision
(VERDICT r1 item 9; reference: src/physics/heightmap_collision.cpp:509).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from d3d12renderer_jax.physics.builder import SceneBuilder
from d3d12renderer_jax.physics.heightmap_collision import (
    build_minmax_mips, vertex_vs_terrain_triangles,
)
from d3d12renderer_jax.physics.step import physics_step
from d3d12renderer_jax.physics.types import PhysicsSettings


def test_minmax_mips_structure():
    h = np.zeros((9, 9), np.float32)
    h[5, 5] = 3.0
    levels = build_minmax_mips(h)
    assert levels[0][0].shape == (1, 1)
    assert levels[-1][0].shape == (8, 8)
    # The top max must see the spike; top min is the floor.
    assert float(levels[0][1][0, 0]) == 3.0
    assert float(levels[0][0][0, 0]) == 0.0
    # Leaf cells adjacent to (5,5) carry the spike in their max.
    leaf_hi = np.asarray(levels[-1][1])
    assert leaf_hi[4, 4] == 3.0 and leaf_hi[5, 5] == 3.0
    assert leaf_hi[0, 0] == 0.0


def test_vertex_triangle_contacts_flat():
    h = np.zeros((9, 9), np.float32)
    levels = build_minmax_mips(h)
    origin = jnp.zeros(3)
    # A single vertex 0.1 below the flat surface.
    verts = jnp.array([[3.3, -0.1, 4.6], [3.3, 0.5, 4.6]])
    vmask = jnp.ones(2, bool)
    pts, dep, msk, n, ov = vertex_vs_terrain_triangles(
        jnp.asarray(h), levels, origin, jnp.asarray(1.0), verts, vmask)
    assert int(ov) == 0
    assert bool(msk[0])
    np.testing.assert_allclose(float(dep[0]), 0.1, atol=1e-5)
    np.testing.assert_allclose(np.asarray(n), [0, 1, 0], atol=1e-6)
    assert int(msk.sum()) == 1  # the above-surface vertex contributes nothing


@pytest.mark.slow
def test_cliff_contact_found_only_by_triangles():
    """A box floating next to a cliff wall: its center is over the low side,
    so the bilinear tangent plane under the center reports no contact, but a
    corner penetrates the cliff's steep face triangles."""
    h = np.zeros((9, 9), np.float32)
    h[5:, :] = 4.0      # cliff running along x = 5 (u axis)

    def build(mode):
        b = SceneBuilder()
        # Center over the flat low side (bilinear sample there = 0, box
        # bottom 0.3 above it -> no tangent-plane contact), while the +x
        # corners reach into the rising cliff cell u in [4, 5].
        body = b.add_body(position=(3.6, 0.85, 4.0))
        b.add_box_collider(body, (0.55, 0.55, 0.55))
        b.add_terrain(h, origin=(0.0, 0.0, 0.0), cell_size=1.0)
        return b.finalize(terrain_collision=mode)

    from d3d12renderer_jax.physics.collide import generate_contacts

    arch_b, state = build("bilinear")
    c_b = generate_contacts(arch_b, state)
    arch_t, state_t = build("triangles")
    c_t = generate_contacts(arch_t, state_t)

    assert not bool(np.asarray(c_b.active).any()), \
        "tangent plane should miss the cliff"
    assert bool(np.asarray(c_t.active).any()), \
        "triangle path should hit the cliff face"
    # Contact normal leans along -x (pushing the box away from the cliff,
    # whose face rises toward +x).
    ni = np.asarray(c_t.normal)[np.asarray(c_t.active)][0]
    assert ni[0] < -0.3


def test_ridge_edge_contact_needs_convex_path():
    """A wide flat box straddling a sharp ridge: no box VERTEX is below any
    triangle (they hang over the downslopes), but the crest penetrates the
    box's bottom face.  The vertex-only narrowphase misses it; the convex
    (GJK per candidate triangle) path must find an upward contact with the
    scalar-predicted depth (reference handles the general collider surface,
    src/physics/heightmap_collision.cpp:509)."""
    from d3d12renderer_jax.physics.gjk import ShapeRef, make_shape_ref
    from d3d12renderer_jax.physics.heightmap_collision import (
        convex_vs_terrain_triangles,
    )
    from d3d12renderer_jax.physics.types import SHAPE_BOX

    i = np.arange(9, dtype=np.float32)
    h = np.broadcast_to((2.0 - 0.5 * np.abs(i - 4.0))[:, None], (9, 9)).copy()
    levels = build_minmax_mips(h)
    origin = jnp.zeros(3)

    half = jnp.array([1.5, 0.1, 0.5])
    center = jnp.array([4.0, 2.05, 4.0])     # bottom face at y=1.95
    signs = np.array([[sx, sy, sz] for sx in (-1, 1)
                      for sy in (-1, 1) for sz in (-1, 1)], np.float32)
    verts = center + jnp.asarray(signs) * half
    vmask = jnp.ones(8, bool)

    # Scalar reference: deepest slope point under any bottom vertex.
    bottom = np.asarray(verts)[np.asarray(signs)[:, 1] < 0]
    terr = 2.0 - 0.5 * np.abs(bottom[:, 0] - 4.0)
    assert (bottom[:, 1] > terr).all(), "setup: vertices must clear slopes"

    pts_v, dep_v, msk_v, _, ov_v = vertex_vs_terrain_triangles(
        jnp.asarray(h), levels, origin, jnp.asarray(1.0), verts, vmask)
    assert int(ov_v) == 0
    assert not bool(np.asarray(msk_v).any()), "vertex path must miss"

    ref_b = make_shape_ref(
        jnp.array([SHAPE_BOX]), half[None], center[None],
        jnp.array([[0.0, 0.0, 0.0, 1.0]]))
    col_ref = ShapeRef(*[leaf[0] for leaf in ref_b])
    pts, dep, msk, n, ov = convex_vs_terrain_triangles(
        jnp.asarray(h), levels, origin, jnp.asarray(1.0), verts, vmask,
        col_ref)
    assert int(ov) == 0
    assert bool(np.asarray(msk).any()), "convex path must hit the crest"
    d0 = float(np.asarray(dep)[np.asarray(msk)].max())
    # Scalar: crest y=2.0 into bottom face y=1.95 -> 0.05 (sampled-MTD is an
    # upper bound that converges from above).
    assert 0.03 <= d0 <= 0.12, f"depth {d0} vs scalar 0.05"
    assert float(n[1]) > 0.9, f"normal should push up, got {np.asarray(n)}"
    p = np.asarray(pts)[np.asarray(msk)]
    assert np.all(np.abs(p[:, 0] - 4.0) < 1.1), "contacts near the crest"


@pytest.mark.slow
def test_flat_hull_rests_on_ridge():
    """Integration: the wide flat box dropped on the ridge must come to rest
    ON the crest (bottom ~ crest height), not sink until its vertices reach
    the downslopes."""
    i = np.arange(9, dtype=np.float32)
    h = np.broadcast_to((2.0 - 0.5 * np.abs(i - 4.0))[:, None], (9, 9)).copy()

    b = SceneBuilder()
    body = b.add_body(position=(4.0, 2.6, 4.0), linear_damping=0.2,
                      angular_damping=0.5)
    b.add_box_collider(body, (1.5, 0.1, 0.5), friction=0.9)
    b.add_terrain(h, origin=(0.0, 0.0, 0.0), cell_size=1.0)
    arch, state = b.finalize(terrain_collision="triangles")
    settings = PhysicsSettings()
    step = jax.jit(lambda s: physics_step(arch, s, settings, 1 / 60,
                                          num_substeps=2)[0])
    for _ in range(240):
        state = step(state)
    y = float(state.pos[0, 1])
    # Resting on the crest: center = 2.0 + 0.1 half-thickness (allow a bit of
    # rocking); vertex-only collision would let it sink to ~1.45.
    assert y > 1.95, f"box sank through the ridge crest: y={y}"
    assert y < 2.25, f"box hovering unexpectedly: y={y}"


@pytest.mark.slow
def test_box_rests_on_terrain_triangles():
    h = np.full((9, 9), 1.5, np.float32)
    b = SceneBuilder()
    body = b.add_body(position=(4.0, 3.5, 4.0), linear_damping=0.2,
                      angular_damping=0.2)
    b.add_box_collider(body, (0.5, 0.5, 0.5), friction=0.8)
    b.add_terrain(h, origin=(0.0, 0.0, 0.0), cell_size=1.0)
    arch, state = b.finalize(terrain_collision="triangles")
    settings = PhysicsSettings()
    step = jax.jit(lambda s: physics_step(arch, s, settings, 1 / 60,
                                          num_substeps=2)[0])
    for _ in range(240):
        state = step(state)
    y = float(state.pos[0, 1])
    assert abs(y - 2.0) < 0.03, f"box should rest at 2.0, got {y}"
