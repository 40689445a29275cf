"""Exact capsule-vs-box manifolds (physics/narrow.py capsule_vs_box).

VERDICT r4 item 5: the round-4 3-probe-sphere approximation missed contacts
whose closest segment point is neither an endpoint nor the point closest to
the box CENTER, and jittered on face/edge resting configurations.  The exact
kernel (bisected closest point + face clipping) must find those contacts and
keep resting capsules put.  Reference: the dedicated capsule manifolds of
/root/reference/src/physics/collision_narrow.cpp:374-1558.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from d3d12renderer_jax.core import maths as m
from d3d12renderer_jax.physics import builder, narrow, step
from d3d12renderer_jax.physics.types import PhysicsSettings


def _call(p0, p1, r, c, q, h):
    f = lambda *a: narrow.capsule_vs_box(*a)
    args = [jnp.asarray(np.array(x, np.float32))[None] for x in
            (p0, p1, [r], c, q, h)]
    args[2] = args[2][:, 0]
    normal, pts, dep, msk = jax.jit(f)(*args)
    return (np.asarray(normal)[0], np.asarray(pts)[0],
            np.asarray(dep)[0], np.asarray(msk)[0])


IDENT = (0.0, 0.0, 0.0, 1.0)


def test_finds_interior_face_contact_probes_missed():
    """Segment grazing a long box's +x face between the endpoints, where the
    closest-to-box point is NOT the closest-to-center point (the round-4
    3-probe kernel reported no contact here)."""
    n, pts, dep, msk = _call(
        (1.15, 3.0, -2.0), (1.15, 0.1, 4.0), 0.3,
        (0, 0, 0), IDENT, (1.0, 1.0, 3.0))
    assert msk.any(), "exact kernel must find the interior contact"
    deepest = dep[msk].max()
    assert abs(deepest - 0.15) < 1e-3, deepest
    # Normal A(capsule)->B(box): -x.
    assert np.allclose(n, [-1.0, 0.0, 0.0], atol=1e-3), n


def test_separated_near_corner_reports_no_contact():
    """Diagonal pass 0.212 from the corner with r=0.2: separated."""
    n, pts, dep, msk = _call(
        (1.15, 1.15, -3.0), (1.15, 1.15, 3.0), 0.2,
        (0, 0, 0), IDENT, (1.0, 1.0, 1.0))
    assert not msk.any()


def test_face_rest_line_manifold():
    """Capsule lying flat on a face: at least 2 contact points (the clipped
    line manifold), all with the face normal."""
    r = 0.25
    n, pts, dep, msk = _call(
        (-0.8, 1.0 + r - 0.01, 0.0), (0.8, 1.0 + r - 0.01, 0.0), r,
        (0, 0, 0), IDENT, (1.5, 1.0, 1.5))
    assert msk.sum() >= 2, msk
    assert np.allclose(n, [0.0, -1.0, 0.0], atol=1e-3), n
    # Active points spread along the capsule axis (a line, not one probe).
    xs = pts[msk][:, 0]
    assert xs.max() - xs.min() > 1.0, xs
    np.testing.assert_allclose(dep[msk], 0.01, atol=1e-3)


def test_endcap_on_face_single_region():
    """Capsule standing upright on a face: contact at the lower cap only."""
    r = 0.2
    n, pts, dep, msk = _call(
        (0.0, 1.0 + r - 0.02, 0.0), (0.0, 3.0, 0.0), r,
        (0, 0, 0), IDENT, (1.0, 1.0, 1.0))
    assert msk.any()
    assert np.allclose(n, [0.0, -1.0, 0.0], atol=1e-3)
    ys = pts[msk][:, 1]
    assert np.all(ys < 1.1), ys
    assert abs(dep[msk].max() - 0.02) < 1e-3


def _settle(arch, state, settings, frames):
    stepper = jax.jit(
        lambda s: step.physics_step(
            arch, s, settings, 1.0 / settings.frame_rate, num_substeps=1)[0])
    for _ in range(frames):
        state = stepper(state)
    return state


@pytest.mark.slow
def test_capsule_rests_on_box_face_240_frames():
    b = builder.SceneBuilder()
    b.add_static_plane((0, 1, 0), 0.0, friction=0.9)
    box = b.add_body(position=(0, 0.25, 0))
    b.add_box_collider(box, half_extents=(1.2, 0.25, 1.2), friction=0.9,
                       density=2000.0)
    cap = b.add_body(position=(0, 0.5 + 0.15, 0))
    # Axis along x: add_capsule_collider_from_points.
    b.add_capsule_collider_from_points(
        cap, (-0.7, 0, 0), (0.7, 0, 0), radius=0.15, friction=0.9)
    arch, state = b.finalize()

    settings = PhysicsSettings()
    state = _settle(arch, state, settings, 240)
    pos = np.asarray(state.pos)
    # Capsule still on top of the box, nearly where it started.
    assert abs(pos[1, 1] - 0.65) < 0.03, pos[1]
    assert abs(pos[1, 0]) < 0.05 and abs(pos[1, 2]) < 0.05, pos[1]
    assert float(jnp.max(jnp.abs(state.vel[1]))) < 0.1


@pytest.mark.slow
def test_capsule_balanced_on_box_edge_240_frames():
    """VERDICT r4 #5 acceptance: a long capsule lying ALONG a box top edge
    (axis parallel to the edge) stays put for 240 frames."""
    b = builder.SceneBuilder()
    b.add_static_plane((0, 1, 0), 0.0, friction=0.9)
    box = b.add_body(position=(0, 0.5, 0))
    b.add_box_collider(box, half_extents=(0.5, 0.5, 0.5), friction=0.9,
                       density=2000.0)
    r = 0.12
    cap = b.add_body(position=(0.5, 1.0 + r, 0.0))
    b.add_capsule_collider_from_points(
        cap, (0, 0, -0.6), (0, 0, 0.6), radius=r, friction=0.9)
    arch, state = b.finalize()

    settings = PhysicsSettings()
    state = _settle(arch, state, settings, 240)
    pos = np.asarray(state.pos)
    # Still balanced on the edge: x stays at the edge, height at edge + r.
    assert abs(pos[1, 0] - 0.5) < 0.05, pos[1]
    assert abs(pos[1, 1] - (1.0 + r)) < 0.05, pos[1]
    assert abs(pos[1, 2]) < 0.05, pos[1]
    # No rolling off: axis still along z.
    axis = np.asarray(m.quat_rotate(state.rot[1], jnp.array([0.0, 0.0, 1.0])))
    assert abs(axis[2]) > 0.99, axis
