"""Direct unit tests for the math library (core/maths.py).

The batched equivalent of the reference's vec/quat/trs core (reference:
src/core/math.h:1, math.cpp) — everything else in the repo exercises these
transitively; this file pins them directly against NumPy references.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from d3d12renderer_jax.core import maths as m


def rot_matrix(axis, angle):
    """NumPy reference: Rodrigues rotation matrix."""
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


AXES = [(1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.3, -0.7, 0.648), (-1.0, 2.0, 0.5)]
ANGLES = [0.1, 1.0, -2.2, 3.0]


def test_vector_basics():
    a = jnp.array([3.0, 4.0, 0.0])
    b = jnp.array([-1.0, 2.0, 2.0])
    assert float(m.dot(a, b)) == pytest.approx(5.0)
    assert float(m.length(a)) == pytest.approx(5.0)
    assert float(m.squared_length(b)) == pytest.approx(9.0)
    np.testing.assert_allclose(np.asarray(m.cross(a, b)),
                               np.cross(np.asarray(a), np.asarray(b)),
                               atol=1e-6)
    n = np.asarray(m.normalize(a))
    assert np.linalg.norm(n) == pytest.approx(1.0, abs=1e-6)
    # noz: zero vector stays zero instead of NaN.
    z = np.asarray(m.noz(jnp.zeros(3)))
    assert np.all(z == 0.0)


@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("angle", ANGLES)
def test_quat_rotate_matches_rodrigues(axis, angle):
    q = m.quat_from_axis_angle(jnp.asarray(m.normalize(jnp.array(axis))), angle)
    v = jnp.array([0.3, -1.2, 2.0])
    got = np.asarray(m.quat_rotate(q, v))
    want = rot_matrix(axis, angle) @ np.asarray(v, np.float64)
    np.testing.assert_allclose(got, want, atol=1e-5)
    # quat_to_mat3 agrees with quat_rotate.
    R = np.asarray(m.quat_to_mat3(q))
    np.testing.assert_allclose(R @ np.asarray(v), got, atol=1e-5)
    # Inverse rotation undoes the rotation.
    np.testing.assert_allclose(
        np.asarray(m.quat_inv_rotate(q, m.quat_rotate(q, v))),
        np.asarray(v), atol=1e-5)


def test_quat_mul_is_rotation_composition():
    qa = m.quat_from_axis_angle(jnp.asarray(m.normalize(jnp.array(AXES[2]))), 0.8)
    qb = m.quat_from_axis_angle(jnp.asarray(m.normalize(jnp.array(AXES[3]))), -1.4)
    v = jnp.array([1.0, 2.0, -0.5])
    lhs = np.asarray(m.quat_rotate(m.quat_mul(qa, qb), v))
    rhs = np.asarray(m.quat_rotate(qa, m.quat_rotate(qb, v)))
    np.testing.assert_allclose(lhs, rhs, atol=1e-5)
    # Conjugate is the inverse for unit quaternions.
    ident = np.asarray(m.quat_mul(qa, m.quat_conj(qa)))
    np.testing.assert_allclose(ident, [0, 0, 0, 1], atol=1e-6)


@pytest.mark.parametrize("axis", AXES[:2])
def test_axis_angle_roundtrip(axis):
    angle = 1.3
    q = m.quat_from_axis_angle(jnp.asarray(m.normalize(jnp.array(axis))), angle)
    ax, ang = m.quat_to_axis_angle(q)
    np.testing.assert_allclose(np.asarray(ax) * float(ang),
                               np.asarray(m.normalize(jnp.array(axis))) * angle,
                               atol=1e-5)


def test_quat_from_to():
    a = m.normalize(jnp.array([1.0, 0.2, -0.3]))
    b = m.normalize(jnp.array([-0.5, 1.0, 0.8]))
    q = m.quat_from_to(a, b)
    np.testing.assert_allclose(np.asarray(m.quat_rotate(q, a)),
                               np.asarray(b), atol=1e-5)
    # Degenerate same-direction case: identity-like behavior.
    q2 = m.quat_from_to(a, a)
    np.testing.assert_allclose(np.asarray(m.quat_rotate(q2, a)),
                               np.asarray(a), atol=1e-5)


def test_quat_integrate_small_step():
    q0 = m.quat(0.0, 0.0, 0.0, 1.0)
    omega = jnp.array([0.0, 2.0, 0.0])
    dt = 1e-3
    q1 = q0
    for _ in range(100):
        q1 = m.quat_integrate(q1, omega, dt)
    want = m.quat_from_axis_angle(jnp.array([0.0, 1.0, 0.0]), 2.0 * 0.1)
    np.testing.assert_allclose(np.abs(np.asarray(q1)),
                               np.abs(np.asarray(want)), atol=1e-3)
    assert np.linalg.norm(np.asarray(q1)) == pytest.approx(1.0, abs=1e-5)


def test_quat_twist_angle():
    axis = jnp.array([0.0, 0.0, 1.0])
    q = m.quat_from_axis_angle(axis, 0.75)
    assert float(m.quat_twist_angle(q, axis)) == pytest.approx(0.75, abs=1e-5)
    # Pure swing about a perpendicular axis has zero twist.
    q_swing = m.quat_from_axis_angle(jnp.array([1.0, 0.0, 0.0]), 0.6)
    assert float(m.quat_twist_angle(q_swing, axis)) == pytest.approx(0.0, abs=1e-5)


def test_transform_point_roundtrip():
    pos = jnp.array([1.0, -2.0, 3.0])
    rot = m.quat_from_axis_angle(jnp.asarray(m.normalize(jnp.array(AXES[2]))), 0.9)
    p = jnp.array([0.4, 0.5, -0.6])
    world = m.transform_point(pos, rot, p)
    back = m.inverse_transform_point(pos, rot, world)
    np.testing.assert_allclose(np.asarray(back), np.asarray(p), atol=1e-5)


def test_orthonormal_basis():
    for axis in AXES + [(0.0, 0.0, 1.0), (0.0, 0.0, -1.0)]:
        n = m.normalize(jnp.array(axis))
        t1, t2 = m.orthonormal_basis(n)
        for v in (t1, t2):
            assert float(m.length(v)) == pytest.approx(1.0, abs=1e-5)
            assert float(m.dot(v, n)) == pytest.approx(0.0, abs=1e-5)
        assert float(m.dot(t1, t2)) == pytest.approx(0.0, abs=1e-5)
        # Right-handed: t1 x t2 == n.
        np.testing.assert_allclose(np.asarray(m.cross(t1, t2)),
                                   np.asarray(n), atol=1e-5)
