"""Vector / quaternion / transform math for the batched engine.

Design: everything is a plain ``jnp`` array with a trailing component axis so that
``jax.vmap`` / leading batch axes come for free.  Quaternions are stored ``(x, y, z, w)``
to match the reference engine's convention (reference: ``src/core/math.h:329`` quat layout).

All functions are shape-polymorphic over leading axes: ``quat_mul`` works on ``(4,)``,
``(N, 4)``, ``(B, N, 4)``, ...
"""

from __future__ import annotations

import jax.numpy as jnp

# Matches the reference engine's gravity constant (reference: src/physics/physics.h:11).
GRAVITY = -9.81


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def length(a):
    return jnp.linalg.norm(a, axis=-1)


def squared_length(a):
    return jnp.sum(a * a, axis=-1)


def normalize(a, eps=1e-12):
    return a / jnp.maximum(length(a), eps)[..., None]


def roll2(x, dy, dx):
    """2-D image roll that SKIPS zero components.

    jnp.roll with a static shift of 0 still lowers to concat(slice[0:0],
    slice[0:n]) — a zero-sized tensor; static-shift rolls in the frame go
    through this so no zero-sized operand reaches the compiler."""
    if dy:
        x = jnp.roll(x, dy, 0)
    if dx:
        x = jnp.roll(x, dx, 1)
    return x


def noz(a, eps_sq=1e-8):
    """Normalize-or-zero (reference: src/core/math.h:595)."""
    sl = squared_length(a)
    n = a / jnp.sqrt(jnp.maximum(sl, eps_sq))[..., None]
    return jnp.where((sl < eps_sq)[..., None], jnp.zeros_like(a), n)


def cross(a, b):
    return jnp.cross(a, b)


# ---------------------------------------------------------------------------
# Quaternions: (x, y, z, w)
# ---------------------------------------------------------------------------

QUAT_IDENTITY = jnp.array([0.0, 0.0, 0.0, 1.0], dtype=jnp.float32)


def quat(x, y, z, w, dtype=jnp.float32):
    return jnp.array([x, y, z, w], dtype=dtype)


def quat_mul(a, b):
    """Hamilton product a*b, (x,y,z,w) layout."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        axis=-1,
    )


def quat_conj(q):
    return q * jnp.array([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype)


def quat_rotate(q, v):
    """Rotate vector v by unit quaternion q (q * v * q^-1), vectorized.

    Uses the 2-cross-product expansion: v + 2*cross(q.xyz, cross(q.xyz, v) + q.w*v).
    """
    u = q[..., :3]
    w = q[..., 3:4]
    t = jnp.cross(u, v) + w * v
    return v + 2.0 * jnp.cross(u, t)


def quat_inv_rotate(q, v):
    return quat_rotate(quat_conj(q), v)


def quat_from_axis_angle(axis, angle):
    axis = jnp.asarray(axis, dtype=jnp.float32)
    angle = jnp.asarray(angle, dtype=jnp.float32)
    half = 0.5 * angle
    s = jnp.sin(half)
    return jnp.concatenate(
        [axis * s[..., None], jnp.cos(half)[..., None]], axis=-1
    )


def quat_to_mat3(q):
    """Unit quaternion -> 3x3 rotation matrix, shape (..., 3, 3)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_integrate(q, omega, dt):
    """Semi-implicit Euler quaternion update.

    q' = normalize(q + dt * (0.5 * omega_quat) * q)  — matches the reference's
    rigid-body velocity integration (reference: src/physics/rigid_body.cpp:131-134).
    """
    omega_q = jnp.concatenate([0.5 * omega, jnp.zeros_like(omega[..., :1])], axis=-1)
    dq = quat_mul(omega_q, q)
    return normalize(q + dq * dt)


def quat_axis(q):
    """Rotation axis of a quaternion (normalized xyz, or +x for identity)."""
    u = q[..., :3]
    sl = squared_length(u)
    fallback = jnp.zeros_like(u).at[..., 0].set(1.0)
    n = u / jnp.sqrt(jnp.maximum(sl, 1e-16))[..., None]
    return jnp.where((sl < 1e-12)[..., None], fallback, n)


def quat_twist_angle(q, axis):
    """Signed twist angle of quaternion q around the given (unit) axis.

    Decomposes q = swing * twist; returns the twist angle: 2*atan2(dot(q.xyz, axis), q.w).
    """
    proj = dot(q[..., :3], axis)
    return 2.0 * jnp.arctan2(proj, q[..., 3])


def quat_from_to(a, b):
    """Shortest-arc rotation taking unit vector a to unit vector b
    (reference behavior: src/core/math.cpp:538 rotateFromTo)."""
    w = 1.0 + dot(a, b)
    v = cross(a, b)
    # Antiparallel fallback: rotate pi about any axis orthogonal to a.
    t1, _ = orthonormal_basis(a)
    anti = w < 1e-6
    v = jnp.where(anti[..., None], t1, v)
    w = jnp.where(anti, 0.0, w)
    q = jnp.concatenate([v, w[..., None]], axis=-1)
    return normalize(q)


def quat_to_axis_angle(q):
    """(axis, signed angle) of a quaternion; angle = 2*atan2(|v|, w)
    (reference behavior: src/core/math.cpp:577 getAxisRotation)."""
    v = q[..., :3]
    l = length(v)
    angle = 2.0 * jnp.arctan2(l, q[..., 3])
    fallback = jnp.zeros_like(v).at[..., 0].set(1.0)
    axis = jnp.where((l > 1e-9)[..., None], v / jnp.maximum(l, 1e-9)[..., None], fallback)
    return axis, angle


def mat3_vec(m, v):
    """(..., 3, 3) @ (..., 3) -> (..., 3)."""
    return jnp.einsum("...ij,...j->...i", m, v)


def transform_point(pos, rot, p):
    """trs-style point transform: pos + rot * p (no scale)."""
    return pos + quat_rotate(rot, p)


def inverse_transform_point(pos, rot, p):
    return quat_inv_rotate(rot, p - pos)


def orthonormal_basis(n):
    """Build two tangent vectors orthogonal to unit normal n (branch-free)."""
    # Pixar's orthonormal basis (Duff et al.) — stable for all n.
    sign = jnp.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t1 = jnp.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]], axis=-1
    )
    t2 = jnp.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], axis=-1)
    return t1, t2
