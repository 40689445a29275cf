"""Trajectory parity vs an independent scalar NumPy implementation.

BASELINE.json demands joint trajectories within 1e-3 of a CPU reference
(SURVEY.md §4: every device kernel gets a host reference, the pattern from the
reference's bitonic-sort self-test).  The NumPy implementation below is a
straight-line scalar port of the same algorithm (semi-implicit Euler,
sphere-vs-plane contact, sequential-impulse with Baumgarte, ball joint) —
written independently of the JAX code paths (no shared helpers).
"""

import math

import jax
import numpy as np

from d3d12renderer_jax.physics.builder import SceneBuilder
from d3d12renderer_jax.physics.step import physics_step
from d3d12renderer_jax.physics.types import PhysicsSettings

DT = 1.0 / 120.0
GRAVITY = -9.81
SLOP = 0.001
BAUMGARTE = 0.1
ITERS = 30


def np_sphere_drop_trajectory(steps, radius=0.5, y0=2.0, restitution=0.3,
                              damping=0.1):
    """Scalar reference: sphere falling on a plane."""
    mass = 1000.0 * 4.0 / 3.0 * math.pi * radius ** 3
    inv_m = 1.0 / mass
    y, vy = y0, 0.0
    traj = []
    for _ in range(steps):
        # contact generation at pre-integration pose
        depth = radius - y
        active = depth >= 0.0
        # integrate forces
        vy += GRAVITY * DT
        vy /= 1.0 + DT * damping
        if active:
            # effective mass along the normal
            eff = 1.0 / inv_m
            bias = 0.0
            if depth > SLOP and vy < 0.0:
                bias = -restitution * vy + BAUMGARTE * (depth - SLOP) / DT
            imp = 0.0
            for _ in range(ITERS):
                lam = -eff * (vy - bias)
                new_imp = max(imp + lam, 0.0)
                lam = new_imp - imp
                imp = new_imp
                vy += inv_m * lam
        y += vy * DT
        traj.append(y)
    return np.array(traj)


def test_sphere_drop_matches_numpy_reference():
    b = SceneBuilder()
    b.add_static_plane((0, 1, 0), 0.0, friction=0.5, restitution=0.3)
    body = b.add_body(position=(0.0, 2.0, 0.0), linear_damping=0.1,
                      angular_damping=0.1)
    b.add_sphere_collider(body, radius=0.5, friction=0.5, restitution=0.3)
    arch, state = b.finalize()
    settings = PhysicsSettings()
    step = jax.jit(
        lambda s: physics_step(arch, s, settings, DT, num_substeps=1)[0])

    steps = 240
    traj_jax = []
    for _ in range(steps):
        state = step(state)
        traj_jax.append(float(state.pos[0, 1]))
    traj_jax = np.array(traj_jax)
    traj_ref = np_sphere_drop_trajectory(steps)

    err = np.abs(traj_jax - traj_ref).max()
    assert err < 1e-3, f"max trajectory divergence {err}"


def np_pendulum_trajectory(steps, arm=1.0, damping=0.0):
    """Scalar reference: point-mass ball-joint pendulum (position + velocity
    via the same sequential-impulse ball solve with 3x3 effective mass).

    Body: unit-mass point at the end of an arm from a world pivot at origin.
    Uses identical formulas: K = (imA+imB) I + skew terms (inertia of the
    actual sphere collider included)."""
    # Mirror builder mass properties for a r=0.1 density-1000 sphere.
    r = 0.1
    mass = 1000.0 * 4.0 / 3.0 * math.pi * r ** 3
    inv_m = 1.0 / mass
    i_diag = 2.0 / 5.0 * mass * r * r
    inv_i = 1.0 / i_diag

    pos = np.array([arm, 0.0, 0.0])
    vel = np.zeros(3)
    omega = np.zeros(3)
    rotq = np.array([0.0, 0.0, 0.0, 1.0])

    def qmul(a, b):
        ax, ay, az, aw = a
        bx, by, bz, bw = b
        return np.array([
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ])

    def qrot(q, v):
        u, w = q[:3], q[3]
        return 2 * (u @ v) * u + (w * w - u @ u) * v + 2 * w * np.cross(u, v)

    local_anchor = np.array([-arm, 0.0, 0.0])
    traj = []
    for _ in range(steps):
        # prep (pre-integration pose, like the JAX joint prep ordering):
        # anchors computed BEFORE velocity integration in both builds
        ra = qrot(rotq, local_anchor)
        ga = pos + ra
        # bias = (g_pendulum_anchor - g_world_anchor) * beta/dt, pulled into
        # `cdot - bias` below with the worlds anchor at the origin.
        bias = (np.zeros(3) - ga) * (0.1 / DT)

        vel = vel + np.array([0.0, GRAVITY, 0.0]) * DT
        vel = vel / (1.0 + DT * damping)
        omega = omega / (1.0 + DT * damping)

        def skew(v):
            return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]],
                             [-v[1], v[0], 0]])

        # world inv inertia (sphere: isotropic)
        K = (skew(ra) @ (np.eye(3) * inv_i) @ skew(ra).T
             + np.eye(3) * inv_m)
        invK = np.linalg.inv(K)
        for _ in range(ITERS):
            # world body b side is fixed: cdot = -(va + wa x ra) + bias... with
            # convention body_a = pendulum treated as "b" side in the builder
            # (world, body); here: cdot = v_anchor(body) - 0 + bias_dir
            cdot = vel + np.cross(omega, ra)
            lam = -invK @ (cdot - bias)
            vel = vel + inv_m * lam
            omega = omega + inv_i * np.cross(ra, lam)
        pos = pos + vel * DT
        dq = qmul(np.array([*(0.5 * omega), 0.0]), rotq)
        rotq = rotq + dq * DT
        rotq /= np.linalg.norm(rotq)
        traj.append(pos.copy())
    return np.array(traj)


def test_ball_pendulum_matches_numpy_reference():
    b = SceneBuilder()
    body = b.add_body(position=(1.0, 0.0, 0.0), linear_damping=0.0,
                      angular_damping=0.0)
    b.add_sphere_collider(body, radius=0.1)
    b.add_ball_joint(-1, body, (0.0, 0.0, 0.0))
    arch, state = b.finalize()
    settings = PhysicsSettings()
    step = jax.jit(
        lambda s: physics_step(arch, s, settings, DT, num_substeps=1)[0])

    steps = 120  # one second of swing
    traj_jax = []
    for _ in range(steps):
        state = step(state)
        traj_jax.append(np.asarray(state.pos[0]))
    traj_jax = np.stack(traj_jax)
    traj_ref = np_pendulum_trajectory(steps)

    err = np.abs(traj_jax - traj_ref).max()
    assert err < 1e-3, f"max trajectory divergence {err}"
