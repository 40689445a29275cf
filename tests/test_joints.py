"""Joint constraint tests: each of the 6 joint types, limits and motors.

Pattern per SURVEY.md §4: behavioral invariants (constraint satisfaction after
settling) instead of golden values, since the reference publishes no trajectories.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from d3d12renderer_jax.physics.builder import SceneBuilder
from d3d12renderer_jax.physics.step import physics_step
from d3d12renderer_jax.physics.types import PhysicsSettings

SETTINGS = PhysicsSettings()
DT = 1.0 / 60.0


def run(arch, state, steps, motor_overrides=None, settings=SETTINGS):
    step = jax.jit(
        lambda s: physics_step(arch, s, settings, DT, motor_overrides=motor_overrides)[0]
    )
    for _ in range(steps):
        state = step(state)
    return jax.device_get(state)


def test_ball_joint_pendulum_keeps_anchor():
    b = SceneBuilder()
    body = b.add_body(position=(1.0, 5.0, 0.0), linear_damping=0.0, angular_damping=0.0)
    b.add_sphere_collider(body, radius=0.25, density=1000.0)
    pivot = np.array([0.0, 5.0, 0.0])
    b.add_ball_joint(-1, body, pivot)
    arch, state = b.finalize()

    final = run(arch, state, 120)
    # Anchor point on the body must stay near the pivot.
    dist_to_pivot = np.linalg.norm(final.pos[0] - pivot)
    assert abs(dist_to_pivot - 1.0) < 0.05  # sphere COG stays 1m from pivot
    # It must have swung down (pendulum dynamics).
    assert final.pos[0][1] < 5.0


def test_distance_joint_maintains_length():
    b = SceneBuilder()
    body = b.add_body(position=(0.0, 3.0, 0.0), linear_damping=0.0)
    b.add_sphere_collider(body, radius=0.2)
    anchor_w = np.array([0.0, 5.0, 0.0])
    b.add_distance_joint(-1, body, anchor_w, (0.0, 3.0, 0.0))  # length 2
    arch, state = b.finalize()

    final = run(arch, state, 240)
    d = np.linalg.norm(final.pos[0] - anchor_w)
    assert abs(d - 2.0) < 0.05


def test_fixed_joint_locks_relative_pose():
    b = SceneBuilder()
    a = b.add_body(position=(0.0, 4.0, 0.0), kinematic=True)
    b.add_box_collider(a, half_extents=(0.5, 0.5, 0.5))
    c = b.add_body(position=(1.5, 4.0, 0.0))
    b.add_box_collider(c, half_extents=(0.5, 0.5, 0.5))
    b.add_fixed_joint(a, c, (0.75, 4.0, 0.0))
    arch, state = b.finalize()

    final = run(arch, state, 180)
    # Child must hang rigidly at its initial offset from the kinematic parent.
    assert np.linalg.norm(final.pos[1] - np.array([1.5, 4.0, 0.0])) < 0.05
    # orientation stays near identity
    assert abs(final.rot[1][3]) > 0.99


def test_hinge_swings_only_about_axis():
    b = SceneBuilder()
    arm = b.add_body(position=(1.0, 5.0, 0.0), linear_damping=0.0, angular_damping=0.0)
    b.add_box_collider(arm, half_extents=(1.0, 0.1, 0.1))
    b.add_hinge_joint(-1, arm, (0.0, 5.0, 0.0), (0.0, 0.0, 1.0))
    arch, state = b.finalize()

    final = run(arch, state, 90)
    # Motion stays in the XY plane (hinge about Z).
    assert abs(final.pos[0][2]) < 1e-2
    assert final.pos[0][1] < 5.0  # swung down


def test_hinge_limits_clamp_angle():
    b = SceneBuilder()
    arm = b.add_body(position=(1.0, 5.0, 0.0), linear_damping=0.0, angular_damping=0.0)
    b.add_box_collider(arm, half_extents=(1.0, 0.1, 0.1))
    lim = 0.3
    b.add_hinge_joint(-1, arm, (0.0, 5.0, 0.0), (0.0, 0.0, 1.0),
                      min_limit=-lim, max_limit=lim)
    arch, state = b.finalize()

    final = run(arch, state, 300)
    # Arm hangs at the limit, not straight down: angle from +x axis <= lim (+slack).
    p = final.pos[0]
    angle = np.arctan2(-p[1] + 5.0, p[0])
    assert angle < lim + 0.1


def test_hinge_position_motor_reaches_target():
    b = SceneBuilder()
    arm = b.add_body(position=(1.0, 5.0, 0.0), linear_damping=0.0, angular_damping=0.0)
    b.add_box_collider(arm, half_extents=(1.0, 0.1, 0.1), density=100.0)
    target = 0.8
    b.add_hinge_joint(-1, arm, (0.0, 5.0, 0.0), (0.0, 0.0, 1.0),
                      motor_type=1.0, motor_target=target, max_torque=1000.0)
    arch, state = b.finalize()

    final = run(arch, state, 240)
    p = final.pos[0]
    angle = np.arctan2(p[1] - 5.0, p[0])
    assert abs(angle - target) < 0.1


def test_hinge_velocity_motor_spins():
    b = SceneBuilder()
    rotor = b.add_body(position=(0.0, 5.0, 0.0), gravity_factor=0.0,
                       linear_damping=0.0, angular_damping=0.0)
    b.add_box_collider(rotor, half_extents=(1.0, 0.1, 0.1), density=100.0)
    b.add_hinge_joint(-1, rotor, (0.0, 5.0, 0.0), (0.0, 1.0, 0.0),
                      motor_type=0.0, motor_target=2.0, max_torque=10000.0)
    arch, state = b.finalize()

    final = run(arch, state, 120)
    # Reaches commanded angular velocity about Y.
    assert abs(final.omega[0][1] - 2.0) < 0.1


@pytest.mark.slow
def test_cone_twist_swing_limit():
    b = SceneBuilder()
    limb = b.add_body(position=(0.0, 4.0, 0.0), linear_damping=0.0, angular_damping=0.0)
    b.add_capsule_collider(limb, radius=0.15, half_length=0.5)
    # Swing around the downward axis; limit to 0.4 rad. Give the limb sideways velocity.
    b.add_cone_twist_joint(-1, limb, (0.0, 4.75, 0.0), (0.0, -1.0, 0.0),
                           swing_limit=0.4, twist_limit=0.2)
    arch, state = b.finalize()
    state = state.replace(vel=state.vel.at[0].set(jnp.array([3.0, 0.0, 0.0])))

    final = run(arch, state, 300)
    # The capsule axis must stay within the swing cone (+slack).
    down = np.array([0.0, -1.0, 0.0])
    q = final.rot[0]
    x, y, z, w = q
    rotm = np.array([
        [1 - 2*(y*y+z*z), 2*(x*y-w*z), 2*(x*z+w*y)],
        [2*(x*y+w*z), 1 - 2*(x*x+z*z), 2*(y*z-w*x)],
        [2*(x*z-w*y), 2*(y*z+w*x), 1 - 2*(x*x+y*y)],
    ])
    limb_down = rotm @ np.array([0.0, -1.0, 0.0])
    swing = np.arccos(np.clip(limb_down @ down, -1, 1))
    assert swing < 0.4 + 0.15


@pytest.mark.slow
def test_cone_twist_position_motors_drive_pose():
    b = SceneBuilder()
    limb = b.add_body(position=(0.0, 4.0, 0.0), linear_damping=0.0, angular_damping=0.9)
    b.add_capsule_collider(limb, radius=0.15, half_length=0.5, density=100.0)
    jid = b.add_cone_twist_joint(
        -1, limb, (0.0, 4.75, 0.0), (0.0, -1.0, 0.0),
        swing_limit=1.0, twist_limit=1.0,
        swing_motor_type=1.0, swing_target=0.5, swing_axis_angle=0.0,
        max_swing_torque=1000.0,
        twist_motor_type=1.0, twist_target=0.0, max_twist_torque=1000.0,
    )
    arch, state = b.finalize()

    final = run(arch, state, 600)
    q = final.rot[0]
    x, y, z, w = q
    rotm = np.array([
        [1 - 2*(y*y+z*z), 2*(x*y-w*z), 2*(x*z+w*y)],
        [2*(x*y+w*z), 1 - 2*(x*x+z*z), 2*(y*z-w*x)],
        [2*(x*z-w*y), 2*(y*z+w*x), 1 - 2*(x*x+y*y)],
    ])
    limb_down = rotm @ np.array([0.0, -1.0, 0.0])
    swing = np.arccos(np.clip(limb_down @ np.array([0.0, -1.0, 0.0]), -1, 1))
    # Motor holds the limb swung out near the target against gravity.
    assert swing > 0.2


def test_slider_constrains_to_axis():
    b = SceneBuilder()
    block = b.add_body(position=(0.0, 5.0, 0.0), linear_damping=0.0, angular_damping=0.0)
    b.add_box_collider(block, half_extents=(0.3, 0.3, 0.3))
    # Slider along X: gravity can't move it (perpendicular), but it's free in X.
    b.add_slider_joint(-1, block, (0.0, 5.0, 0.0), (1.0, 0.0, 0.0))
    arch, state = b.finalize()
    state = state.replace(vel=state.vel.at[0].set(jnp.array([1.0, 0.0, 0.0])))

    final = run(arch, state, 120)
    assert abs(final.pos[0][1] - 5.0) < 0.02   # no sag
    assert abs(final.pos[0][2]) < 0.02
    assert final.pos[0][0] > 0.5               # slid along axis


def test_slider_limits():
    b = SceneBuilder()
    block = b.add_body(position=(0.0, 5.0, 0.0), linear_damping=0.0, angular_damping=0.0)
    b.add_box_collider(block, half_extents=(0.3, 0.3, 0.3))
    b.add_slider_joint(-1, block, (0.0, 5.0, 0.0), (1.0, 0.0, 0.0),
                       neg_limit=-0.5, pos_limit=0.5)
    arch, state = b.finalize()
    state = state.replace(vel=state.vel.at[0].set(jnp.array([3.0, 0.0, 0.0])))

    final = run(arch, state, 120)
    assert final.pos[0][0] < 0.6


def test_slider_position_motor():
    b = SceneBuilder()
    block = b.add_body(position=(0.0, 5.0, 0.0), linear_damping=0.0, angular_damping=0.0)
    b.add_box_collider(block, half_extents=(0.3, 0.3, 0.3), density=100.0)
    b.add_slider_joint(-1, block, (0.0, 5.0, 0.0), (1.0, 0.0, 0.0),
                       motor_type=1.0, motor_target=1.5, max_force=100000.0)
    arch, state = b.finalize()

    final = run(arch, state, 240)
    assert abs(final.pos[0][0] - 1.5) < 0.05


@pytest.mark.slow
def test_motor_override_changes_target():
    """Runtime motor targets (the RL action path) override authored params."""
    b = SceneBuilder()
    arm = b.add_body(position=(1.0, 5.0, 0.0), linear_damping=0.0, angular_damping=0.0)
    b.add_box_collider(arm, half_extents=(1.0, 0.1, 0.1), density=100.0)
    b.add_hinge_joint(-1, arm, (0.0, 5.0, 0.0), (0.0, 0.0, 1.0),
                      motor_type=1.0, motor_target=0.0, max_torque=1000.0)
    arch, state = b.finalize()

    override = ({"motor_target": jnp.array([0.6])},)
    final = run(arch, state, 240, motor_overrides=override)
    p = final.pos[0]
    angle = np.arctan2(p[1] - 5.0, p[0])
    assert abs(angle - 0.6) < 0.1


@pytest.mark.slow
def test_joint_chain_batch_vmap():
    """A 4-link hinge chain stepped over a batch axis stays connected."""
    b = SceneBuilder()
    prev = -1
    for i in range(4):
        link = b.add_body(position=(0.5 + i * 1.0, 6.0, 0.0),
                          linear_damping=0.1, angular_damping=0.1)
        b.add_capsule_collider(
            link, radius=0.1, half_length=0.4,
            rotation=(0.0, 0.0, np.sin(np.pi / 4), np.cos(np.pi / 4)),
        )
        b.add_ball_joint(prev, link, (i * 1.0, 6.0, 0.0))
        prev = link
    arch, state = b.finalize()

    batch = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (8,) + x.shape), state
    )
    step = jax.jit(jax.vmap(lambda s: physics_step(arch, s, SETTINGS, DT)[0]))
    for _ in range(120):
        batch = step(batch)
    final = jax.device_get(batch)
    # All links stay within chain reach of the root pivot (0, 6, 0).
    pivot = np.array([0.0, 6.0, 0.0])
    for i in range(4):
        d = np.linalg.norm(final.pos[:, i] - pivot, axis=-1)
        assert np.all(d < (i + 1) * 1.0 + 0.6)
    assert np.all(np.isfinite(final.pos))
