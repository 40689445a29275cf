"""Render-transform interpolation between fixed substeps
(VERDICT r1 missing item 10; reference: src/physics/physics.cpp:1394-1400).
"""

import numpy as np
import jax.numpy as jnp

from d3d12renderer_jax.physics.builder import SceneBuilder
from d3d12renderer_jax.physics.step import (
    physics_step, physics_step_interpolated,
)
from d3d12renderer_jax.physics.types import PhysicsSettings


def _scene():
    b = SceneBuilder()
    body = b.add_body(position=(0.0, 10.0, 0.0), linear_damping=0.0,
                      angular_damping=0.0)
    b.add_sphere_collider(body, radius=0.1)
    return b.finalize()


def test_accumulator_and_substep_counts():
    arch, state = _scene()
    settings = PhysicsSettings()          # 120 Hz
    dt = 1.0 / 50.0                       # 2.4 substeps per frame
    acc = 0.0
    subs = []
    for _ in range(5):
        prev_y = float(state.pos[0, 1])
        state, _, acc, (rp, rr) = physics_step_interpolated(
            arch, state, settings, dt, acc)
        # Count how far the sim advanced this frame.
        subs.append(round((prev_y != float(state.pos[0, 1])) and 1 or 0))
        assert 0.0 <= acc < 1.0 / 120.0 + 1e-9
    # Over 5 frames of 1/50s the sim must have consumed 12 substeps.
    # (5 * 2.4 = 12 exactly.)
    assert acc < 1e-6 or acc > 1.0 / 120.0 - 1e-6


def test_render_pose_lies_between_substep_poses():
    arch, state = _scene()
    settings = PhysicsSettings()
    dt = 1.0 / 50.0

    # Manually advance to get the two bounding substep poses.
    s_manual = state
    poses = [float(s_manual.pos[0, 1])]
    for _ in range(3):
        s_manual, _ = physics_step(arch, s_manual, settings, 1.0 / 120.0,
                                   num_substeps=1)
        poses.append(float(s_manual.pos[0, 1]))

    state2, _, acc, (rp, rr) = physics_step_interpolated(
        arch, state, settings, dt, 0.0)
    # dt = 2.4 substeps: 2 executed, accumulator = 0.4 * h.
    np.testing.assert_allclose(acc, 0.4 / 120.0, atol=1e-9)
    y_render = float(rp[0, 1])
    lo, hi = sorted((poses[1], poses[2]))
    assert lo - 1e-6 <= y_render <= hi + 1e-6, \
        f"render y {y_render} outside substep poses [{lo}, {hi}]"
    expect = poses[1] + (poses[2] - poses[1]) * 0.4
    np.testing.assert_allclose(y_render, expect, atol=1e-5)
    # Quaternion stays unit.
    np.testing.assert_allclose(np.linalg.norm(np.asarray(rr)[0]), 1.0,
                               atol=1e-5)


def test_frame_drop_guard():
    arch, state = _scene()
    settings = PhysicsSettings()
    # A huge dt gets capped at max_substeps (reference: "Dropping physics
    # frames", physics.cpp:1385-1391).
    _, _, acc, _ = physics_step_interpolated(arch, state, settings, 1.0, 0.0)
    assert acc < 1.0 / 120.0 + 1e-9
