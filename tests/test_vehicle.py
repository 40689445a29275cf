"""Vehicle tests: assembly integrity, gear-driven power train, steering."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from d3d12renderer_jax.models.vehicle import build_vehicle, drive_overrides
from d3d12renderer_jax.physics.builder import SceneBuilder
from d3d12renderer_jax.physics.step import physics_step
from d3d12renderer_jax.physics.types import PhysicsSettings

DT = 1.0 / 60.0
# Gear meshing puts one body in ~100 candidate contact rows; the mass-splitting
# Jacobi contact mode avoids the long sequential color chains that a
# Gauss-Seidel ordering would need (see solver.py).
SETTINGS = PhysicsSettings(frame_rate=60, contact_mode="split_jacobi")


@pytest.fixture(scope="module")
def vehicle_scene():
    b = SceneBuilder()
    b.add_static_plane((0, 1, 0), 0.0, friction=1.0)
    info = build_vehicle(b, position=(0.0, 0.8, 0.0))
    arch, state = b.finalize()
    return b, info, arch, state


@pytest.mark.slow
def test_vehicle_settles_intact(vehicle_scene):
    b, info, arch, state = vehicle_scene
    step = jax.jit(lambda s: physics_step(arch, s, SETTINGS, DT)[0])
    for _ in range(120):
        state = step(state)
    final = jax.device_get(state)
    assert np.isfinite(final.pos).all()
    # Chassis stays above ground and near origin.
    # Wheel centers sit 0.51 above the chassis origin with radius-0.7 wheels,
    # so the chassis settles near y = 0.19 (minus contact sag).
    motor_pos = final.pos[info.bodies["motor"]]
    assert 0.03 < motor_pos[1] < 2.0
    assert np.linalg.norm(motor_pos[[0, 2]]) < 1.0
    # Wheels still attached (within 3m of chassis).
    for w in ["left_front_wheel", "right_front_wheel",
              "left_rear_wheel", "right_rear_wheel"]:
        assert np.linalg.norm(final.pos[info.bodies[w]] - motor_pos) < 3.5


@pytest.mark.slow
def test_motor_spins_gear_train(vehicle_scene):
    b, info, arch, state = vehicle_scene
    overrides = drive_overrides(arch, info, throttle_velocity=8.0,
                                steering_angle=0.0)
    step = jax.jit(
        lambda s: physics_step(arch, s, SETTINGS, DT, motor_overrides=overrides)[0]
    )
    for _ in range(180):
        state = step(state)
    final = jax.device_get(state)
    assert np.isfinite(final.pos).all()
    # Motor gear reaches commanded angular speed about its (vertical) axis.
    w_gear = final.omega[info.bodies["motor_gear"]]
    assert np.linalg.norm(w_gear) > 2.0
    # Tooth contact transfers rotation into the drive axis.
    w_drive = final.omega[info.bodies["drive_axis"]]
    assert np.linalg.norm(w_drive) > 0.3
