"""Particles, bitonic sort, and animation/skinning tests."""

import pytest
import jax
import jax.numpy as jnp
import numpy as np

from d3d12renderer_jax.animation.animation import (
    AnimationClip, LocalPose, blend_poses, extract_root_motion,
    forward_kinematics, make_skeleton, sample_clip, skinning_transforms,
)
from d3d12renderer_jax.animation.skinning import skin_vertices
from d3d12renderer_jax.particles import systems as psys
from d3d12renderer_jax.render.sort import bitonic_sort_kv, self_test


@pytest.mark.slow
def test_bitonic_sort_self_test():
    assert self_test(1000, descending=False)
    assert self_test(777, descending=True)   # non-power-of-two
    assert self_test(1, descending=False)


@pytest.mark.slow
def test_bitonic_matches_jnp_sort():
    keys = jax.random.normal(jax.random.PRNGKey(0), (513,))
    vals = jnp.arange(513, dtype=jnp.int32)
    k, v = bitonic_sort_kv(keys, vals)
    np.testing.assert_allclose(np.asarray(k), np.sort(np.asarray(keys)),
                               rtol=1e-6)


def run_system(sys_dict, steps, dt=1 / 60):
    pool = sys_dict["create"](jax.random.PRNGKey(0))
    step = jax.jit(lambda p: sys_dict["step"](p, dt))
    for _ in range(steps):
        pool = step(pool)
    return jax.device_get(pool)


def test_fire_emits_and_recycles():
    fire = psys.make_fire_system(capacity=256, emit_rate=120.0)
    pool = run_system(fire, 120)  # 2 s: past max lifetime, so slots recycle
    n = pool.alive.sum()
    assert 0 < n < 256
    assert np.isfinite(pool.position).all()
    # Fire rises.
    assert pool.position[pool.alive][:, 1].mean() > 0.1


def test_debris_bounces_and_stays_above_ground():
    debris = psys.make_debris_system(capacity=128, emit_rate=200.0)
    pool = run_system(debris, 90)
    assert pool.alive.sum() > 0
    assert pool.position[pool.alive][:, 1].min() >= -1e-3


def test_boids_flock_and_stay_bounded():
    boids = psys.make_boid_system(capacity=64, emit_rate=200.0)
    pool = run_system(boids, 180)
    alive = pool.alive
    assert alive.sum() > 10
    d = np.linalg.norm(pool.position[alive] - np.array([0, 5, 0]), axis=-1)
    assert d.max() < 30.0
    speed = np.linalg.norm(pool.velocity[alive], axis=-1)
    assert speed.max() <= 4.0 + 1e-3


def make_two_bone_rig():
    # Root at origin, child 1 unit up.
    skel = make_skeleton([-1, 0], np.array([[0.0, 0.0, 0.0], [0.0, 1.0, 0.0]]))
    k = 3
    positions = np.zeros((2, k, 3), np.float32)
    positions[1, :, 1] = 1.0
    rotations = np.zeros((2, k, 4), np.float32)
    rotations[..., 3] = 1.0
    # Child rotates 90 deg about z by the last key.
    rotations[1, 2] = [0, 0, np.sin(np.pi / 4), np.cos(np.pi / 4)]
    clip = AnimationClip(
        positions=jnp.asarray(positions), rotations=jnp.asarray(rotations),
        scales=jnp.ones((2, k)), duration=1.0, looping=False,
    )
    return skel, clip


def test_clip_sampling_and_fk():
    skel, clip = make_two_bone_rig()
    pose0 = sample_clip(clip, 0.0)
    wp, wr = forward_kinematics(skel, pose0)
    np.testing.assert_allclose(np.asarray(wp[1]), [0, 1, 0], atol=1e-5)

    pose1 = sample_clip(clip, 1.0)
    wp1, wr1 = forward_kinematics(skel, pose1)
    # Child joint ORIGIN stays at its local offset; its rotation changed.
    np.testing.assert_allclose(np.asarray(wp1[1]), [0, 1, 0], atol=1e-5)
    angle = 2 * np.arccos(np.clip(abs(float(wr1[1][3])), -1, 1))
    assert abs(angle - np.pi / 2) < 1e-3

    # Blending halves the rotation.
    blended = blend_poses(pose0, pose1, 0.5)
    _, wrb = forward_kinematics(skel, blended)
    angle_b = 2 * np.arccos(np.clip(abs(float(wrb[1][3])), -1, 1))
    assert abs(angle_b - np.pi / 4) < 0.05


def test_skinning_follows_joints():
    skel, clip = make_two_bone_rig()
    pose = sample_clip(clip, 1.0)
    wp, wr = forward_kinematics(skel, pose)
    sp, sr = skinning_transforms(skel, wp, wr)

    # A vertex at the child joint, fully bound to it, rotates with it.
    verts = jnp.array([[0.0, 2.0, 0.0]])  # 1 above child (bind pose)
    normals = jnp.array([[0.0, 1.0, 0.0]])
    ji = jnp.array([[1, 0, 0, 0]], jnp.int32)
    jw = jnp.array([[1.0, 0.0, 0.0, 0.0]])
    out_p, out_n = skin_vertices(verts, normals, ji, jw, sp, sr)
    # 90 deg about z: offset (0,1,0) from joint becomes (-1,0,0).
    np.testing.assert_allclose(np.asarray(out_p[0]), [-1, 1, 0], atol=1e-4)


def test_root_motion_extraction():
    skel, clip = make_two_bone_rig()
    moving = clip.replace(
        positions=clip.positions.at[0, :, 0].set(jnp.array([0.0, 1.0, 2.0]))
    )
    in_place, ground = extract_root_motion(moving)
    assert abs(float(in_place.positions[0, 2, 0])) < 1e-6
    np.testing.assert_allclose(np.asarray(ground[:, 0]), [0, 1, 2], atol=1e-6)
