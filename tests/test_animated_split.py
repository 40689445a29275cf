"""Animated render split: skinned meshes deform inside the per-frame BVH
rebuild (reference: renderAnimatedObjects, scene_rendering.cpp:548 + global
skinning dispatch, skinning.cpp:235).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from d3d12renderer_jax.assets.fbx import load_fbx, write_fbx_skinned
from d3d12renderer_jax.render import bvh as bvh_mod
from d3d12renderer_jax.render import mesh as mesh_mod
from d3d12renderer_jax.render.instances import build_instanced
from d3d12renderer_jax.render.skinned_instances import (
    build_frame_bvh, from_model_asset,
)
from tests.test_fbx_skin_anim import CLUSTERS, CPS, JOINTS, ROT_TRACKS, TRIS


def _skinned_asset(tmp_path):
    path = str(tmp_path / "arm.fbx")
    write_fbx_skinned(path, CPS, TRIS, JOINTS, CLUSTERS, ROT_TRACKS)
    asset = load_fbx(path)
    asset.animations[0].looping = False
    return asset


def test_skinned_triangles_move_with_the_clip(tmp_path):
    asset = _skinned_asset(tmp_path)
    inst = from_model_asset(asset)

    ground = mesh_mod.quad(half=4.0)
    rigid = build_instanced([(ground, 1)], [0])
    pos = jnp.zeros((1, 3))
    rot = jnp.zeros((1, 4)).at[:, 3].set(1.0)

    def corners(t):
        b = build_frame_bvh(rigid, pos, rot, [inst], [t])
        return jnp.concatenate(
            [b.tri_v0, b.tri_v0 + b.tri_e1, b.tri_v0 + b.tri_e2])

    fn = jax.jit(corners)
    v_t0 = np.asarray(fn(jnp.asarray(0.0)))
    v_t1 = np.asarray(fn(jnp.asarray(1.0)))

    # The rigid instance buffer is padded (build_instanced packs to a fixed
    # size); the skinned block appends after the padded block.
    n_rigid = rigid.v0.shape[0]
    n_tris = n_rigid + np.asarray(inst.indices).shape[0]
    ground_rows = np.concatenate([
        np.arange(n_rigid) + k * n_tris for k in range(3)])
    skin_rows = np.setdiff1d(np.arange(3 * n_tris), ground_rows)
    # Ground triangles identical at both times; skinned block moved.
    np.testing.assert_allclose(v_t0[ground_rows], v_t1[ground_rows],
                               atol=1e-6)
    sk0, sk1 = v_t0[skin_rows], v_t1[skin_rows]
    assert np.abs(sk0 - sk1).max() > 0.5, "skinned verts did not animate"
    # Upper verts rotate 90deg about z around the pivot (0,1,0):
    # (x, 2, z) -> (-1, 1 + x, z).
    hi_mask = np.abs(sk0[:, 1] - 2.0) < 1e-4
    assert hi_mask.any()
    np.testing.assert_allclose(sk1[hi_mask][:, 0], -1.0, atol=1e-2)
    np.testing.assert_allclose(sk1[hi_mask][:, 1], 1.0 + sk0[hi_mask][:, 0],
                               atol=1e-2)


@pytest.mark.slow
def test_frame_bvh_traces_animated_geometry(tmp_path):
    asset = _skinned_asset(tmp_path)
    inst = from_model_asset(asset)
    b0 = build_frame_bvh(None, None, None, [inst], [jnp.asarray(0.0)])
    b1 = build_frame_bvh(None, None, None, [inst], [jnp.asarray(1.0)])

    # The arm is a flat strip in the z=0 plane: x in [0,1], y in [0,2] at
    # t=0; at t=1 its upper half folds to x in [-1,0], y in [1,2].  Probe
    # with rays along +z through two points:
    o = jnp.array([
        [0.35, 1.5, -3.0],    # covered at t=0 only
        [-0.5, 1.2, -3.0],    # covered at t=1 only (strictly inside)
    ])
    d = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), o.shape)
    r0 = bvh_mod.closest_hit(b0, o, d)
    r1 = bvh_mod.closest_hit(b1, o, d)
    assert bool(r0["hit"][0]) and not bool(r0["hit"][1])
    assert not bool(r1["hit"][0]) and bool(r1["hit"][1])
