"""Two-level instancing: device-side retransform + sim-to-render pipeline."""

import pytest
import math

import jax
import jax.numpy as jnp
import numpy as np

from d3d12renderer_jax.render import bvh as bvh_mod
from d3d12renderer_jax.render import mesh as mesh_mod
from d3d12renderer_jax.render.camera import look_at
from d3d12renderer_jax.render.instances import (
    build_instanced, render_bodies, retransform,
)
from d3d12renderer_jax.render.pathtracer import Materials, default_sky


def test_retransform_moves_instances():
    meshes = [(mesh_mod.box((0.5, 0.5, 0.5)), 0)]
    scene = build_instanced(meshes, instance_mesh=[0, 0])
    pos = jnp.array([[0.0, 0.0, 0.0], [3.0, 0.0, 0.0]])
    rot = jnp.tile(jnp.array([0.0, 0.0, 0.0, 1.0]), (2, 1))
    bvh = jax.jit(lambda p, r: retransform(scene, p, r))(pos, rot)

    # Ray down at x=3 hits the second instance's top face at y=0.5.
    o = jnp.array([[3.0, 5.0, 0.0], [0.0, 5.0, 0.0], [6.0, 5.0, 0.0]])
    d = jnp.tile(jnp.array([0.0, -1.0, 0.0]), (3, 1))
    res = bvh_mod.closest_hit(bvh, o, d)
    hit = np.asarray(res["hit"])
    assert hit[0] and hit[1] and not hit[2]
    np.testing.assert_allclose(float(res["t"][0]), 4.5, atol=1e-3)

    # Move instance 1 and re-run the SAME jitted fn: no recompile needed.
    pos2 = pos.at[1, 0].set(6.0)
    bvh2 = jax.jit(lambda p, r: retransform(scene, p, r))(pos2, rot)
    res2 = bvh_mod.closest_hit(bvh2, o, d)
    hit2 = np.asarray(res2["hit"])
    assert hit2[1] and hit2[2] and not hit2[0]


@pytest.mark.slow
def test_sim_to_render_on_device():
    """Physics step -> retransform -> path trace without host transfers."""
    from d3d12renderer_jax.physics.builder import SceneBuilder
    from d3d12renderer_jax.physics.step import physics_step
    from d3d12renderer_jax.physics.types import PhysicsSettings

    b = SceneBuilder()
    b.add_static_plane((0, 1, 0), 0.0)
    body = b.add_body(position=(0.0, 2.0, 0.0))
    b.add_sphere_collider(body, radius=0.5)
    arch, state = b.finalize()

    meshes = [(mesh_mod.ico_sphere(0.5, 2), 1), (mesh_mod.quad(half=8.0), 0)]
    # Instance 0 follows the body; instance 1 is the static ground (we pass
    # its pose as a fixed extra body slot).
    iscene = build_instanced(meshes, instance_mesh=[0, 1])
    mats = Materials(
        albedo=jnp.array([[0.5, 0.5, 0.5], [0.8, 0.2, 0.2]]),
        emissive=jnp.zeros((2, 3)),
        roughness=jnp.array([0.8, 0.4]),
        metallic=jnp.zeros(2),
    )
    cam = look_at(eye=(3, 2, 4), target=(0, 0.6, 0), aspect=1.0,
                  v_fov=math.radians(50))

    settings = PhysicsSettings()

    class FullState:
        pass

    @jax.jit
    def sim_and_render(state, key):
        state, _ = physics_step(arch, state, settings, 1 / 60)
        fs = FullState()
        pos = jnp.concatenate([state.pos, jnp.zeros((1, 3))])
        rot = jnp.concatenate(
            [state.rot, jnp.array([[0.0, 0.0, 0.0, 1.0]])])
        fs.pos, fs.rot = pos, rot
        img = render_bodies(iscene, fs, mats, default_sky(), cam, 32, 32,
                            spp=2, key=key)
        return state, img

    img = None
    for i in range(5):
        state, img = sim_and_render(state, jax.random.PRNGKey(i))
    img = np.asarray(img)
    assert img.shape == (32, 32, 3)
    assert np.isfinite(img).all() and img.std() > 0.005


def test_frustum_culling():
    from d3d12renderer_jax.scene.scene_rendering import (
        cull_spheres, frustum_planes,
    )

    cam = look_at(eye=(0, 0, 10), target=(0, 0, 0), aspect=1.0,
                  v_fov=math.radians(60))
    planes = frustum_planes(cam)
    centers = jnp.array([
        [0.0, 0.0, 0.0],      # dead center -> visible
        [0.0, 0.0, 20.0],     # behind the camera
        [100.0, 0.0, 0.0],    # far right outside
        [0.0, -100.0, 0.0],   # far below
        [6.2, 0.0, 0.0],      # outside but sphere overlaps the frustum edge
    ])
    radii = jnp.array([1.0, 1.0, 1.0, 1.0, 2.0])
    vis = np.asarray(cull_spheres(planes, centers, radii))
    assert vis[0] and not vis[1] and not vis[2] and not vis[3]
    assert vis[4]  # partially inside


def test_render_submission_from_scene():
    from d3d12renderer_jax.scene import components as C
    from d3d12renderer_jax.scene.scene import Scene
    from d3d12renderer_jax.scene.scene_rendering import RenderSubmission

    s = Scene()
    ball = s.create_entity("Ball")
    ball.add_component(C.Transform(position=(0.0, 1.0, 0.0)))
    ball.add_component(C.Mesh(primitive="sphere", params={"radius": 0.5}))
    ball.add_component(C.Material(albedo=(0.8, 0.1, 0.1)))
    far = s.create_entity("Far")
    far.add_component(C.Transform(position=(500.0, 0.0, 0.0)))
    far.add_component(C.Mesh(primitive="box",
                             params={"half_extents": (1, 1, 1)}))

    sub = RenderSubmission(s)
    cam = look_at(eye=(0, 1, 6), target=(0, 1, 0), aspect=1.0,
                  v_fov=math.radians(50))
    pos, rot = sub.instance_poses()
    bvh, vis = sub.visible_bvh(cam, pos, rot)
    vis = np.asarray(vis)
    assert vis[0] and not vis[1]

    # The culled instance contributes no hits.
    o = jnp.array([[0.0, 1.0, 6.0]])
    d = jnp.array([[0.0, 0.0, -1.0]])
    res = bvh_mod.closest_hit(bvh, o, d)
    assert bool(res["hit"][0])
    assert abs(float(res["t"][0]) - 5.5) < 1e-2
