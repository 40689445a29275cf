"""Scene/ECS layer tests: entity API, views, YAML round-trip, compilation."""

import pytest
import math

import jax
import numpy as np

from d3d12renderer_jax.scene import components as C
from d3d12renderer_jax.scene.scene import Scene
from d3d12renderer_jax.physics.step import physics_step
from d3d12renderer_jax.physics.types import PhysicsSettings


def build_demo_scene() -> Scene:
    s = Scene()
    s.add_static_plane((0, 1, 0), 0.0)
    ball = s.create_entity("Ball")
    ball.add_component(C.Transform(position=(0.0, 3.0, 0.0)))
    ball.add_component(C.RigidBody())
    ball.add_component(C.Collider(shape="sphere", size=(0.5,), density=800.0))
    ball.add_component(C.Mesh(primitive="sphere", params={"radius": 0.5}))
    ball.add_component(C.Material(albedo=(0.8, 0.2, 0.2), roughness=0.4))

    ground = s.create_entity("GroundVis")
    ground.add_component(C.Transform())
    ground.add_component(C.Mesh(primitive="quad", params={"half": 10.0}))

    sun = s.create_entity("Sun")
    sun.add_component(C.DirectionalLight())
    return s


def test_entity_view_semantics():
    s = build_demo_scene()
    both = list(s.view("transform", "rigid_body"))
    assert len(both) == 1 and both[0][0].name == "Ball"
    meshes = list(s.view("transform", "mesh"))
    assert len(meshes) == 2
    assert s.count("collider") == 1


def test_compile_physics_and_step():
    s = build_demo_scene()
    arch, state, mapping = s.compile_physics()
    assert arch.num_bodies == 1
    step = jax.jit(lambda st: physics_step(arch, st, PhysicsSettings(), 1 / 60)[0])
    for _ in range(180):
        state = step(state)
    final = jax.device_get(state)
    bi = mapping[[e.id for e, _ in s.view("rigid_body")][0]]
    assert abs(final.pos[bi][1] - 0.5) < 0.02


def test_yaml_roundtrip(tmp_path):
    s = build_demo_scene()
    p = str(tmp_path / "scene.yaml")
    s.save_yaml(p)
    s2 = Scene.load_yaml(p)
    assert len(list(s2.view())) == 3
    ball = [e for e, _ in s2.view("rigid_body")][0]
    assert ball.name == "Ball"
    col = ball.get("collider")[0]
    assert col.shape == "sphere" and abs(col.density - 800.0) < 1e-6
    # Compiled physics behaves identically.
    arch, state, _ = s2.compile_physics()
    assert arch.num_bodies == 1


def test_scene_clone_is_independent():
    s = build_demo_scene()
    s2 = s.clone()
    e = s2.create_entity("Extra")
    assert len(list(s2.view())) == 4
    assert len(list(s.view())) == 3


@pytest.mark.slow
def test_render_from_scene():
    s = build_demo_scene()
    rscene = s.build_render_scene()
    from d3d12renderer_jax.render.camera import look_at
    from d3d12renderer_jax.render.pathtracer import PathTracerSettings, render

    cam = look_at(eye=(4, 3, 4), target=(0, 1, 0), aspect=1.0,
                  v_fov=math.radians(50))
    img = jax.jit(lambda k: render(rscene, cam, 32, 32,
                                   PathTracerSettings(recursion_depth=1),
                                   spp=2, key=k))(jax.random.PRNGKey(0))
    img = np.asarray(img)
    assert np.isfinite(img).all() and img.std() > 0.001
