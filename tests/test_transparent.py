"""General transparent pass: per-pixel back-to-front compositing
(VERDICT r1 missing item 8; reference: src/rendering/render_pass.h:100).
"""

import numpy as np
import jax.numpy as jnp

from d3d12renderer_jax.render import bvh as bvh_mod
from d3d12renderer_jax.render import mesh as mesh_mod
from d3d12renderer_jax.render.camera import look_at
from d3d12renderer_jax.render.gbuffer import render_gbuffer
from d3d12renderer_jax.render.pathtracer import Materials, Scene, default_sky
from d3d12renderer_jax.render.pipeline import RendererSettings, render_frame
from d3d12renderer_jax.render.transparent import (
    TransparentObject, transparent_pass,
)


def _quad_at(z, half=1.0):
    q = mesh_mod.quad(half=half)
    # quad() lies in a plane; orient to face the camera (normal -z) by
    # rotating the ground quad 90 deg about x, then translating.
    import numpy as np
    p = q.positions.copy()
    p = np.stack([p[:, 0], p[:, 2], np.full_like(p[:, 0], 0.0)], -1)
    q.positions[:] = p + np.array([0, 0, z], np.float32)
    return q


def _scene():
    ground = mesh_mod.quad(half=8.0)
    b = bvh_mod.build_bvh([(ground, 0)])
    mats = Materials(
        albedo=jnp.array([[0.6, 0.6, 0.6]]), emissive=jnp.zeros((1, 3)),
        roughness=jnp.array([0.8]), metallic=jnp.array([0.0]),
    )
    return Scene(bvh=b, materials=mats, sky=default_sky())


def test_back_to_front_blend_order():
    scene = _scene()
    cam = look_at((0.0, 1.0, -6.0), (0.0, 1.0, 0.0))
    gb = render_gbuffer(scene, cam, 64, 48)
    base = jnp.full((48, 64, 3), 0.1)

    red = TransparentObject(
        bvh=bvh_mod.build_bvh([(mesh_mod.box((1.0, 1.0, 0.01)).transformed(
            translate=(0, 1.0, -2.0)), 0)]),
        color=(1.0, 0.0, 0.0), alpha=0.5)
    blue = TransparentObject(
        bvh=bvh_mod.build_bvh([(mesh_mod.box((1.0, 1.0, 0.01)).transformed(
            translate=(0, 1.0, 0.0)), 0)]),
        color=(0.0, 0.0, 1.0), alpha=0.5)

    # Order in the list must NOT matter — compositing is depth-sorted.
    out1 = np.asarray(transparent_pass(base, gb, cam, [red, blue],
                                       sky=scene.sky))
    out2 = np.asarray(transparent_pass(base, gb, cam, [blue, red],
                                       sky=scene.sky))
    np.testing.assert_allclose(out1, out2, atol=1e-5)

    # Center pixel sees red over blue over background: the near (red) layer
    # contributes at full alpha, the far (blue) layer attenuated.
    cpix = out1[24, 32]
    assert cpix[0] > cpix[2] > 0.0, f"blend order wrong: {cpix}"
    # A pixel outside both quads keeps the background.
    np.testing.assert_allclose(out1[2, 2], 0.1, atol=1e-5)


def test_opaque_depth_test():
    scene = _scene()
    cam = look_at((0.0, 1.0, -6.0), (0.0, 1.0, 0.0))
    gb = render_gbuffer(scene, cam, 64, 48)
    base = jnp.zeros((48, 64, 3))
    # A transparent plane BELOW the opaque ground: fully occluded.
    under = TransparentObject(
        bvh=bvh_mod.build_bvh([(mesh_mod.quad(half=4.0).transformed(
            translate=(0, -1.0, 0)), 0)]),
        color=(1.0, 1.0, 0.0), alpha=0.9)
    out = np.asarray(transparent_pass(base, gb, cam, [under], sky=scene.sky))
    # Ground pixels (lower half of frame) must be unchanged.
    assert out[40:, :, :].max() < 1e-5


def test_render_frame_with_transparents():
    scene = _scene()
    cam = look_at((0.0, 1.0, -6.0), (0.0, 1.0, 0.0))
    glass = TransparentObject(
        bvh=bvh_mod.build_bvh([(mesh_mod.box((0.8, 0.8, 0.05)).transformed(
            translate=(0, 1.0, -1.0)), 0)]),
        color=(0.4, 0.9, 0.5), alpha=0.4)
    settings = RendererSettings(enable_taa=False, enable_bloom=False)
    ldr, _, _ = render_frame(scene, cam, 64, 48, settings,
                             transparent_objects=[glass])
    img = np.asarray(ldr)
    assert np.isfinite(img).all()
    assert img.std() > 0.01
