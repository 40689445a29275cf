"""DDGI ambient wiring + RT reflections pass (VERDICT r1 item 8).

Reference: probe update in the compute phase + opaque-pass ambient sampling
(src/rendering/main_renderer.cpp:917-925), one-bounce specular reflections
(src/rendering/raytraced_reflections.cpp) feeding the SSR resolve.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from d3d12renderer_jax.render import bvh as bvh_mod
from d3d12renderer_jax.render import mesh as mesh_mod
from d3d12renderer_jax.render.camera import look_at
from d3d12renderer_jax.render.gbuffer import render_gbuffer
from d3d12renderer_jax.render.light_probe import (
    create_probe_grid, update_probes,
)
from d3d12renderer_jax.render.pathtracer import Materials, Scene, default_sky
from d3d12renderer_jax.render.pipeline import (
    RendererSettings, render_frame, rt_reflections,
)


def _scene(metallic_ground=False):
    ground = mesh_mod.quad(half=6.0)
    sphere = mesh_mod.uv_sphere(0.8, 12, 18).transformed(translate=(0, 1.2, 0))
    b = bvh_mod.build_bvh([(ground, 0), (sphere, 1)])
    mats = Materials(
        albedo=jnp.array([[0.8, 0.8, 0.8], [0.9, 0.1, 0.1]]),
        emissive=jnp.array([[0.0, 0.0, 0.0], [4.0, 0.2, 0.2]]),
        roughness=jnp.array([0.05 if metallic_ground else 0.8, 0.6]),
        metallic=jnp.array([1.0 if metallic_ground else 0.0, 0.0]),
    )
    return Scene(bvh=b, materials=mats, sky=default_sky())


def test_rt_reflections_sees_emissive_sphere():
    scene = _scene(metallic_ground=True)
    cam = look_at((0.0, 1.5, -5.0), (0.0, 0.3, 0.0))
    gb = render_gbuffer(scene, cam, 96, 64)
    refl, mask = rt_reflections(scene, gb, cam)
    refl = np.asarray(refl)
    mask = np.asarray(mask)
    assert np.isfinite(refl).all()
    assert mask.any(), "mirror ground should be RT-active"
    # Mirror pixels under the red emissive sphere reflect red: somewhere the
    # red channel strongly dominates.
    red_excess = refl[..., 0] - refl[..., 2]
    assert red_excess.max() > 0.5, "no red sphere visible in reflections"


def test_render_frame_rt_reflections_blend():
    scene = _scene(metallic_ground=True)
    cam = look_at((0.0, 1.5, -5.0), (0.0, 0.3, 0.0))
    settings = RendererSettings(enable_taa=False, enable_bloom=False,
                                enable_rt_reflections=True)
    ldr, _, aux = render_frame(scene, cam, 96, 64, settings)
    assert "rt_reflections" in aux
    assert np.isfinite(np.asarray(ldr)).all()


@pytest.mark.slow
def test_probe_grid_ambient_in_frame():
    scene = _scene()
    grid = create_probe_grid(origin=(-4.0, 0.2, -4.0), extent=(8.0, 3.0, 8.0),
                             dims=(4, 2, 4))
    key = jax.random.PRNGKey(0)
    for i in range(3):
        grid = update_probes(grid, scene, jax.random.fold_in(key, i),
                             rays_per_probe=32)

    cam = look_at((0.0, 1.5, -5.0), (0.0, 0.3, 0.0))
    settings = RendererSettings(enable_taa=False, enable_bloom=False)
    ldr_probe, _, aux_probe = render_frame(scene, cam, 96, 64, settings,
                                           probe_grid=grid)
    ldr_hemi, _, aux_hemi = render_frame(scene, cam, 96, 64, settings)

    assert np.isfinite(np.asarray(ldr_probe)).all()
    # The probe ambient must differ from the hemisphere fallback (the red
    # emissive sphere bleeds into the probes) and must be red-tinted near
    # the sphere: mean red/blue ratio of the ambient term goes up.
    amb_p = np.asarray(aux_probe["ambient"])
    amb_h = np.asarray(aux_hemi["ambient"])
    assert amb_p.shape == amb_h.shape
    assert not np.allclose(amb_p, amb_h)
    ratio_p = amb_p[..., 0].mean() / (amb_p[..., 2].mean() + 1e-6)
    ratio_h = amb_h[..., 0].mean() / (amb_h[..., 2].mean() + 1e-6)
    assert ratio_p > ratio_h, "probe GI should carry the red emissive bounce"
