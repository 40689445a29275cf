"""Spot/point shadows + atlas packing + static cache (VERDICT r1 item 6).

Reference parity targets: spot + dual-hemisphere point shadow maps packed
into one atlas (src/rendering/shadow_map.cpp, render_resources.h:11-12) with
the movement-hash static cache (shadow_map_cache.cpp:179); a 3-light scene
(sun + spot + point) rendered through render_frame with all three shadow
types sampled per light.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from d3d12renderer_jax.render import bvh as bvh_mod
from d3d12renderer_jax.render import mesh as mesh_mod
from d3d12renderer_jax.render.camera import look_at
from d3d12renderer_jax.render.lights import (
    make_point_lights, SpotLights,
)
from d3d12renderer_jax.render.pathtracer import (
    Materials, Scene, default_sky,
)
from d3d12renderer_jax.render.pipeline import (
    RendererSettings, render_frame,
)
from d3d12renderer_jax.render.shadows import (
    ShadowAtlas, render_point_shadow_map, render_spot_shadow_map,
    sample_point_shadow, sample_spot_shadow,
)


def _occluder_scene():
    """Ground plane + a box hovering at y=1 (casts shadows downward)."""
    ground = mesh_mod.quad(half=6.0)
    box = mesh_mod.box((0.5, 0.1, 0.5)).transformed(translate=(0, 1.0, 0))
    return bvh_mod.build_bvh([(ground, 0), (box, 1)])


def test_spot_shadow_blocks_behind_occluder():
    b = _occluder_scene()
    # Spot light above, pointing straight down; box shadows the origin.
    smap = render_spot_shadow_map(
        b, position=(0.0, 4.0, 0.0), direction=(0.0, -1.0, 0.0),
        outer_cos=0.7, max_range=10.0, resolution=128)
    pts = jnp.array([
        [0.0, 0.01, 0.0],    # under the box -> shadowed
        [1.8, 0.01, 1.8],    # inside cone, away from box -> lit
    ])
    vis = sample_spot_shadow(smap, pts, pcf=False)
    assert float(vis[0]) < 0.5, "point under occluder should be shadowed"
    assert float(vis[1]) > 0.5, "clear point should be lit"


def test_point_shadow_dual_hemisphere():
    b = _occluder_scene()
    # Point light above the box: ground under the box is shadowed, the
    # ground far to the side is lit; both hemispheres must return sane
    # visibility (light positioned so rays go both +Z and -Z).
    pmap = render_point_shadow_map(b, position=(0.0, 3.0, 0.0),
                                   max_range=12.0, resolution=128)
    pts = jnp.array([
        [0.0, 0.01, 0.0],     # directly below, blocked by the box
        [3.0, 0.01, 3.0],     # off to the side, lit
        [0.0, 0.01, -3.0],    # other hemisphere, lit
    ])
    vis = sample_point_shadow(pmap, pts, pcf=False)
    assert float(vis[0]) < 0.5
    assert float(vis[1]) > 0.5
    assert float(vis[2]) > 0.5


def test_atlas_packing_and_static_cache():
    b = _occluder_scene()
    atlas = ShadowAtlas(size=2048)

    atlas.update_sun(b, jnp.zeros(3), (-0.5, 0.8, -0.3), resolution=128)
    atlas.update_spot(b, 0, (0.0, 4.0, 0.0), (0.0, -1.0, 0.0), 0.7, 10.0,
                      resolution=128)
    atlas.update_point(b, 0, (0.0, 3.0, 0.0), 12.0, resolution=128)
    first_misses = atlas.cache.misses
    assert first_misses == 5  # 3 cascades + spot + point
    assert len(atlas.viewports) == 5
    # Viewports must not overlap.
    boxes = list(atlas.viewports.values())
    for i in range(len(boxes)):
        for j in range(i + 1, len(boxes)):
            y0, x0, h0, w0 = boxes[i]
            y1, x1, h1, w1 = boxes[j]
            assert (y0 + h0 <= y1 or y1 + h1 <= y0
                    or x0 + w0 <= x1 or x1 + w1 <= x0)

    # Second pass, nothing moved: all cache hits, no re-render.
    atlas.update_sun(b, jnp.zeros(3), (-0.5, 0.8, -0.3), resolution=128)
    atlas.update_spot(b, 0, (0.0, 4.0, 0.0), (0.0, -1.0, 0.0), 0.7, 10.0,
                      resolution=128)
    atlas.update_point(b, 0, (0.0, 3.0, 0.0), 12.0, resolution=128)
    assert atlas.cache.misses == first_misses
    assert atlas.cache.hits == 5

    # Moving the spot light invalidates exactly that viewport.
    atlas.update_spot(b, 0, (0.5, 4.0, 0.0), (0.0, -1.0, 0.0), 0.7, 10.0,
                      resolution=128)
    assert atlas.cache.misses == first_misses + 1

    # The sampled map from the atlas works.
    smap = atlas._maps[("spot", 0)]
    vis = sample_spot_shadow(
        smap, jnp.array([[0.5, 0.01, 0.0], [2.3, 0.01, 2.3]]), pcf=False)
    assert float(vis[0]) < 0.5 and float(vis[1]) > 0.5


@pytest.mark.slow
def test_render_frame_three_shadowed_light_types():
    b = _occluder_scene()
    mats = Materials(
        albedo=jnp.array([[0.7, 0.7, 0.7], [0.8, 0.3, 0.3]]),
        emissive=jnp.zeros((2, 3)),
        roughness=jnp.array([0.8, 0.5]),
        metallic=jnp.array([0.0, 0.0]),
    )
    scene = Scene(bvh=b, materials=mats, sky=default_sky())
    cam = look_at((0.0, 3.0, -6.0), (0.0, 0.5, 0.0))

    atlas = ShadowAtlas(size=2048)
    sun_maps = atlas.update_sun(b, cam.position, -scene.sky.sun_direction,
                                resolution=128)
    smap = atlas.update_spot(b, 0, (2.0, 4.0, 0.0), (-0.45, -0.9, 0.0),
                             0.6, 12.0, resolution=128)
    pmap = atlas.update_point(b, 0, (-2.0, 3.0, 0.0), 12.0, resolution=128)

    points = make_point_lights([(-2.0, 3.0, 0.0)], [(8.0, 7.0, 6.0)], [12.0])
    spots = SpotLights(
        position=jnp.array([[2.0, 4.0, 0.0]]),
        direction=jnp.array([[-0.45, -0.9, 0.0]]) / np.linalg.norm([-0.45, -0.9, 0.0]),
        color=jnp.array([[9.0, 8.0, 7.0]]),
        distance=jnp.array([12.0]),
        inner_cos=jnp.array([0.8]),
        outer_cos=jnp.array([0.6]),
        valid=jnp.array([True]),
    )

    settings = RendererSettings(enable_taa=False, enable_bloom=False)
    ldr, _, aux = render_frame(
        scene, cam, 96, 64, settings,
        point_lights=points, spot_lights=spots,
        shadow_maps=sun_maps,
        spot_shadow_maps=[smap], point_shadow_maps=[pmap],
    )
    img = np.asarray(ldr)
    assert img.shape == (64, 96, 3)
    assert np.isfinite(img).all()
    assert img.std() > 0.01, "degenerate image"
