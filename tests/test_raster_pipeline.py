"""Raster-pipeline tests: gbuffer, shadows, tiled culling, post stack, frame."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from d3d12renderer_jax.render import post
from d3d12renderer_jax.render.camera import look_at
from d3d12renderer_jax.render.gbuffer import render_gbuffer
from d3d12renderer_jax.render.ibl import (
    brdf_lut, eval_irradiance_sh9, irradiance_sh9,
)
from d3d12renderer_jax.render.lights import (
    MAX_LIGHTS_PER_TILE, PointLights, cull_lights_tiled, make_point_lights,
)
from d3d12renderer_jax.render.pipeline import (
    RendererSettings, initial_frame_state, render_frame,
    render_frame_with_shadows,
)
from d3d12renderer_jax.render.shadows import (
    ShadowCache, fit_cascades, render_sun_shadow_maps, sample_sun_shadow,
)

from tests.test_render import make_scene  # reuse demo scene

W = H = 64


@pytest.fixture(scope="module")
def scene():
    return make_scene()


@pytest.fixture(scope="module")
def cam():
    return look_at(eye=(5, 3, 6), target=(0.5, 0.8, 0), aspect=1.0,
                   v_fov=math.radians(50))


@pytest.fixture(scope="module")
def gb(scene, cam):
    return jax.jit(lambda: render_gbuffer(scene, cam, W, H))()


def test_gbuffer_contents(gb):
    g = jax.device_get(gb)
    assert g.hit.any() and (~g.hit).any()      # objects and sky
    assert np.isfinite(g.depth[g.hit]).all()
    assert (g.depth[~g.hit] == np.inf).all()
    n = np.linalg.norm(g.normal[g.hit], axis=-1)
    np.testing.assert_allclose(n, 1.0, atol=1e-3)
    assert set(np.unique(g.object_id)) <= {-1, 0, 1, 2}


@pytest.mark.slow
def test_sun_shadow_maps(scene, cam):
    maps = fit_cascades(cam.position, -scene.sky.sun_direction)
    maps = jax.jit(lambda: render_sun_shadow_maps(scene.bvh, maps,
                                                  resolution=128))()
    gb = render_gbuffer(scene, cam, W, H)
    lit, cascade = sample_sun_shadow(maps, gb.world_pos)
    lit = np.asarray(lit)
    hit = np.asarray(gb.hit)
    # Some pixels shadowed, some lit.
    assert lit[hit].min() < 0.5 and lit[hit].max() > 0.5


def test_shadow_cache_policy():
    cache = ShadowCache()
    pos = np.array([1.0, 2.0, 3.0])
    assert cache.needs_render("sun", pos)
    assert not cache.needs_render("sun", pos)       # unchanged -> cached
    assert cache.needs_render("sun", pos + 0.1)     # moved -> re-render
    cache.invalidate()
    assert cache.needs_render("sun", pos + 0.1)


def test_tiled_light_culling_matches_bruteforce(scene, cam, gb):
    rng = np.random.default_rng(0)
    pos = rng.uniform(-4, 4, (32, 3)).astype(np.float32)
    pos[:, 1] = rng.uniform(0.2, 3, 32)
    lights = make_point_lights(pos, np.ones((32, 3), np.float32),
                               np.full(32, 2.0, np.float32))
    tile_lists, counts = jax.jit(
        lambda: cull_lights_tiled(gb.view_pos, lights, cam, W, H))()
    tl = np.asarray(tile_lists)
    assert tl.shape[-1] == MAX_LIGHTS_PER_TILE
    # Culling keeps at least every light that illuminates some tile pixel.
    vp = np.asarray(gb.view_pos)
    import d3d12renderer_jax.core.maths as m
    lp = np.asarray(m.quat_rotate(
        m.quat_conj(cam.rotation)[None],
        jnp.asarray(pos) - cam.position))
    ty, tx = tl.shape[0], tl.shape[1]
    for t_y in range(0, ty, 2):
        for t_x in range(0, tx, 2):
            tile_px = vp[t_y * 16:(t_y + 1) * 16, t_x * 16:(t_x + 1) * 16]
            tile_px = tile_px.reshape(-1, 3)
            ok = tile_px[:, 2] > -1e5
            if not ok.any():
                continue
            listed = set(tl[t_y, t_x][tl[t_y, t_x] >= 0].tolist())
            for li in range(32):
                d = np.linalg.norm(tile_px[ok] - lp[li], axis=-1).min()
                if d < 2.0 - 0.05 and len(listed) < MAX_LIGHTS_PER_TILE:
                    assert li in listed, f"light {li} missed in tile {t_y},{t_x}"


@pytest.mark.slow
def test_post_stack_functions():
    key = jax.random.PRNGKey(0)
    img = jax.random.uniform(key, (32, 32, 3)) * 2
    # Bloom adds energy above threshold.
    bloomed = post.bloom(img, post.BloomSettings(threshold=0.5, strength=0.5))
    assert float(bloomed.sum()) > float(img.sum())
    # Tonemap maps into [0, 1] and is monotonic.
    t1 = post.tonemap_uncharted2(jnp.array([0.5]))
    t2 = post.tonemap_uncharted2(jnp.array([5.0]))
    assert 0 <= float(t1[0]) < float(t2[0]) <= 1
    # Sharpen increases local contrast.
    edge = jnp.zeros((16, 16, 3)).at[:, 8:].set(1.0)
    sharp = post.sharpen(edge, post.SharpenSettings(strength=1.0))
    assert float(sharp.max()) > 1.0 - 1e-6
    # TAA blends toward history.
    cur = jnp.zeros((8, 8, 3))
    hist = jnp.ones((8, 8, 3)) * 0.5
    out = post.taa(cur, hist, jnp.zeros((8, 8, 2)),
                   post.TAASettings(blend=0.5))
    # Neighborhood clamp pulls history to current range (all zeros).
    assert float(out.max()) <= 0.5


def test_gaussian_blur_matmul_matches_shift_chain():
    """The banded-matmul blur must match the shift-chain convolution
    (same edge clamping) to bf16 resolution, and exactly in f32."""
    key = jax.random.PRNGKey(3)
    img = jax.random.uniform(key, (160, 130, 3))
    ref = post.gaussian_blur(img, sigma=2.0, method="shifts")
    mm16 = post.gaussian_blur_matmul(img, sigma=2.0)
    assert float(jnp.max(jnp.abs(mm16 - ref))) < 1.5e-2
    mm32 = post.gaussian_blur_matmul(img, sigma=2.0, dtype=jnp.float32)
    assert float(jnp.max(jnp.abs(mm32 - ref))) < 1e-5
    # 2D (no channel axis) path + the method switch.
    g = img[..., 0]
    assert post.gaussian_blur_matmul(g, sigma=1.5).shape == g.shape
    forced = post.gaussian_blur(img, sigma=2.0, method="matmul")
    assert float(jnp.max(jnp.abs(forced - ref))) < 1.5e-2


def test_hbao_darkens_creases(scene, cam, gb):
    ao = jax.jit(lambda: post.hbao(gb.view_pos, gb.view_normal))()
    ao = np.asarray(ao)
    hit = np.asarray(gb.hit)
    assert 0.0 <= ao.min() and ao.max() <= 1.0
    # Contact regions (sphere/ground junction) darker than open ground.
    assert ao[hit].min() < 0.9


@pytest.mark.slow
def test_full_frame_renders(scene, cam):
    lights = make_point_lights(
        [[2.0, 1.5, 2.0]], [[20.0, 5.0, 5.0]], [6.0])
    state = initial_frame_state(W, H)
    fn = jax.jit(lambda st, k: render_frame_with_shadows(
        scene, cam, W, H, RendererSettings(), shadow_resolution=128,
        point_lights=lights, frame_state=st, key=k))
    ldr, state, aux = fn(state, jax.random.PRNGKey(0))
    ldr2, state, aux = fn(state, jax.random.PRNGKey(1))
    img = np.asarray(ldr2)
    assert img.shape == (H, W, 3)
    assert np.isfinite(img).all()
    assert 0 <= img.min() and img.max() <= 1.0
    assert img.std() > 0.05  # actual content


def test_per_pass_dispatch_matches_fused(scene, cam):
    """dispatch='per_pass' (each stage its own jit program) must be
    numerically identical to the fused frame."""
    lights = make_point_lights(
        [[2.0, 1.5, 2.0]], [[20.0, 5.0, 5.0]], [6.0])
    state0 = initial_frame_state(W, H)
    k = jax.random.PRNGKey(0)
    fused = jax.jit(lambda st, kk: render_frame_with_shadows(
        scene, cam, W, H, RendererSettings(), shadow_resolution=128,
        point_lights=lights, frame_state=st, key=kk))
    ldr_f, state_f, _ = fused(state0, k)
    ldr_p, state_p, _ = render_frame_with_shadows(
        scene, cam, W, H, RendererSettings(), shadow_resolution=128,
        point_lights=lights, frame_state=state0, key=k, dispatch="per_pass")
    np.testing.assert_allclose(np.asarray(ldr_p), np.asarray(ldr_f),
                               atol=2e-5)
    assert int(state_p.frame_index) == int(state_f.frame_index) == 1

    # dispatch='grouped' (three module-level programs) must match too.
    ldr_g, state_g, aux_g = render_frame_with_shadows(
        scene, cam, W, H, RendererSettings(), shadow_resolution=128,
        point_lights=lights, frame_state=state0, key=k, dispatch="grouped")
    np.testing.assert_allclose(np.asarray(ldr_g), np.asarray(ldr_f),
                               atol=2e-5)
    assert int(state_g.frame_index) == 1
    assert {"ao", "shadow", "gbuffer", "ambient", "hdr"} <= set(aux_g)


@pytest.mark.slow
def test_ibl_sh_and_brdf_lut():
    # Constant white environment -> irradiance ~ pi-normalized constant.
    sh = irradiance_sh9(lambda d: jnp.ones((d.shape[0], 3)))
    irr = eval_irradiance_sh9(sh, jnp.array([[0.0, 1.0, 0.0]]))
    assert np.allclose(np.asarray(irr), np.asarray(irr)[0, 0], atol=0.1)
    assert float(irr[0, 0]) > 1.0  # ~pi for unit radiance

    lut = brdf_lut(resolution=16, num_samples=64)
    l = np.asarray(lut)
    assert l.shape == (16, 16, 2)
    assert np.isfinite(l).all()
    assert (l >= 0).all() and (l[..., 0] <= 1.5).all()


def test_water_pass_composites(scene, cam):
    from d3d12renderer_jax.render.gbuffer import render_gbuffer
    from d3d12renderer_jax.render.water_pass import water_pass

    gb = render_gbuffer(scene, cam, W, H)
    color = jnp.full((H, W, 3), 0.5)
    out = jax.jit(lambda c: water_pass(c, gb, cam, scene.sky,
                                       water_height=0.3, time=0.2))(color)
    out = np.asarray(out)
    assert np.isfinite(out).all()
    changed = np.abs(out - 0.5).max(-1) > 1e-3
    # Water covers part of the frame (rays crossing the plane) but not all
    # (sky above the horizon stays).
    assert 0.05 < changed.mean() < 0.95
    # Animated: a different time changes the surface.
    out2 = np.asarray(water_pass(color, gb, cam, scene.sky,
                                 water_height=0.3, time=1.7))
    assert np.abs(out2 - out).max() > 1e-3


@pytest.mark.slow
def test_renderer_modes(scene, cam):
    from d3d12renderer_jax.render.pipeline import render_mode

    vis = np.asarray(render_mode(scene, cam, 32, 32,
                                 mode="visualize_cascades"))
    assert np.isfinite(vis).all() and vis.max() > 0.1
    pt = np.asarray(render_mode(scene, cam, 32, 32, mode="path_traced",
                                spp=2, key=jax.random.PRNGKey(0)))
    assert np.isfinite(pt).all() and 0 <= pt.min() and pt.max() <= 1.0
    import pytest as _pytest
    with _pytest.raises(ValueError):
        render_mode(scene, cam, 8, 8, mode="nope")


@pytest.mark.slow
def test_render_resources_defaults():
    from d3d12renderer_jax.render import resources as rr

    assert float(rr.default_white().min()) == 1.0
    assert float(rr.default_black().max()) == 0.0
    nm = rr.default_normal_map()
    assert float(nm[0, 0, 2]) == 1.0
    lut = rr.brdf_lookup(16)
    assert lut.shape == (16, 16, 2)
    assert rr.brdf_lookup(16) is lut  # cached
    ck = np.asarray(rr.checker_texture(16, 4))
    assert len(np.unique(ck)) == 2


def test_decals_modify_gbuffer(scene, cam, gb):
    from d3d12renderer_jax.render.decals import apply_decals, make_decals

    decals = make_decals(
        positions=[[0.0, 0.0, 0.0]],
        rotations=[[0.0, 0.0, 0.0, 1.0]],
        half_extents=[[2.0, 1.0, 2.0]],
        albedos=[[1.0, 0.0, 0.0]],
    )
    gb2 = apply_decals(gb, decals)
    a0 = np.asarray(gb.albedo)
    a1 = np.asarray(gb2.albedo)
    changed = np.abs(a1 - a0).max(-1) > 1e-3
    hit = np.asarray(gb.hit)
    assert changed.any()
    assert not changed[~hit].any()  # decals only touch surfaces
    # Inside the box the albedo is pulled toward red.
    assert a1[changed][:, 0].mean() > a0[changed][:, 0].mean()


def test_textured_albedo_sampling():
    from d3d12renderer_jax.render import bvh as bvh_mod
    from d3d12renderer_jax.render import mesh as mesh_mod
    from d3d12renderer_jax.render.pathtracer import Materials, sample_albedo
    from d3d12renderer_jax.render.resources import checker_texture

    atlas = jnp.stack([checker_texture(16, 4)])
    mats = Materials(
        albedo=jnp.array([[1.0, 1.0, 1.0], [0.5, 0.5, 0.5]]),
        emissive=jnp.zeros((2, 3)),
        roughness=jnp.ones(2) * 0.5,
        metallic=jnp.zeros(2),
        texture_atlas=atlas,
        albedo_texture=jnp.array([0, -1], jnp.int32),
    )
    uv = jnp.array([[0.1, 0.1], [0.35, 0.1], [0.1, 0.1]])
    mat = jnp.array([0, 0, 1], jnp.int32)
    a = np.asarray(sample_albedo(mats, mat, uv))
    # Textured material varies across the checker; untextured stays constant.
    assert abs(a[0, 0] - a[1, 0]) > 0.1
    np.testing.assert_allclose(a[2], [0.5, 0.5, 0.5], atol=1e-6)


def test_moving_camera_motion_vectors(scene, cam):
    """G-buffer motion vectors for a MOVING camera (the flythrough path):
    zero when prev == current; predominantly horizontal and consistently
    signed for a pure horizontal dolly."""
    from d3d12renderer_jax.render.gbuffer import render_gbuffer

    gb0 = render_gbuffer(scene, cam, W, H, prev_camera=cam)
    hit = np.asarray(gb0.depth) < 1e9
    assert hit.sum() > 50
    m0 = np.asarray(gb0.motion)[hit]
    np.testing.assert_allclose(m0, 0.0, atol=1e-3)

    import d3d12renderer_jax.core.maths as m

    right = m.quat_rotate(cam.rotation[None], jnp.array([[1.0, 0.0, 0.0]]))[0]
    moved = cam.replace(position=cam.position + 0.4 * right)
    gb1 = render_gbuffer(scene, moved, W, H, prev_camera=cam)
    hit1 = np.asarray(gb1.depth) < 1e9
    m1 = np.asarray(gb1.motion)[hit1]
    assert np.abs(m1[:, 0]).mean() > 3 * np.abs(m1[:, 1]).mean()
    sx = np.sign(m1[:, 0][np.abs(m1[:, 0]) > 0.05])
    assert sx.size > 20 and (np.abs(sx.sum()) > 0.9 * sx.size)
