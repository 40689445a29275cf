"""Tile-binned rasterizer (ops/raster.py) parity vs the ray path.

The rasterizer must produce the same primary visibility as
render/bvh.closest_hit: same winning triangle per pixel (up to depth ties),
matching t and barycentrics.  Reference contract: the depth prepass G-buffer
(src/rendering/depth_prepass.h) whose equivalent here is render/gbuffer.py.
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from d3d12renderer_jax.ops import raster as rp
from d3d12renderer_jax.render import bvh as bvh_mod
from d3d12renderer_jax.render import mesh as mesh_mod
from d3d12renderer_jax.render.camera import generate_rays, look_at


def _demo_scene():
    ground = mesh_mod.quad(half=30.0)
    sphere = mesh_mod.ico_sphere(1.0, 2).transformed(translate=(0, 1.0, 0))
    box = mesh_mod.box((0.7, 0.7, 0.7)).transformed(
        translate=(2.2, 0.7, -0.5),
        rotate=(0.0, math.sin(0.3), 0.0, math.cos(0.3)))
    torus = mesh_mod.torus(0.9, 0.3).transformed(translate=(0.8, 0.3, 2.2))
    return [(ground, 0), (sphere, 1), (box, 3), (torus, 4)]


def _parity(scene, eye, target, w, h, fov=60.0, min_hit_frac=0.2):
    cam = look_at(eye, target, v_fov=math.radians(fov), aspect=w / h)
    b = bvh_mod.build_bvh(scene)
    res_r = rp.closest_hit_raster(b, cam, w, h)
    o, d = generate_rays(cam, w, h)
    res_ray = bvh_mod.closest_hit(b, o, d)

    hit_r = np.asarray(res_r["hit"])
    hit_t = np.asarray(res_ray["hit"])
    n = hit_r.size
    assert hit_t.mean() > min_hit_frac  # the view must actually see things

    # Coverage: silhouette pixels may disagree by one ulp of edge math.
    cov_diff = (hit_r != hit_t).mean()
    assert cov_diff < 0.005, f"coverage differs on {cov_diff:.2%} of pixels"

    both = hit_r & hit_t
    t_r = np.asarray(res_r["t"])[both]
    t_t = np.asarray(res_ray["t"])[both]
    tri_r = np.asarray(res_r["tri"])[both]
    tri_t = np.asarray(res_ray["tri"])[both]
    # Same triangle, or a depth tie (coplanar seams): t must always agree.
    rel = np.abs(t_r - t_t) / np.maximum(t_t, 1e-6)
    assert np.percentile(rel, 99.9) < 1e-3, rel.max()
    same_tri = (tri_r == tri_t).mean()
    assert same_tri > 0.99, f"winners differ on {1 - same_tri:.2%}"
    uv_r = np.asarray(res_r["uv"])[both]
    uv_t = np.asarray(res_ray["uv"])[both]
    match = tri_r == tri_t
    uv_err = np.abs(uv_r[match] - uv_t[match])
    # Closed-form t loses ~1e-4 relative at glancing silhouette pixels,
    # which amplifies into uv on large triangles; bulk must be exact.
    assert np.percentile(uv_err, 99) < 2e-3
    assert uv_err.max() < 0.05


def test_parity_demo_scene():
    _parity(_demo_scene(), (0.0, 1.5, -6.0), (0.0, 1.0, 0.0), 128, 96)


def test_parity_sphere_grid():
    _parity(mesh_mod.sphere_grid_scene(3, 8), (0.0, 1.5, -6.0),
            (0.0, 1.0, 0.0), 128, 64)


def test_near_plane_crossing():
    """A ground plane extending BEHIND the camera: its triangles cross w=0
    and must still rasterize exactly where the rays hit (the 2DH sign rules
    replace clipping)."""
    scene = _demo_scene()
    # Camera low and tilted down so ground triangles span the near plane.
    _parity(scene, (0.0, 0.4, -2.0), (0.0, 0.2, 2.0), 128, 64)


def test_jitter_matches_jittered_rays():
    """Sub-pixel jitter shifts raster sampling exactly like ray offsets."""
    scene = _demo_scene()
    w, h = 96, 64
    cam = look_at((0.0, 1.5, -6.0), (0.0, 1.0, 0.0),
                  v_fov=math.radians(60), aspect=w / h)
    b = bvh_mod.build_bvh(scene)
    jit = (0.25, 0.75)
    res_r = rp.closest_hit_raster(b, cam, w, h, jitter=jit)
    # Rays through the same jittered sub-pixel positions.
    px = jnp.arange(w, dtype=jnp.float32)
    py = jnp.arange(h, dtype=jnp.float32)
    gx, gy = jnp.meshgrid(px, py)
    ndc_x = (gx + jit[0]) / w * 2.0 - 1.0
    ndc_y = 1.0 - (gy + jit[1]) / h * 2.0
    th = math.tan(cam.v_fov * 0.5)
    from d3d12renderer_jax.core import maths as m
    dir_cam = jnp.stack([ndc_x * th * cam.aspect, ndc_y * th,
                         -jnp.ones_like(ndc_x)], -1).reshape(-1, 3)
    d = m.quat_rotate(cam.rotation[None], dir_cam)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    o = jnp.broadcast_to(cam.position, d.shape)
    res_ray = bvh_mod.closest_hit(b, o, d)
    both = np.asarray(res_r["hit"]) & np.asarray(res_ray["hit"])
    assert both.mean() > 0.2
    rel = np.abs(np.asarray(res_r["t"])[both] - np.asarray(res_ray["t"])[both])
    rel /= np.maximum(np.asarray(res_ray["t"])[both], 1e-6)
    assert np.percentile(rel, 99.9) < 1e-3


def test_empty_view():
    """A camera looking at nothing: every pixel misses, outputs well-formed."""
    scene = _demo_scene()
    w, h = 64, 32
    cam = look_at((0.0, 1.0, -6.0), (0.0, 20.0, -12.0),
                  v_fov=math.radians(60), aspect=w / h)
    b = bvh_mod.build_bvh(scene)
    res = rp.closest_hit_raster(b, cam, w, h)
    assert not bool(np.asarray(res["hit"]).any())
    assert np.all(np.asarray(res["tri"]) == -1)


def test_visit_overflow_counter():
    """The per-tile cap drops farthest groups only, and reports the count."""
    scene = mesh_mod.sphere_grid_scene(3, 8)
    w, h = 64, 32
    cam = look_at((0.0, 1.5, -6.0), (0.0, 1.0, 0.0),
                  v_fov=math.radians(60), aspect=w / h)
    b = bvh_mod.build_bvh(scene)
    mat, attr = rp.perspective_rows(cam, w, h)
    tables = rp.build_frame_tables(b.tri_v0, b.tri_e1, b.tri_e2, b.tri_valid,
                                   mat, attr, w, h)
    _, counts, _, overflow = rp.visit_plan(tables, w, h)
    assert int(counts.min()) >= 1
    assert int(overflow) >= 0


def test_occlusion_feedback_exact():
    """Two-phase occlusion feedback must be EXACT: results with feedback
    (own, stale-from-other-camera, or garbage) equal the no-feedback pass."""
    scene = mesh_mod.sphere_grid_scene(3, 8)
    w, h = 128, 64
    cam = look_at((0.0, 1.5, -6.0), (0.0, 1.0, 0.0),
                  v_fov=math.radians(60), aspect=w / h)
    cam2 = look_at((4.0, 2.5, -5.0), (0.0, 1.0, 0.0),
                   v_fov=math.radians(60), aspect=w / h)
    b = bvh_mod.build_bvh(scene)
    base = rp.closest_hit_raster(b, cam, w, h)
    # Static case: feed back this frame's own tile_qmin.
    again = rp.closest_hit_raster(b, cam, w, h,
                                  tile_qmin=base["tile_qmin"])
    np.testing.assert_array_equal(np.asarray(base["tri"]),
                                  np.asarray(again["tri"]))
    # Moving case: feedback computed from a very different view.
    stale = rp.closest_hit_raster(b, cam2, w, h)
    moved = rp.closest_hit_raster(b, cam, w, h,
                                  tile_qmin=stale["tile_qmin"])
    np.testing.assert_array_equal(np.asarray(base["tri"]),
                                  np.asarray(moved["tri"]))
    np.testing.assert_allclose(np.asarray(base["t"])[np.asarray(base["hit"])],
                               np.asarray(moved["t"])[np.asarray(moved["hit"])],
                               rtol=1e-6)
    # Adversarial garbage feedback (too-near bound everywhere).
    garbage = jnp.full_like(base["tile_qmin"], 1e6)
    adv = rp.closest_hit_raster(b, cam, w, h,
                                tile_qmin=garbage)
    np.testing.assert_array_equal(np.asarray(base["tri"]),
                                  np.asarray(adv["tri"]))
