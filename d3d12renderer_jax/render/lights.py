"""Punctual lights + tiled light culling + deferred PBR shading.

Reference: light types src/rendering/light_source.h (point_light/spot_light,
512-entry buffers application.cpp:389-391); tiled 16x16 light/decal culling
shaders/light_culling/light_culling_cs.hlsl (per-tile frusta, packed index
lists for opaque+transparent); Cook-Torrance shading
shaders/geometry/default_pbr_ps.hlsl + common/brdf.hlsli.

Design: culling = one vectorized tiles x lights test producing a fixed
(Tiles, MAX_LIGHTS_PER_TILE) index table; shading gathers each pixel's tile
list — both dense, masked ops.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from ..core import struct

from ..core import maths as m
from .pathtracer import _fresnel_schlick, _ggx_d, _smith_g

TILE_SIZE = 16                 # reference: 16x16 culling tiles
MAX_LIGHTS_PER_TILE = 16
MAX_POINT_LIGHTS = 512         # reference: application.cpp:389


@struct.dataclass
class PointLights:
    position: jnp.ndarray   # (L, 3)
    color: jnp.ndarray      # (L, 3) radiance * intensity
    radius: jnp.ndarray     # (L,)
    valid: jnp.ndarray      # (L,)


@struct.dataclass
class SpotLights:
    position: jnp.ndarray   # (L, 3)
    direction: jnp.ndarray  # (L, 3)
    color: jnp.ndarray      # (L, 3)
    distance: jnp.ndarray   # (L,)
    inner_cos: jnp.ndarray  # (L,)
    outer_cos: jnp.ndarray  # (L,)
    valid: jnp.ndarray      # (L,)


def make_point_lights(positions, colors, radii) -> PointLights:
    import numpy as np
    l = len(positions)
    return PointLights(
        position=jnp.asarray(np.asarray(positions, np.float32)),
        color=jnp.asarray(np.asarray(colors, np.float32)),
        radius=jnp.asarray(np.asarray(radii, np.float32)),
        valid=jnp.ones(l, bool),
    )


def cull_lights_tiled(gbuffer_view_pos, lights: PointLights,
                      camera, width, height):
    """Per-tile light lists (reference: light_culling_cs.hlsl).

    Tiles bound their view-space pixel positions; a light passes if its
    bounding sphere (view space) intersects the tile's AABB extended in z.
    Returns (tiles_y, tiles_x, MAX_LIGHTS_PER_TILE) int32, -1 padded."""
    h, w, _ = gbuffer_view_pos.shape
    ty, tx = -(-h // TILE_SIZE), -(-w // TILE_SIZE)
    pad_h, pad_w = ty * TILE_SIZE - h, tx * TILE_SIZE - w
    # Guard the pad: edge-mode jnp.pad with zero widths lowers to concats of
    # ZERO-SIZED slices (see maths.roll2).
    if pad_h or pad_w:
        vp = jnp.pad(gbuffer_view_pos, ((0, pad_h), (0, pad_w), (0, 0)),
                     mode="edge")
    else:
        vp = gbuffer_view_pos
    tiles = vp.reshape(ty, TILE_SIZE, tx, TILE_SIZE, 3).transpose(0, 2, 1, 3, 4)
    tiles = tiles.reshape(ty, tx, -1, 3)
    # Ignore sky pixels (|z| huge) when bounding.
    zvalid = tiles[..., 2] > -1e5
    big = jnp.where(zvalid[..., None], tiles, jnp.inf)
    small = jnp.where(zvalid[..., None], tiles, -jnp.inf)
    t_min = jnp.min(big, axis=2)     # (ty, tx, 3)
    t_max = jnp.max(small, axis=2)
    any_valid = jnp.any(zvalid, axis=2)

    # Lights into view space.
    lp = m.quat_inv_rotate(camera.rotation[None], lights.position - camera.position)
    # Sphere vs AABB distance.
    c = jnp.clip(lp[None, None, :, :], t_min[:, :, None, :], t_max[:, :, None, :])
    dist = jnp.linalg.norm(c - lp[None, None, :, :] + 1e-9, axis=-1)
    inside = (dist < lights.radius[None, None, :]) & lights.valid[None, None, :]
    inside = inside & any_valid[..., None]

    # Fixed-size per-tile list: indices of the first K passing lights.
    k = min(MAX_LIGHTS_PER_TILE, lights.position.shape[0])
    order = jnp.argsort(~inside, axis=-1, stable=True)[..., :k]
    count = jnp.sum(inside, -1)
    slot_ok = jnp.arange(k)[None, None, :] < count[..., None]
    return jnp.where(slot_ok, order, -1), count


def eval_brdf_pixel(n, v, l, albedo, roughness, metallic):
    """Per-pixel Cook-Torrance (image-shaped inputs)."""
    alpha = jnp.maximum(roughness * roughness, 1e-3)
    h = m.noz(v + l)
    n_dot_v = jnp.maximum(jnp.sum(n * v, -1), 1e-4)
    n_dot_l = jnp.maximum(jnp.sum(n * l, -1), 0.0)
    n_dot_h = jnp.clip(jnp.sum(n * h, -1), 0.0, 1.0)
    v_dot_h = jnp.maximum(jnp.sum(v * h, -1), 1e-4)
    f0 = 0.04 * (1.0 - metallic[..., None]) + albedo * metallic[..., None]
    F = _fresnel_schlick(v_dot_h, f0)
    D = _ggx_d(n_dot_h, alpha)
    G = _smith_g(n_dot_v, n_dot_l, alpha)
    spec = F * (D * G / jnp.maximum(4.0 * n_dot_v * n_dot_l, 1e-8))[..., None]
    diff = albedo * (1.0 - metallic[..., None]) * (1.0 - F) / jnp.pi
    return (diff + spec) * n_dot_l[..., None]


def shade_point_lights(gb, lights: PointLights, tile_lists, camera):
    """Accumulate culled point-light contributions (reference: the per-tile
    loop in default_pbr_ps.hlsl)."""
    h, w = gb.depth.shape
    ty = tile_lists.shape[0]
    # Per-pixel tile coordinates.
    py = jnp.arange(h) // TILE_SIZE
    px = jnp.arange(w) // TILE_SIZE
    pixel_lists = tile_lists[py[:, None], px[None, :]]   # (H, W, K)

    v = m.noz(camera.position - gb.world_pos)
    total = jnp.zeros((h, w, 3))
    for k in range(tile_lists.shape[-1]):
        li = pixel_lists[..., k]
        ok = li >= 0
        li = jnp.maximum(li, 0)
        lpos = lights.position[li]
        lcol = lights.color[li]
        lrad = lights.radius[li]
        to_l = lpos - gb.world_pos
        dist = jnp.linalg.norm(to_l + 1e-9, axis=-1)
        ldir = to_l / dist[..., None]
        # Distance attenuation with radius cutoff (reference falloff).
        att = jnp.clip(1.0 - (dist / lrad) ** 4, 0.0, 1.0) ** 2 / (dist * dist + 1e-2)
        f = eval_brdf_pixel(gb.normal, v, ldir, gb.albedo, gb.roughness,
                            gb.metallic)
        total = total + jnp.where(
            (ok & gb.hit)[..., None], f * lcol * att[..., None], 0.0)
    return total


def shade_spot_lights(gb, lights: SpotLights, camera, shadow_maps=None):
    """Spot lights (uncull'd — counts are small in the reference scenes).

    shadow_maps: optional sequence (len = num lights) of SpotShadowMap or
    None — per-light shadow sampling like the reference's
    spot_shadow_info path (shaders/common/light_source.hlsli)."""
    h, w = gb.depth.shape
    v = m.noz(camera.position - gb.world_pos)
    total = jnp.zeros((h, w, 3))
    n_lights = lights.position.shape[0]
    for i in range(n_lights):
        to_l = lights.position[i] - gb.world_pos
        dist = jnp.linalg.norm(to_l + 1e-9, axis=-1)
        ldir = to_l / dist[..., None]
        cone = jnp.sum(-ldir * lights.direction[i], -1)
        spot = jnp.clip(
            (cone - lights.outer_cos[i])
            / jnp.maximum(lights.inner_cos[i] - lights.outer_cos[i], 1e-4),
            0.0, 1.0,
        )
        att = jnp.clip(1.0 - (dist / lights.distance[i]) ** 4, 0.0, 1.0) ** 2 \
            / (dist * dist + 1e-2)
        f = eval_brdf_pixel(gb.normal, v, ldir, gb.albedo, gb.roughness,
                            gb.metallic)
        contrib = f * lights.color[i] * (att * spot)[..., None]
        if shadow_maps is not None and shadow_maps[i] is not None:
            from .shadows import sample_spot_shadow
            contrib = contrib * sample_spot_shadow(
                shadow_maps[i], gb.world_pos)[..., None]
        total = total + jnp.where(gb.hit[..., None], contrib, 0.0) \
            * lights.valid[i]
    return total


def shade_point_lights_shadowed(gb, lights: PointLights, camera, shadow_maps):
    """Per-light point shading with dual-hemisphere shadow sampling.

    The tiled-culling path (shade_point_lights) stays shadow-free — like the
    reference, shadow-casting point lights are few and shade per light."""
    h, w = gb.depth.shape
    v = m.noz(camera.position - gb.world_pos)
    total = jnp.zeros((h, w, 3))
    for i in range(lights.position.shape[0]):
        to_l = lights.position[i] - gb.world_pos
        dist = jnp.linalg.norm(to_l + 1e-9, axis=-1)
        ldir = to_l / dist[..., None]
        att = jnp.clip(1.0 - (dist / lights.radius[i]) ** 4, 0.0, 1.0) ** 2 \
            / (dist * dist + 1e-2)
        f = eval_brdf_pixel(gb.normal, v, ldir, gb.albedo, gb.roughness,
                            gb.metallic)
        contrib = f * lights.color[i] * att[..., None]
        if shadow_maps is not None and shadow_maps[i] is not None:
            from .shadows import sample_point_shadow
            contrib = contrib * sample_point_shadow(
                shadow_maps[i], gb.world_pos)[..., None]
        total = total + jnp.where(gb.hit[..., None], contrib, 0.0) \
            * lights.valid[i]
    return total
