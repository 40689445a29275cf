"""Cascaded sun shadow maps with a static-geometry cache policy.

Reference: src/rendering/shadow_map.h + shadow_map.cpp (sun CSM up to 4
stabilized cascades into a 6144^2 atlas), shadow_map_cache.h:20 (+.cpp:179:
viewports keyed by light id, re-render only when the light's movement hash
changes, static geometry cached separately).

Design: a shadow map is a depth image from the light's orthographic view,
generated by ray casting the same BVH (no rasterizer hardware); sampling uses
PCF.  The cache policy is host-side: `ShadowCache` hashes the light transform
and skips regeneration when unchanged, exactly the reference behavior.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from ..core import struct

from ..core import maths as m
from . import bvh as bvh_mod

SHADOW_ATLAS_SIZE = 6144  # reference: shadow_map.h:11
DEFAULT_CASCADES = 3


@struct.dataclass
class SunShadowMaps:
    """Per-cascade ortho shadow maps."""

    depth: jnp.ndarray        # (C, R, R) distance along light dir
    origin: jnp.ndarray       # (C, 3) center of each cascade volume
    right: jnp.ndarray        # (C, 3)
    up: jnp.ndarray           # (C, 3)
    direction: jnp.ndarray    # (3,) light direction (travel)
    extent: jnp.ndarray       # (C,) half-size of the ortho volume
    z_range: jnp.ndarray      # (C,) depth range


def fit_cascades(camera_pos, sun_direction, num_cascades=DEFAULT_CASCADES,
                 base_extent=8.0, z_range=60.0):
    """Cascade volumes centered on the camera with doubling extents
    (reference: sun.updateMatrices fits cascades to the view frustum with
    stabilized texel snapping, light_source.cpp)."""
    d = m.noz(jnp.asarray(sun_direction, jnp.float32))
    t1, t2 = m.orthonormal_basis(d)
    extents = base_extent * (2.0 ** jnp.arange(num_cascades, dtype=jnp.float32))
    origins = []
    for c in range(num_cascades):
        ex = float(base_extent * 2 ** c)
        # Texel snapping for stability (reference: cascade stabilization).
        texel = 2.0 * ex / 512.0
        proj_r = jnp.dot(camera_pos, t1)
        proj_u = jnp.dot(camera_pos, t2)
        snapped = (jnp.floor(proj_r / texel) * texel * t1
                   + jnp.floor(proj_u / texel) * texel * t2
                   + jnp.dot(camera_pos, d) * d)
        origins.append(snapped - d * (z_range * 0.5))
    return SunShadowMaps(
        depth=jnp.zeros((num_cascades, 1, 1)),
        origin=jnp.stack(origins),
        right=jnp.tile(t1, (num_cascades, 1)),
        up=jnp.tile(t2, (num_cascades, 1)),
        direction=d,
        extent=extents,
        z_range=jnp.full((num_cascades,), z_range),
    )


def render_sun_shadow_maps(scene_bvh, maps: SunShadowMaps, resolution=512,
                           max_steps=512) -> SunShadowMaps:
    """Ray-cast depth from the light for every cascade.

    All cascades trace as ONE batched closest_hit over c*R*R rays — one
    traversal program instead of c unrolled copies."""
    c = maps.origin.shape[0]
    u = (jnp.arange(resolution) + 0.5) / resolution * 2 - 1
    gu, gv = jnp.meshgrid(u, u)
    span = gu[None, :, :, None] * maps.extent[:, None, None, None]
    spanv = gv[None, :, :, None] * maps.extent[:, None, None, None]
    o = (maps.origin[:, None, None, :]
         + maps.right[:, None, None, :] * span
         + maps.up[:, None, None, :] * spanv).reshape(-1, 3)
    d = jnp.broadcast_to(maps.direction, o.shape)
    res = bvh_mod.closest_hit(scene_bvh, o, d, max_steps=max_steps)
    z = jnp.where(res["hit"], res["t"], jnp.inf)
    return maps.replace(depth=z.reshape(c, resolution, resolution))


def sample_sun_shadow(maps: SunShadowMaps, world_pos, pcf=True, bias=0.05):
    """Shadow factor at world positions (..., 3): 1 lit, 0 shadowed.

    Picks the finest cascade containing the point (reference: cascade
    selection + blending in shadow.hlsli), 3x3 PCF.

    The whole PCF footprint rides ONE row gather: every texel's clamped
    3x3 neighborhood is packed as a (c*r*r, 9) table (nine static edge-
    padded slices), the finest containing cascade is selected with pure
    vector math, and each pixel fetches its nine taps in a single row.
    The per-tap fancy-index form was 27 scalar gathers; this is one
    fetch."""
    c, r, _ = maps.depth.shape
    p = world_pos
    shp = p.shape[:-1]
    flat = p.reshape(-1, 3)

    # Cascade-space coordinates for ALL cascades at once: (C, N).
    rel = flat[None, :, :] - maps.origin[:, None, :]
    u = jnp.sum(rel * maps.right[:, None, :], -1) / maps.extent[:, None]
    v = jnp.sum(rel * maps.up[:, None, :], -1) / maps.extent[:, None]
    z = jnp.sum(rel * maps.direction[None, None, :], -1)
    inside = ((jnp.abs(u) < 1) & (jnp.abs(v) < 1) & (z > 0)
              & (z < maps.z_range[:, None]))
    # Finest containing cascade = FIRST inside in order 0..c-1.
    first = inside & (jnp.cumsum(inside.astype(jnp.int32), 0)
                      == 1)                                   # (C, N)
    any_in = jnp.any(inside, 0)
    sel = first.astype(jnp.float32)
    u_s = jnp.sum(u * sel, 0)
    v_s = jnp.sum(v * sel, 0)
    z_s = jnp.sum(z * sel, 0)
    ci = jnp.sum(jnp.arange(c, dtype=jnp.int32)[:, None] * first, 0)

    ix = jnp.clip((u_s * 0.5 + 0.5) * (r - 1), 0, r - 1).astype(jnp.int32)
    iy = jnp.clip((v_s * 0.5 + 0.5) * (r - 1), 0, r - 1).astype(jnp.int32)
    lin = ci * (r * r) + iy * r + ix

    if pcf:
        padded = jnp.pad(maps.depth, ((0, 0), (1, 1), (1, 1)), mode="edge")
        taps = jnp.stack([padded[:, dy:dy + r, dx:dx + r]
                          for dy in range(3) for dx in range(3)], -1)
        table = taps.reshape(c * r * r, 9)
        table, lin = jax.lax.optimization_barrier((table, lin))
        rows = table[lin]                                     # (N, 9)
        vis = jnp.mean((z_s[:, None] <= rows + bias)
                       .astype(jnp.float32), -1)
    else:
        table, lin = jax.lax.optimization_barrier(
            (maps.depth.reshape(c * r * r, 1), lin))
        vis = (z_s <= table[lin][:, 0] + bias).astype(jnp.float32)

    lit = jnp.where(any_in, vis, 1.0).reshape(shp)
    chosen = jnp.where(any_in, ci, -1).reshape(shp)
    return lit, chosen


# ---------------------------------------------------------------------------
# Spot shadows (reference: shadow_map.cpp spot path, shaders/shadow_map/*)
# ---------------------------------------------------------------------------


@struct.dataclass
class SpotShadowMap:
    """Perspective depth map from a spot light."""

    depth: jnp.ndarray       # (R, R) distance from light along texel ray
    position: jnp.ndarray    # (3,)
    direction: jnp.ndarray   # (3,) unit
    right: jnp.ndarray       # (3,)
    up: jnp.ndarray          # (3,)
    tan_half_fov: jnp.ndarray  # ()
    max_range: jnp.ndarray   # ()


def render_spot_shadow_map(scene_bvh, position, direction, outer_cos,
                           max_range, resolution=256) -> SpotShadowMap:
    """Ray-cast spot depth; FOV covers the outer cone
    (reference: spot shadow matrices, light_source.cpp getSpotLightViewProjectionMatrix)."""
    pos = jnp.asarray(position, jnp.float32)
    d = m.noz(jnp.asarray(direction, jnp.float32))
    t1, t2 = m.orthonormal_basis(d)
    # tan(half fov) from the cone's outer cosine, padded 5% for the PCF rim.
    tan_half = jnp.sqrt(jnp.maximum(1.0 - outer_cos * outer_cos, 1e-6)) \
        / jnp.maximum(outer_cos, 1e-3) * 1.05

    u = (jnp.arange(resolution) + 0.5) / resolution * 2 - 1
    gu, gv = jnp.meshgrid(u, u)
    dirs = m.noz(
        d + (gu * tan_half)[..., None] * t1 + (gv * tan_half)[..., None] * t2
    ).reshape(-1, 3)
    o = jnp.broadcast_to(pos, dirs.shape)
    res = bvh_mod.closest_hit(scene_bvh, o, dirs)
    z = jnp.where(res["hit"], res["t"], jnp.inf)
    return SpotShadowMap(
        depth=z.reshape(resolution, resolution),
        position=pos, direction=d, right=t1, up=t2,
        tan_half_fov=jnp.asarray(tan_half, jnp.float32),
        max_range=jnp.asarray(max_range, jnp.float32),
    )


def sample_spot_shadow(smap: SpotShadowMap, world_pos, pcf=True, bias=0.05):
    """Shadow factor at world positions (..., 3): 1 lit, 0 shadowed."""
    r = smap.depth.shape[0]
    rel = world_pos - smap.position
    z = jnp.sum(rel * smap.direction, -1)
    zs = jnp.maximum(z, 1e-4)
    u = jnp.sum(rel * smap.right, -1) / (zs * smap.tan_half_fov)
    v = jnp.sum(rel * smap.up, -1) / (zs * smap.tan_half_fov)
    inside = (jnp.abs(u) < 1) & (jnp.abs(v) < 1) & (z > 0) & (z < smap.max_range)
    dist = jnp.linalg.norm(rel + 1e-9, axis=-1)
    ix = jnp.clip((u * 0.5 + 0.5) * (r - 1), 0, r - 1).astype(jnp.int32)
    iy = jnp.clip((v * 0.5 + 0.5) * (r - 1), 0, r - 1).astype(jnp.int32)
    if pcf:
        vis = jnp.zeros(world_pos.shape[:-1])
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                sx = jnp.clip(ix + dx, 0, r - 1)
                sy = jnp.clip(iy + dy, 0, r - 1)
                vis = vis + (dist <= smap.depth[sy, sx] + bias)
        vis = vis / 9.0
    else:
        vis = (dist <= smap.depth[iy, ix] + bias).astype(jnp.float32)
    return jnp.where(inside, vis, 1.0)


# ---------------------------------------------------------------------------
# Point shadows: dual-paraboloid hemispheres
# (reference: shadow_map.cpp point path — two hemispheres per light,
#  render_resources.h:11-12)
# ---------------------------------------------------------------------------


@struct.dataclass
class PointShadowMap:
    depth: jnp.ndarray      # (2, R, R) distance maps, +Z / -Z hemispheres
    position: jnp.ndarray   # (3,)
    max_range: jnp.ndarray  # ()


def render_point_shadow_map(scene_bvh, position, max_range,
                            resolution=256) -> PointShadowMap:
    pos = jnp.asarray(position, jnp.float32)
    u = (jnp.arange(resolution) + 0.5) / resolution * 2 - 1
    gu, gv = jnp.meshgrid(u, u)
    r2 = gu * gu + gv * gv
    denom = 1.0 + r2
    maps = []
    for sign in (1.0, -1.0):
        # Paraboloid direction: z = (1 - u^2 - v^2) / (1 + u^2 + v^2).
        dirs = jnp.stack(
            [2 * gu / denom, 2 * gv / denom, sign * (1 - r2) / denom], -1
        ).reshape(-1, 3)
        o = jnp.broadcast_to(pos, dirs.shape)
        res = bvh_mod.closest_hit(scene_bvh, o, dirs)
        z = jnp.where(res["hit"], res["t"], jnp.inf)
        z = jnp.where(r2.reshape(-1) <= 1.0, z, jnp.inf)
        maps.append(z.reshape(resolution, resolution))
    return PointShadowMap(
        depth=jnp.stack(maps), position=pos,
        max_range=jnp.asarray(max_range, jnp.float32),
    )


def sample_point_shadow(pmap: PointShadowMap, world_pos, pcf=True, bias=0.08):
    r = pmap.depth.shape[-1]
    rel = world_pos - pmap.position
    dist = jnp.linalg.norm(rel + 1e-9, axis=-1)
    d = rel / dist[..., None]
    hemi = (d[..., 2] < 0).astype(jnp.int32)       # 0: +Z map, 1: -Z map
    denom = 1.0 + jnp.abs(d[..., 2])
    u = d[..., 0] / denom
    v = d[..., 1] / denom
    ix = jnp.clip((u * 0.5 + 0.5) * (r - 1), 0, r - 1).astype(jnp.int32)
    iy = jnp.clip((v * 0.5 + 0.5) * (r - 1), 0, r - 1).astype(jnp.int32)
    if pcf:
        vis = jnp.zeros(world_pos.shape[:-1])
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                sx = jnp.clip(ix + dx, 0, r - 1)
                sy = jnp.clip(iy + dy, 0, r - 1)
                vis = vis + (dist <= pmap.depth[hemi, sy, sx] + bias)
        vis = vis / 9.0
    else:
        vis = (dist <= pmap.depth[hemi, iy, ix] + bias).astype(jnp.float32)
    return jnp.where(dist < pmap.max_range, vis, 1.0)


class ShadowCache:
    """Host-side re-render policy (reference: shadow_map_cache.cpp:179 —
    viewport assignment keyed by light id, invalidated by a movement hash)."""

    def __init__(self):
        self._hashes = {}
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _hash(*arrays) -> int:
        h = 0
        for a in arrays:
            h ^= hash(np.asarray(a, np.float32).tobytes())
        return h

    def needs_render(self, light_id, *state_arrays) -> bool:
        h = self._hash(*state_arrays)
        if self._hashes.get(light_id) == h:
            self.hits += 1
            return False
        self._hashes[light_id] = h
        self.misses += 1
        return True

    def invalidate(self, light_id=None):
        if light_id is None:
            self._hashes.clear()
        else:
            self._hashes.pop(light_id, None)


# ---------------------------------------------------------------------------
# Shadow atlas: packed viewports + static cache
# (reference: 6144^2 atlas, render_resources.h:11-12; viewport allocation +
#  copy-from-static-cache, shadow_map_cache.cpp)
# ---------------------------------------------------------------------------


class ShadowAtlas:
    """One big depth atlas with shelf-packed per-light viewports and a
    movement-hash static cache.

    Host-side orchestration (viewport assignment, staleness) wraps device
    renders — only stale viewports are re-ray-cast; cached ones keep their
    atlas region, which is the reference's copyShadowMapParts behavior."""

    def __init__(self, size=SHADOW_ATLAS_SIZE):
        self.size = size
        self._shelf_x = 0
        self._shelf_y = 0
        self._shelf_h = 0
        self.viewports = {}   # light_id -> (y, x, h, w)
        self.cache = ShadowCache()
        self.atlas = jnp.full((size, size), jnp.inf, jnp.float32)
        self._maps = {}       # light_id -> shadow-map struct (atlas slices)

    def allocate(self, light_id, h, w):
        if light_id in self.viewports:
            vp = self.viewports[light_id]
            assert vp[2:] == (h, w), "viewport size changed for " + str(light_id)
            return vp
        if self._shelf_x + w > self.size:     # new shelf
            self._shelf_y += self._shelf_h
            self._shelf_x = 0
            self._shelf_h = 0
        if self._shelf_y + h > self.size:
            raise RuntimeError("shadow atlas full")
        vp = (self._shelf_y, self._shelf_x, h, w)
        self._shelf_x += w
        self._shelf_h = max(self._shelf_h, h)
        self.viewports[light_id] = vp
        return vp

    def _update(self, light_id, h, w, state, render_tile):
        """Allocate + conditionally render one (h, w) tile into the atlas."""
        y, x, _, _ = self.allocate(light_id, h, w)
        if self.cache.needs_render(light_id, *state):
            tile = render_tile()
            self.atlas = self.atlas.at[y:y + h, x:x + w].set(tile)
        return y, x

    def update_sun(self, scene_bvh, camera_pos, sun_direction,
                   resolution=512, scene_version=0,
                   num_cascades=DEFAULT_CASCADES) -> SunShadowMaps:
        maps = fit_cascades(camera_pos, sun_direction,
                            num_cascades=num_cascades)
        depths = []
        for ci in range(num_cascades):
            one = SunShadowMaps(
                depth=maps.depth[ci:ci + 1], origin=maps.origin[ci:ci + 1],
                right=maps.right[ci:ci + 1], up=maps.up[ci:ci + 1],
                direction=maps.direction, extent=maps.extent[ci:ci + 1],
                z_range=maps.z_range[ci:ci + 1],
            )
            state = (maps.origin[ci], maps.direction, maps.extent[ci],
                     np.int64(scene_version))
            y, x = self._update(
                ("sun", ci), resolution, resolution, state,
                lambda one=one: render_sun_shadow_maps(
                    scene_bvh, one, resolution=resolution).depth[0],
            )
            depths.append(self.atlas[y:y + resolution, x:x + resolution])
        maps = maps.replace(depth=jnp.stack(depths))
        self._maps[("sun",)] = maps
        return maps

    def update_spot(self, scene_bvh, light_id, position, direction, outer_cos,
                    max_range, resolution=256, scene_version=0) -> SpotShadowMap:
        state = (np.asarray(position, np.float32),
                 np.asarray(direction, np.float32),
                 np.float32(outer_cos), np.float32(max_range),
                 np.int64(scene_version))
        y, x = self._update(
            ("spot", light_id), resolution, resolution, state,
            lambda: render_spot_shadow_map(
                scene_bvh, position, direction, outer_cos, max_range,
                resolution=resolution).depth,
        )
        pos = jnp.asarray(position, jnp.float32)
        d = m.noz(jnp.asarray(direction, jnp.float32))
        t1, t2 = m.orthonormal_basis(d)
        tan_half = jnp.sqrt(jnp.maximum(1.0 - outer_cos * outer_cos, 1e-6)) \
            / jnp.maximum(jnp.asarray(outer_cos, jnp.float32), 1e-3) * 1.05
        smap = SpotShadowMap(
            depth=self.atlas[y:y + resolution, x:x + resolution],
            position=pos, direction=d, right=t1, up=t2,
            tan_half_fov=tan_half,
            max_range=jnp.asarray(max_range, jnp.float32),
        )
        self._maps[("spot", light_id)] = smap
        return smap

    def update_point(self, scene_bvh, light_id, position, max_range,
                     resolution=256, scene_version=0) -> PointShadowMap:
        """Dual-hemisphere maps packed side by side in one (R, 2R) viewport."""
        state = (np.asarray(position, np.float32), np.float32(max_range),
                 np.int64(scene_version))
        y, x = self._update(
            ("point", light_id), resolution, 2 * resolution, state,
            lambda: jnp.concatenate(
                list(render_point_shadow_map(
                    scene_bvh, position, max_range,
                    resolution=resolution).depth), axis=1),
        )
        tile = self.atlas[y:y + resolution, x:x + 2 * resolution]
        pmap = PointShadowMap(
            depth=jnp.stack([tile[:, :resolution], tile[:, resolution:]]),
            position=jnp.asarray(position, jnp.float32),
            max_range=jnp.asarray(max_range, jnp.float32),
        )
        self._maps[("point", light_id)] = pmap
        return pmap
