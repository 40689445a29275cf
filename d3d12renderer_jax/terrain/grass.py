"""Grass: per-chunk blade generation with LOD and wind animation.

Reference: src/terrain/grass.h:21-39 + shaders/grass/grass_generation_cs.hlsl
(compute generation per chunk with LOD + culling, indirect draws, wind sway in
the vertex shader).  Here: blade instance data is one fixed-shape
array; LOD = per-blade vertex-count class from camera distance; wind = a
time-varying bend evaluated when building blade geometry.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from .placement import generate_placement_points

LOD0_SEGMENTS = 4   # reference: high-LOD blades have more segments
LOD1_SEGMENTS = 2


def generate_grass_blades(heights, origin, cell_size, world_size, key,
                          blades_per_side=128, density=0.9):
    """Blade instances on terrain: dict with position/facing/height/valid."""
    pts = generate_placement_points(
        heights, origin, cell_size, world_size, key,
        points_per_side=blades_per_side, max_slope_y=0.8, density=density,
    )
    k = jax.random.fold_in(key, 17)
    n = pts["position"].shape[0]
    return {
        "position": pts["position"],
        "facing": pts["rotation"],
        "height": 0.35 + 0.3 * jax.random.uniform(k, (n,)),
        "valid": pts["valid"],
        "count": pts["count"],
    }


def blade_lod(blade_positions, camera_position, lod_distance=20.0):
    """0 = near/high detail, 1 = far (reference: grass LOD split by distance)."""
    d = jnp.linalg.norm(blade_positions - camera_position, axis=-1)
    return (d > lod_distance).astype(jnp.int32)


def wind_offset(positions, time, strength=0.3, frequency=1.3):
    """Wind sway displacement at blade tips (reference:
    shaders/grass/grass.hlsli wind term: phase from world position)."""
    phase = positions[..., 0] * 0.5 + positions[..., 2] * 0.7
    sway = jnp.sin(time * frequency + phase) + 0.35 * jnp.sin(
        time * 2.7 * frequency + phase * 1.7
    )
    off = jnp.stack([sway * strength, jnp.zeros_like(sway),
                     0.4 * sway * strength], -1)
    return off


def chunk_grass(blades, origin, world_size, chunk_size=8.0):
    """Assign blades to a fixed square chunk grid; per-chunk bounding spheres.

    Returns (chunk_id (N,), centers (G*G,3), radii (G*G,), nonempty (G*G,)).
    The batched equivalent of the reference's per-chunk grass generation+culling
    (src/terrain/grass.h:21-39: one dispatch per visible chunk): chunks are
    a STATIC grid; visibility is a mask, not a dispatch decision."""
    import numpy as np

    pos = blades["position"]
    valid = blades["valid"]
    g = max(1, int(np.ceil(float(world_size) / chunk_size)))
    cx = jnp.clip(((pos[:, 0] - origin[0]) / chunk_size).astype(jnp.int32),
                  0, g - 1)
    cz = jnp.clip(((pos[:, 2] - origin[2]) / chunk_size).astype(jnp.int32),
                  0, g - 1)
    cid = cx * g + cz

    big = jnp.where(valid[:, None], pos, jnp.inf)
    small = jnp.where(valid[:, None], pos, -jnp.inf)
    lo = jnp.full((g * g, 3), jnp.inf).at[cid].min(big)
    hi = jnp.full((g * g, 3), -jnp.inf).at[cid].max(small)
    nonempty = jnp.isfinite(lo[:, 0])
    lo_s = jnp.where(nonempty[:, None], lo, 0.0)
    hi_s = jnp.where(nonempty[:, None], hi, 0.0)
    centers = 0.5 * (lo_s + hi_s)
    # Sphere covers the chunk AABB plus the tallest possible blade sway.
    h_max = jnp.max(jnp.where(valid, blades["height"], 0.0))
    radii = 0.5 * jnp.linalg.norm(hi_s - lo_s, axis=-1) + h_max + 0.5
    return cid, centers, radii, nonempty


def grass_lod_triangles(blades, camera, origin, world_size, time=0.0,
                        lod_distance=20.0, chunk_size=8.0, width=0.03):
    """Frame-ready grass: per-chunk frustum culling + two-LOD triangle soup.

    Reference: grass chunks are frustum-culled and generated at one of two
    LODs by distance, then drawn indirect (src/terrain/grass.h:21-39 +
    shaders/grass/grass_generation_cs.hlsl).  Here both LOD strips are built
    at fixed shape and blades that are culled (off-frustum chunk) or in the
    other LOD class collapse to zero-area triangles at the blade root —
    invisible to both the ray tracer and the raster pipeline, no dynamic
    shapes.  Returns (verts (V,3), tris (T,3), stats dict)."""
    from ..scene.scene_rendering import cull_spheres, frustum_planes

    cid, centers, radii, nonempty = chunk_grass(
        blades, origin, world_size, chunk_size)
    planes = frustum_planes(camera)
    vis_chunk = cull_spheres(planes, centers, radii) & nonempty
    bvis = blades["valid"] & vis_chunk[cid]
    lod = blade_lod(blades["position"], camera.position, lod_distance)

    parts = []
    tri_parts = []
    voffset = 0
    for lod_class, segments in ((0, LOD0_SEGMENTS), (1, LOD1_SEGMENTS)):
        keep = bvis & (lod == lod_class)
        masked = dict(blades)
        # Collapse non-members: zero height and width -> all verts == root.
        masked["height"] = jnp.where(keep, blades["height"], 0.0)
        v, t = blade_triangles(masked, time=time, segments=segments,
                               width=width)
        n_blades = blades["position"].shape[0]
        per = v.shape[0] // n_blades
        keep_v = jnp.repeat(keep, per)
        v = jnp.where(keep_v[:, None], v,
                      jnp.repeat(blades["position"], per, axis=0))
        parts.append(v)
        tri_parts.append(t + voffset)
        voffset += v.shape[0]
    stats = {
        "visible_blades": jnp.sum(bvis),
        "visible_chunks": jnp.sum(vis_chunk),
        "lod0_blades": jnp.sum(bvis & (lod == 0)),
        "lod1_blades": jnp.sum(bvis & (lod == 1)),
    }
    return (jnp.concatenate(parts), jnp.concatenate(tri_parts), stats)


def blade_triangles(blades, time=0.0, segments=LOD0_SEGMENTS, width=0.03):
    """Expand blade instances into triangle soup (V, 3)/(T, 3) for rendering.

    Each blade is a tapered strip of `segments` quads bent by the wind."""
    pos = blades["position"]
    facing = blades["facing"]
    height = blades["height"]
    n = pos.shape[0]

    t = jnp.linspace(0.0, 1.0, segments + 1)               # (S+1,)
    # Blade center-line: vertical with quadratic wind bend toward the tip.
    wind = wind_offset(pos, time)                           # (N,3)
    centers = (
        pos[:, None, :]
        + jnp.stack([jnp.zeros_like(t), t, jnp.zeros_like(t)], -1)[None]
        * height[:, None, None]
        + wind[:, None, :] * (t ** 2)[None, :, None]
    )                                                       # (N,S+1,3)
    side = jnp.stack([jnp.cos(facing), jnp.zeros_like(facing),
                      jnp.sin(facing)], -1)                 # (N,3)
    half_w = width * (1.0 - t)[None, :, None]               # taper
    left = centers - side[:, None, :] * half_w
    right = centers + side[:, None, :] * half_w
    verts = jnp.stack([left, right], 2).reshape(n, -1, 3)   # (N,2*(S+1),3)

    # Triangle indices for one blade strip.
    idx = []
    for s in range(segments):
        a = 2 * s
        idx += [[a, a + 2, a + 1], [a + 1, a + 2, a + 3]]
    idx = jnp.asarray(idx, jnp.int32)                       # (2S,3)
    per = verts.shape[1]
    tri = idx[None, :, :] + (jnp.arange(n) * per)[:, None, None]
    return verts.reshape(-1, 3), tri.reshape(-1, 3)
