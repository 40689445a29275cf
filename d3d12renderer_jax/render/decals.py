"""Decals: projected material patches applied to the G-buffer.

Reference: decal culling shares the 16x16 tile pass with lights
(shaders/light_culling/light_culling_cs.hlsl; 256-decal buffers
application.cpp:391).  A decal is an oriented box; pixels whose world
position falls inside get their albedo/roughness blended before shading.

Form: a dense masked loop over the decal table inside the deferred pass —
for the reference's decal counts (<=256) this is a handful of fused
elementwise ops per decal; per-tile culling can prefilter exactly like the
lights when counts grow.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
from ..core import struct

from ..core import maths as m

MAX_DECALS = 256  # reference: application.cpp:391


@struct.dataclass
class Decals:
    position: jnp.ndarray     # (D, 3) box center
    rotation: jnp.ndarray     # (D, 4) box orientation
    half_extents: jnp.ndarray # (D, 3) x/y across the face, z = projection depth
    albedo: jnp.ndarray       # (D, 3)
    roughness: jnp.ndarray    # (D,)
    metallic: jnp.ndarray     # (D,)
    strength: jnp.ndarray     # (D,) blend weight
    valid: jnp.ndarray        # (D,)


def make_decals(positions, rotations, half_extents, albedos,
                roughness=None, metallic=None, strength=None) -> Decals:
    import numpy as np

    d = len(positions)
    return Decals(
        position=jnp.asarray(np.asarray(positions, np.float32)),
        rotation=jnp.asarray(np.asarray(rotations, np.float32)),
        half_extents=jnp.asarray(np.asarray(half_extents, np.float32)),
        albedo=jnp.asarray(np.asarray(albedos, np.float32)),
        roughness=jnp.asarray(np.asarray(
            roughness if roughness is not None else [0.5] * d, np.float32)),
        metallic=jnp.asarray(np.asarray(
            metallic if metallic is not None else [0.0] * d, np.float32)),
        strength=jnp.asarray(np.asarray(
            strength if strength is not None else [1.0] * d, np.float32)),
        valid=jnp.ones(d, bool),
    )


def apply_decals(gb, decals: Decals):
    """Blend decals into G-buffer albedo/roughness/metallic (returns new gb).

    Pixels inside a decal's oriented box receive its material, faded toward
    the projection-depth edges (reference decal projection behavior)."""
    albedo = gb.albedo
    rough = gb.roughness
    metal = gb.metallic
    n_d = decals.position.shape[0]
    for i in range(n_d):
        local = m.quat_inv_rotate(decals.rotation[i],
                                  gb.world_pos - decals.position[i])
        he = decals.half_extents[i]
        inside = (
            (jnp.abs(local[..., 0]) <= he[0])
            & (jnp.abs(local[..., 1]) <= he[1])
            & (jnp.abs(local[..., 2]) <= he[2])
            & gb.hit & decals.valid[i]
        )
        fade = jnp.clip(1.0 - jnp.abs(local[..., 2]) / he[2], 0.0, 1.0)
        w = jnp.where(inside, decals.strength[i] * fade, 0.0)
        albedo = albedo * (1 - w[..., None]) + decals.albedo[i] * w[..., None]
        rough = rough * (1 - w) + decals.roughness[i] * w
        metal = metal * (1 - w) + decals.metallic[i] * w
    return gb.replace(albedo=albedo, roughness=rough, metallic=metal)


def cull_decals_tiled(gb_view_pos, decals: Decals, camera, width, height):
    """Per-tile decal lists sharing the light-culling machinery
    (reference: the same 16x16 pass packs light AND decal indices)."""
    from .lights import PointLights, cull_lights_tiled

    radius = jnp.linalg.norm(decals.half_extents, axis=-1)
    as_lights = PointLights(position=decals.position,
                            color=decals.albedo,
                            radius=radius, valid=decals.valid)
    return cull_lights_tiled(gb_view_pos, as_lights, camera, width, height)
